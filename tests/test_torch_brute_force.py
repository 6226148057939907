"""raft_tpu_torch.neighbors.brute_force against raft_tpu.neighbors.brute_force.

A raft_tpu ``BruteForce`` index is built from seeded numpy data, its state
(dataset, metric, metric_arg) is carried into the port with ``from_state``,
and both answer the same queries on the CPU. The JAX side takes its fused
Pallas kernel in interpret mode (RAFT_TPU_FUSED_KNN_INTERPRET=1, as its own
tests do); the port takes the same dispatch, whose fused route runs the
kernel's plain version on CPU tensors. Float searches are held to the JAX
tests' ``assert_knn_equiv`` rule at rtol=1e-5; integer searches are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors.sample_filter import BitsetFilter
from raft_tpu_torch.ops.fused_knn import fused_knn
from test_fused_knn import assert_knn_equiv

N, D, M = 4100, 64, 24          # n >= 4096 and d >= 64: the fused route
CPU = Resources(device="cpu")


@pytest.fixture(autouse=True)
def _jax_kernel_route(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FUSED_KNN_INTERPRET", "1")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    return (rng.random((N, D), np.float32), rng.random((M, D), np.float32),
            rng.integers(0, 256, (N, D), dtype=np.uint8),
            rng.integers(0, 256, (M, D), dtype=np.uint8))


def _search_both(x, q, k, metric="sqeuclidean", **kw):
    index = jbf.BruteForce(metric=metric).build(x)
    jd, ji = jbf.knn(index.dataset, jnp.asarray(q), k, index.metric,
                     index.metric_arg, **kw)
    port = tbf.from_state(np.asarray(index.dataset), index.metric,
                          index.metric_arg, res=CPU)
    if not kw:
        td, ti = port.search(q, k)
    else:
        td, ti = tbf.knn(port.dataset, q, k, port.metric, port.metric_arg,
                         res=CPU, **kw)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    return (td.numpy(), ti.numpy()), (np.asarray(jd), np.asarray(ji))


@pytest.mark.parametrize("metric,k", [("sqeuclidean", 10), ("euclidean", 10),
                                      ("inner_product", 10), ("cosine", 10),
                                      ("sqeuclidean", 70), ("inner_product", 65)])
def test_float_metrics_match_jax(data, metric, k):
    x, q, _, _ = data
    launched = fused_knn.launches
    (td, ti), (jd, ji) = _search_both(x, q, k, metric)
    assert fused_knn.launches == launched      # CPU tensors: the plain route
    assert_knn_equiv(td, ti, jd, ji, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_byte_datasets_exact(data, dtype, metric):
    _, _, xu, qu = data
    shift = (lambda a: (a.astype(np.int16) - 128).astype(np.int8)) if dtype == np.int8 else (lambda a: a)
    (td, ti), (jd, ji) = _search_both(shift(xu), shift(qu), 10, metric)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_filter_and_underfill_match_jax(data, check_filter_underfill):
    x, q, _, _ = data
    keep = np.zeros(N, bool)
    keep[[7, 4000, 4099, 12]] = True
    (td, ti), (jd, ji) = _search_both(x, q, 10, sample_filter=keep)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    check_filter_underfill(td, ti, [7, 12, 4000, 4099])
    td2, ti2 = tbf.knn(x, q, 10, sample_filter=BitsetFilter(keep), res=CPU)
    assert np.array_equal(ti2.numpy(), ti)


@pytest.mark.parametrize("kw", [dict(mode="approx"), dict(compute="float32x3"),
                                dict(compute="bfloat16")],
                         ids=["approx", "f32x3", "bf16"])
def test_modes_match_jax(data, kw):
    x, q, _, _ = data
    (td, ti), (jd, ji) = _search_both(x, q, 10, **kw)
    assert_knn_equiv(td, ti, jd, ji, rtol=1e-5)


def test_small_shape_gemm_route_matches_jax(data):
    """Below the fused gate (n < 4096) both run GEMM + top-k."""
    x, q, xu, qu = data
    for xs, qs in ((x[:1000], q), (xu[:1000], qu)):
        jd, ji = jbf.knn(jnp.asarray(xs), jnp.asarray(qs), 12)
        td, ti = tbf.knn(xs, qs, 12, res=CPU)
        assert_knn_equiv(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                         rtol=1e-5)


def test_contract_errors(data):
    x, q, xu, _ = data
    with pytest.raises(RaftError, match="share a dtype"):
        tbf.knn(xu, (xu[:3].astype(np.int16) - 128).astype(np.int8), 5, res=CPU)
    with pytest.raises(RaftError, match="k="):
        tbf.knn(x[:10], q, 11, res=CPU)
    with pytest.raises(RaftError, match="no search params"):
        tbf.batched_searcher(tbf.BruteForce().build(x[:100], res=CPU), params=object())
    with pytest.raises(RaftError, match="not built"):
        tbf.BruteForce().search(q, 5)


def test_entry_points_default_to_cuda(data):
    x, q, _, _ = data
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RaftError, match="CUDA"):
        tbf.BruteForce().build(x)
    with pytest.raises(RaftError, match="CUDA"):
        tbf.knn(x, q, 5)


@pytest.mark.parametrize("kind", ["float32", "uint8", "bfloat16"])
def test_files_byte_identical_both_ways(data, tmp_path, kind):
    """A JAX-saved brute-force file loads into the port and searches to JAX's
    answers; the port writes it back byte for byte, and JAX reads the port's
    file to an equal index (metric, argument, dataset, tuned record)."""
    x, q, xu, qu = data
    ds = {"float32": x[:1000], "uint8": xu[:1000],
          "bfloat16": np.asarray(jnp.asarray(x[:1000], jnp.bfloat16))}[kind]
    qq = qu if kind == "uint8" else q
    jidx = jbf.BruteForce(metric="canberra" if kind == "float32" else "sqeuclidean",
                          metric_arg=3.0).build(ds)
    jidx.tuned = {"n_probes": 4} if kind == "float32" else None
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jbf.save(jidx, jpath)
    tidx = tbf.load(jpath, res=CPU)
    assert tidx.tuned == jidx.tuned and float(tidx.metric_arg) == 3.0
    assert tbf._dtype_name(tidx.dataset) == str(jidx.dataset.dtype)
    tbf.save(tidx, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    back = jbf.load(tpath)
    assert back.metric == jbf.resolve_metric(jidx.metric) and back.tuned == jidx.tuned
    np.testing.assert_array_equal(np.asarray(back.dataset, np.float32),
                                  np.asarray(jidx.dataset, np.float32))
    jd, ji = jidx.search(jnp.asarray(qq), 7)
    td, ti = tidx.search(qq, 7)
    assert_knn_equiv(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji), rtol=1e-5)


@pytest.mark.parametrize("kind", ["float32", "int8", "uint8"])
def test_batched_searcher_matches_jax(data, kind):
    x, q, xu, qu = data
    shift = (lambda a: (a.astype(np.int16) - 128).astype(np.int8))
    ds, qq = {"float32": (x[:500], q), "int8": (shift(xu[:500]), shift(qu)),
              "uint8": (xu[:500], qu)}[kind]
    jfn = jbf.batched_searcher(jbf.BruteForce().build(ds))
    tfn = tbf.batched_searcher(tbf.BruteForce().build(ds, res=CPU))
    assert (tfn.kind, tfn.dim, tfn.query_dtype) == (jfn.kind, jfn.dim, jfn.query_dtype)
    jd, ji = jfn(jnp.asarray(qq), 5)
    td, ti = tfn(qq, 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
