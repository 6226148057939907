"""raft_tpu_torch.neighbors.ivf_flat against raft_tpu.neighbors.ivf_flat.

The two packages train their coarse centers from different random streams,
so the parity seam is the index file: an index the JAX package builds and
saves loads into the port and answers the same searches; an index the port
saves loads into JAX byte for byte; ``from_state`` carries a JAX index's
arrays. The port's own builds are held to the JAX builds' recall.

Searches compare with ``assert_knn_equiv`` at rtol 1e-5 / atol 1e-5 (float32
and bfloat16 lists: the products are summed in different orders, so ids may
differ only where two distances tie within that tolerance); int8 and uint8
lists are exact (integer scores).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core.chunked import ChunkedReader
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu_torch.core import RaftError, Resources, chunked
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors.sample_filter import BitsetFilter
from test_fused_knn import assert_knn_equiv

CPU = Resources(device="cpu")
N, D, M, LISTS = 3000, 16, 130, 20
BUILDS = {
    "l2": dict(metric="sqeuclidean"),
    "ip": dict(metric="inner_product"),
    "bf16": dict(list_dtype="bfloat16"),
    "int8": dict(),
    "uint8": dict(),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(61)
    centers = rng.uniform(-5, 5, (40, D))
    x = (centers[rng.integers(0, 40, N)] + rng.normal(0, 1, (N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 40, M)] + rng.normal(0, 1, (M, D))).astype(np.float32)
    xb = np.clip(np.round(x * 12), -128, 127).astype(np.int8)
    qb = np.clip(np.round(q * 12), -128, 127).astype(np.int8)
    return {"float": (x, q), "int8": (xb, qb),
            "uint8": ((xb.astype(np.int16) + 128).astype(np.uint8),
                      (qb.astype(np.int16) + 128).astype(np.uint8))}


def _inputs(data, name):
    return data[name if name in ("int8", "uint8") else "float"]


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """name -> (JAX index, path of its raft_tpu/13 file)."""
    out = {}
    tmp = tmp_path_factory.mktemp("ivf_flat")
    for name, kw in BUILDS.items():
        x, _ = _inputs(data, name)
        index = jfl.build(jfl.IndexParams(n_lists=LISTS, seed=0, **kw), jnp.asarray(x))
        path = str(tmp / f"{name}.bin")
        jfl.save(index, path)
        out[name] = (index, path)
    return out


def _compare(td, ti, jd, ji, exact):
    td, ti, jd, ji = td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji)
    if exact:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    else:
        assert_knn_equiv(td, ti, jd, ji, rtol=1e-5, atol=1e-5)


def test_params_mirror_jax():
    for t, j in ((tfl.IndexParams, jfl.IndexParams), (tfl.SearchParams, jfl.SearchParams)):
        assert ({f: getattr(t(), f) for f in t.__dataclass_fields__}
                == {f: getattr(j(), f) for f in j.__dataclass_fields__})


@pytest.mark.parametrize("name,n_probes,k", [
    ("l2", 3, 10), ("l2", 20, 100), ("l2", 5, 1), ("l2sqrt", 5, 10), ("ip", 4, 10),
    ("ip", 20, 100), ("bf16", 5, 10), ("int8", 5, 10), ("uint8", 5, 10)])
def test_jax_index_searches_to_jax_answers(data, jax_files, name, n_probes, k):
    jindex, path = jax_files["l2" if name == "l2sqrt" else name]
    tindex = tfl.load(path, res=CPU)
    if name == "l2sqrt":
        jindex = dataclasses.replace(jindex, metric=jfl.DistanceType.L2SqrtExpanded)
        tindex = dataclasses.replace(tindex, metric=DistanceType.L2SqrtExpanded)
    _, q = _inputs(data, name)
    assert tindex.data_kind == jindex.data_kind and tindex.capacity == jindex.capacity
    jd, ji = jfl.search(jfl.SearchParams(n_probes=n_probes), jindex, jnp.asarray(q), k)
    td, ti = tfl.search(tfl.SearchParams(n_probes=n_probes), tindex, q, k, res=CPU)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32 and ti.shape == (M, k)
    _compare(td, ti, jd, ji, exact=name in ("int8", "uint8"))


def test_tiles_and_chunks_answer_as_one(data, jax_files):
    """A budget that forces 32-query tiles (the last one short) and one-probe
    chunks, merged in order, answers as JAX does under the same budget."""
    jindex, path = jax_files["l2"]
    tindex = tfl.load(path, res=CPU)
    x, q = data["float"]
    bpr = 2 * tindex.capacity * (D * 4 + 8)
    res = Resources(device="cpu", workspace_bytes=32 * bpr)
    assert tfl.search_plan(tindex, M, 4, 10, res) == (32, 1)
    jd, ji = jfl.search(jfl.SearchParams(n_probes=4), jindex, jnp.asarray(q), 10,
                        res=JResources(workspace_bytes=32 * bpr))
    td, ti = tfl.search(tfl.SearchParams(n_probes=4), tindex, q, 10, res=res)
    _compare(td, ti, jd, ji, exact=False)
    od, oi = tfl.search(tfl.SearchParams(n_probes=4), tindex, q, 10, res=CPU)
    assert torch.equal(oi, ti) and torch.equal(od, td)


@pytest.mark.parametrize("name", ["l2", "ip"])
def test_filters_match_jax_and_underfill(data, jax_files, name, check_filter_underfill):
    jindex, path = jax_files[name]
    tindex = tfl.load(path, res=CPU)
    _, q = data["float"]
    keep = np.random.default_rng(3).random(N) < 0.5
    alive = [7, 100, 2048, 2999]
    few = np.zeros(N, bool)
    few[alive] = True
    # every list probed (split lists make more than LISTS of them)
    for mask, n_probes in ((keep, 5), (few, tindex.n_lists)):
        jd, ji = jfl.search(jfl.SearchParams(n_probes=n_probes), jindex, jnp.asarray(q), 10,
                            sample_filter=mask)
        td, ti = tfl.search(tfl.SearchParams(n_probes=n_probes), tindex, q, 10,
                            sample_filter=BitsetFilter(mask), res=CPU)
        _compare(td, ti, jd, ji, exact=False)
        assert mask[ti.numpy()[ti.numpy() >= 0]].all()
    check_filter_underfill(td.numpy(), ti.numpy(), alive, select_min=name == "l2")
    with pytest.raises(RaftError, match="must cover"):
        tfl.search(tfl.SearchParams(), tindex, q, 10, sample_filter=few[:100], res=CPU)


@pytest.mark.parametrize("name", ["l2", "uint8"])
def test_extend_with_and_without_ids_matches_jax(data, jax_files, name):
    jindex, path = jax_files[name]
    x, _ = _inputs(data, name)
    new = x[:700] if name == "uint8" else x[:700] + 0.05
    ids = np.arange(10_000, 10_700, dtype=np.int32)
    for new_ids in (None, ids):
        j2 = jfl.extend(jindex, jnp.asarray(new), None if new_ids is None else jnp.asarray(new_ids))
        t2 = tfl.extend(tfl.load(path, res=CPU), new, new_ids, res=CPU)
        assert (t2.n_lists, t2.capacity, t2.data_kind) == (j2.n_lists, j2.capacity, j2.data_kind)
        np.testing.assert_array_equal(t2.list_ids.numpy(), np.asarray(j2.list_ids))
        np.testing.assert_array_equal(t2.list_sizes.numpy(), np.asarray(j2.list_sizes))
        np.testing.assert_array_equal(t2.list_data.numpy(), np.asarray(j2.list_data))
        # norms: float32 sums in another order (exact for byte lists)
        np.testing.assert_allclose(t2.list_norms.numpy(), np.asarray(j2.list_norms),
                                   rtol=1e-6)
        np.testing.assert_array_equal(t2.centers.numpy(), np.asarray(j2.centers))


@pytest.mark.parametrize("name", ["l2", "bf16", "uint8"])
def test_files_byte_identical_both_ways(data, jax_files, tmp_path, name):
    jindex, path = jax_files[name]
    jindex.tuned = {"n_probes": 7} if name == "l2" else None
    jfl.save(jindex, path)
    tindex = tfl.load(path, res=CPU)
    assert tindex.tuned == jindex.tuned
    tpath = str(tmp_path / "port.bin")
    tfl.save(tindex, tpath)
    with open(path, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    # the port's own build, read by JAX and written back
    x, q = _inputs(data, name)
    kw = dict(BUILDS[name])
    own = tfl.build(tfl.IndexParams(n_lists=LISTS, **kw), x[:1200], res=CPU)
    tfl.save(own, tpath)
    back = jfl.load(tpath)
    jpath = str(tmp_path / "jax.bin")
    jfl.save(back, jpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    jd, ji = jfl.search(jfl.SearchParams(n_probes=5), back, jnp.asarray(q), 10)
    td, ti = tfl.search(tfl.SearchParams(n_probes=5), own, q, 10, res=CPU)
    _compare(td, ti, jd, ji, exact=name == "uint8")


def test_from_state_answers_as_jax(data, jax_files):
    _, q = data["float"]
    for name in ("l2", "bf16"):
        jindex, _ = jax_files[name]
        arrays = {a: np.asarray(getattr(jindex, a)) for a in tfl._STATE_ARRAYS}
        tindex = tfl.from_state(arrays, res=CPU, metric=int(jindex.metric),
                                split_factor=jindex.split_factor, data_kind=jindex.data_kind)
        assert tindex.list_data.dtype == (torch.bfloat16 if name == "bf16" else torch.float32)
        jd, ji = jfl.search(jfl.SearchParams(n_probes=5), jindex, jnp.asarray(q), 10)
        td, ti = tfl.search(tfl.SearchParams(n_probes=5), tindex, q, 10, res=CPU)
        _compare(td, ti, jd, ji, exact=False)


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("name", ["l2", "ip", "int8"])
def test_port_build_recall_within_001_of_jax(data, jax_files, name):
    """At 5 of ~20 lists probed: at fewer probes one list split more or
    less moves recall by about the tolerance from one seed to the next, in
    either package."""
    jindex, _ = jax_files[name]
    x, q = _inputs(data, name)
    xf, qf = x.astype(np.float64), q.astype(np.float64)
    score = (qf @ xf.T if name == "ip"
             else -((qf[:, None] - xf[None]) ** 2).sum(-1))
    gt = np.argsort(-score, axis=1, kind="stable")[:, :10]
    own = tfl.build(tfl.IndexParams(n_lists=LISTS, **BUILDS[name]), x, res=CPU)
    assert own.size == N and own.data_kind == jindex.data_kind
    _, ti = tfl.search(tfl.SearchParams(n_probes=5), own, q, 10, res=CPU)
    _, ji = jfl.search(jfl.SearchParams(n_probes=5), jindex, jnp.asarray(q), 10)
    assert _recall(ti.numpy(), gt) >= _recall(np.asarray(ji), gt) - 0.01


def test_empty_build_then_extend(data):
    x, q = data["float"]
    p = dict(n_lists=8, add_data_on_build=False)
    jempty = jfl.build(jfl.IndexParams(**p), jnp.asarray(x[:500]))
    tempty = tfl.build(tfl.IndexParams(**p), x[:500], res=CPU)
    for a in ("list_data", "list_ids", "list_norms", "list_sizes"):
        assert tuple(getattr(tempty, a).shape) == getattr(jempty, a).shape
        np.testing.assert_array_equal(getattr(tempty, a).numpy(), np.asarray(getattr(jempty, a)))
    assert tempty.capacity == 8 and tempty.size == 0
    with pytest.raises(RaftError, match="empty"):
        tfl.search(tfl.SearchParams(), tempty, q, 5, res=CPU)
    full = tfl.extend(tempty, x[:500], res=CPU)
    assert full.size == 500 and sorted(full.list_ids[full.list_ids >= 0].tolist()) == list(range(500))


def test_streamed_extend_equals_in_memory_in_jax(data):
    """The JAX package's streamed extend (a ChunkedReader) gives the lists its
    in-memory extend gives, the one path the port keeps."""
    x, _ = data["float"]
    jempty = jfl.build(jfl.IndexParams(n_lists=LISTS, add_data_on_build=False),
                       jnp.asarray(x))
    a = jfl.extend(jempty, ChunkedReader(x, chunk_rows=700))
    b = jfl.extend(jempty, jnp.asarray(x))
    for f in ("centers", "list_data", "list_ids", "list_norms", "list_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def test_large_host_batch_splits_as_jax_streams(data, monkeypatch):
    """A severely oversized list: the JAX package's streamed extend (taken by
    host batches past its threshold) splits it by input order, and so does
    the port's extend of such a batch; here the port's threshold,
    ``chunked.STREAM_EXTEND_BYTES``, is lowered to reach that path at a
    small size."""
    x, _ = data["float"]
    rng = np.random.default_rng(9)
    base = jfl.build(jfl.IndexParams(n_lists=64, add_data_on_build=False), jnp.asarray(x))
    hot = (np.asarray(base.centers)[5] + rng.normal(0, 0.01, (1500, D))).astype(np.float32)
    batch = np.concatenate([x[:1500], hot])
    j2 = jfl.extend(base, ChunkedReader(batch, chunk_rows=512))
    arrays = {a: np.asarray(getattr(base, a)) for a in tfl._STATE_ARRAYS}
    tbase = tfl.from_state(arrays, res=CPU, metric=int(base.metric))
    monkeypatch.setattr(chunked, "STREAM_EXTEND_BYTES", batch.nbytes - 1)
    t2 = tfl.extend(tbase, batch, res=CPU)
    assert t2.n_lists > 64
    for f in ("centers", "list_data", "list_ids", "list_sizes"):
        np.testing.assert_array_equal(getattr(t2, f).numpy(), np.asarray(getattr(j2, f)))
    np.testing.assert_allclose(t2.list_norms.numpy(), np.asarray(j2.list_norms), rtol=1e-6)


def test_batched_searcher_and_guards(data, jax_files):
    jindex, path = jax_files["uint8"]
    tindex = tfl.load(path, res=CPU)
    xu, qu = data["uint8"]
    jfn = jfl.batched_searcher(jindex, jfl.SearchParams(n_probes=4))
    tfn = tfl.batched_searcher(tindex, tfl.SearchParams(n_probes=4))
    assert (tfn.kind, tfn.dim, tfn.query_dtype) == (jfn.kind, jfn.dim, jfn.query_dtype)
    # searches run on the index's device (the CPU here) without a handle
    td, ti = tfn(qu, 5)
    jd, ji = jfn(jnp.asarray(qu), 5)
    _compare(td, ti, jd, ji, exact=True)
    # a chunked reader (duck-typed: the JAX one here) streams, to the
    # in-core build and extend of its rows; the tuned searcher waits for tune/
    p4 = tfl.IndexParams(n_lists=4)
    for a, b in ((tfl.build(p4, ChunkedReader(xu, chunk_rows=300), res=CPU),
                  tfl.build(p4, xu, res=CPU)),
                 (tfl.extend(tindex, ChunkedReader(xu[:10], chunk_rows=4), res=CPU),
                  tfl.extend(tindex, xu[:10], res=CPU))):
        for f in tfl._STATE_ARRAYS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(RaftError, match="not yet ported"):
        tfl.batched_searcher(dataclasses.replace(tindex, tuned={"n_probes": 3}))
    # contract errors
    with pytest.raises(RaftError, match="stores uint8"):
        tfl.extend(tindex, xu[:5].astype(np.int8), res=CPU)
    with pytest.raises(RaftError, match="uint8 \\+ inner_product"):
        tfl.build(tfl.IndexParams(n_lists=4, metric="inner_product"), xu[:100], res=CPU)
    with pytest.raises(RaftError, match="raw 8-bit"):
        tfl.build(tfl.IndexParams(n_lists=4, list_dtype="int8"), data["float"][0], res=CPU)
    with pytest.raises(RaftError, match="supports L2"):
        tfl.build(tfl.IndexParams(n_lists=4, metric="l1"), data["float"][0], res=CPU)
    with pytest.raises(RaftError, match="exceeds the probed candidate pool"):
        tfl.search(tfl.SearchParams(n_probes=1), tindex, qu, 5000, res=CPU)
    with pytest.raises(RaftError, match="CUDA|lives on"):
        tfl.search(tfl.SearchParams(), tindex, qu, 5, res=Resources(device="cuda"))
