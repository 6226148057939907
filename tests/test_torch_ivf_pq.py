"""raft_tpu_torch.neighbors.ivf_pq and .refine against raft_tpu's.

The two packages train from different random streams, so the parity seam is
the index file: an index the JAX package builds and saves loads into the
port and answers the same searches; an index the port saves loads into JAX;
``from_state`` carries a JAX index's arrays. The port's own builds are held
to the JAX builds' recall. The JAX side runs its Pallas scan in interpret
mode (RAFT_TPU_PQ_SCAN_INTERPRET=1, as tests/test_ivf_pq.py does); the port's
kernel route runs the kernel's plain version on CPU tensors.

Searches are compared as tests/test_ivf_pq.py compares its scan
formulations: the id set of every row, and the sorted distances at rtol 1e-5
/ atol 1e-4, after checking that both sides probe the same lists.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core import serialize as jser
from raft_tpu.matrix.select_k import _select_k as j_select_k
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors.refine import refine as j_refine
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.core.chunked import ChunkedReader
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as tref
from raft_tpu_torch.ops.pq_scan import pq_scan

CPU = Resources(device="cpu")
N_PROBES = 8
CONFIGS = {
    "pq4": dict(n_lists=32, pq_dim=16, pq_bits=4, seed=0),
    "pq8split": dict(n_lists=32, pq_dim=8, pq_bits=8, seed=0),
    "pq8joint": dict(n_lists=32, pq_dim=8, pq_bits=8, pq8_split=False, seed=0),
    "pq4ip": dict(n_lists=32, pq_dim=16, pq_bits=4, seed=0, metric="inner_product"),
}


@pytest.fixture(autouse=True)
def _jax_kernel_route(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PQ_SCAN_INTERPRET", "1")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(60, 32)) * 3.0
    x = (centers[rng.integers(0, 60, 4000)] + rng.normal(size=(4000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 60, 40)] + rng.normal(size=(40, 32))).astype(np.float32)
    d2 = ((q.astype(np.float64)[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :10]


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """name -> (JAX index, path of its raft_tpu/13 file)."""
    x, _, _ = data
    out = {}
    for name, cfg in CONFIGS.items():
        index = jpq.build(jpq.IndexParams(**cfg), jnp.asarray(x))
        path = str(tmp_path_factory.mktemp("jax") / f"{name}.bin")
        jpq.save(index, path)
        out[name] = (index, path)
    return out


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / gt.shape[1]
                    for r in range(gt.shape[0])])


def _assert_same_answers(td, ti, jd, ji):
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    assert td.dtype == np.float32 and ti.dtype == np.int32
    for r in range(ti.shape[0]):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-4)


def _jax_probes(index, q, n_probes):
    """The JAX search's coarse stage (raft_tpu/neighbors/ivf_pq.py:1633-1638)."""
    qf = jnp.asarray(q)
    cscore = qf @ index.centers.T
    inner = index.metric == jpq.DistanceType.InnerProduct
    if not inner:
        cscore = jnp.sum(index.centers * index.centers, axis=1)[None, :] - 2.0 * cscore
    return np.asarray(j_select_k(cscore, None, n_probes, not inner)[1])


@pytest.mark.parametrize("name,impl,lut", [
    ("pq4", "onehot", "float32"), ("pq4", "pallas", "float32"),
    ("pq4", "onehot", "bfloat16"), ("pq8split", "onehot", "float32"),
    ("pq8split", "pallas", "float32"), ("pq8joint", "onehot", "float32"),
    ("pq4ip", "onehot", "float32"), ("pq4", "onehot", "int8"),
])
def test_jax_index_searches_the_same_in_the_port(data, jax_files, name, impl, lut):
    _, q, _ = data
    if impl == "pallas":
        q = q[:16]          # each interpret-mode shape costs seconds to trace
    jindex, path = jax_files[name]
    tindex = tpq.load(path, res=CPU)
    assert tindex.device.type == "cpu"
    # pin the coarse stage first, so a near tie there cannot hide a scan fault
    probes = tpq._coarse_probes(tindex, torch.from_numpy(q), N_PROBES)
    np.testing.assert_array_equal(probes.numpy(), _jax_probes(jindex, q, N_PROBES))
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, scan_impl=impl, lut_dtype=lut),
                        jindex, jnp.asarray(q), 10)
    for port_impl in ({impl, "auto"} if lut != "int8" else {impl}):
        params = tpq.SearchParams(n_probes=N_PROBES, scan_impl=port_impl, lut_dtype=lut)
        td, ti = tpq.search(params, tindex, q, 10, res=CPU)
        _assert_same_answers(td, ti, jd, ji)


@pytest.mark.parametrize("name", ["pq4", "pq8split"])
def test_port_scan_forms_agree(data, jax_files, name):
    """"select" and the kernel's route give the one-hot route's answers."""
    _, q, _ = data
    tindex = tpq.load(jax_files[name][1], res=CPU)
    launched = pq_scan.launches
    ref = tpq.search(tpq.SearchParams(n_probes=N_PROBES, scan_impl="onehot"), tindex, q, 10,
                     res=CPU)
    for kw in (dict(scan_impl="select"), dict(scan_impl="kernel"),
               dict(select_impl="pallas"), dict(select_impl="xla")):
        got = tpq.search(tpq.SearchParams(n_probes=N_PROBES, **kw), tindex, q, 10, res=CPU)
        _assert_same_answers(*got, *ref)
    assert pq_scan.launches == launched          # CPU tensors: the plain version


def test_sqrt_metric_matches_jax(data, jax_files):
    """L2Sqrt indexes take the square root of the merged distances."""
    import dataclasses

    _, q, _ = data
    jindex, path = jax_files["pq4"]
    jindex = dataclasses.replace(jindex, metric=jpq.DistanceType.L2SqrtExpanded)
    tindex = dataclasses.replace(tpq.load(path, res=CPU),
                                 metric=tpq.DistanceType.L2SqrtExpanded)
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES), jindex, jnp.asarray(q), 10)
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tindex, q, 10, res=CPU)
    _assert_same_answers(td, ti, jd, ji)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_file_round_trip_is_byte_identical(jax_files, name):
    _, path = jax_files[name]
    buf = io.BytesIO()
    tpq.write_index(buf, tpq.load(path, res=CPU))
    assert buf.getvalue() == open(path, "rb").read()


@pytest.mark.parametrize("version", ["raft_tpu/12", "raft_tpu/8"])
def test_reads_older_versions(data, jax_files, monkeypatch, version):
    _, q, _ = data
    jindex, path = jax_files["pq8split"]
    monkeypatch.setattr(jser, "SERIALIZATION_VERSION", version)
    buf = io.BytesIO()
    jpq.write_index(buf, jindex)
    buf.seek(0)
    old = tpq.read_index(buf)
    assert old.rotation_kind == "none" and old.list_sig.shape == (old.n_lists, 0, 0)
    params = tpq.SearchParams(n_probes=N_PROBES)
    d0, i0 = tpq.search(params, tpq.load(path, res=CPU), q, 10, res=CPU)
    d1, i1 = tpq.search(params, old, q, 10, res=CPU)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


@pytest.mark.parametrize("name", ["pq4", "pq8split"])
def test_port_saved_index_loads_in_jax(data, tmp_path, name):
    x, q, _ = data
    tindex = tpq.build(tpq.IndexParams(**CONFIGS[name]), x, res=CPU)
    path = str(tmp_path / "port.bin")
    tpq.save(tindex, path)
    jindex = jpq.load(path)
    assert jindex.pq_split == tindex.pq_split and jindex.capacity == tindex.capacity
    np.testing.assert_array_equal(np.asarray(jindex.list_ids), tindex.list_ids.numpy())
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, scan_impl="onehot"), jindex,
                        jnp.asarray(q), 10)
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tindex, q, 10, res=CPU)
    _assert_same_answers(td, ti, jd, ji)


def test_from_state_matches_load(data, jax_files):
    _, q, _ = data
    jindex, path = jax_files["pq8split"]
    arrays = {a: np.asarray(getattr(jindex, a)) for a in tpq._STATE_ARRAYS}
    meta = dict(metric=jindex.metric, codebook_kind=jindex.codebook_kind,
                pq_bits=jindex.pq_bits, split_factor=jindex.split_factor,
                pq_split=jindex.pq_split, data_kind=jindex.data_kind)
    state = tpq.from_state(arrays, res=CPU, **meta)
    loaded = tpq.load(path, res=CPU)
    params = tpq.SearchParams(n_probes=N_PROBES, lut_dtype="bfloat16")
    for a, b in zip(tpq.search(params, state, q, 10, res=CPU),
                    tpq.search(params, loaded, q, 10, res=CPU)):
        assert torch.equal(a, b)
    with pytest.raises(RaftError, match="missing"):
        tpq.from_state({"centers": arrays["centers"]}, res=CPU)


@pytest.mark.parametrize("name", ["pq4", "pq8split"])
def test_port_build_recall_matches_jax(data, jax_files, name):
    x, q, gt = data
    jindex, _ = jax_files[name]
    tindex = tpq.build(tpq.IndexParams(**CONFIGS[name]), x, res=CPU)
    assert tindex.size == x.shape[0] and tindex.pq_split == jindex.pq_split
    params = dict(n_probes=N_PROBES)
    _, ji = jpq.search(jpq.SearchParams(**params), jindex, jnp.asarray(q), 40)
    _, ti = tpq.search(tpq.SearchParams(**params), tindex, q, 40, res=CPU)
    assert _recall(ti[:, :10], gt) >= _recall(np.asarray(ji)[:, :10], gt) - 0.05
    # refine 40 -> 10: the port's re-rank of its own candidates
    jr = j_refine(jnp.asarray(x), jnp.asarray(q), ji, 10)[1]
    tr = tref.refine(x, q, ti, 10, res=CPU)[1]
    assert _recall(tr, gt) >= _recall(jr, gt) - 0.05


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
def test_refine_matches_jax(data, jax_files, metric):
    x, q, _ = data
    _, cand = jpq.search(jpq.SearchParams(n_probes=4), jax_files["pq4"][0], jnp.asarray(q), 40)
    cand = np.asarray(cand).copy()
    cand[::7, -5:] = -1                                    # padding slots
    jd, ji = j_refine(jnp.asarray(x), jnp.asarray(q), jnp.asarray(cand), 10, metric=metric)
    td, ti = tref.refine(x, q, cand, 10, metric=metric, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    gd, gi = tref.refine_gathered(x[np.maximum(cand, 0)], q, cand, 10, metric=metric, res=CPU)
    assert torch.equal(gd, td) and torch.equal(gi, ti)


@pytest.mark.parametrize("name", ["pq8split"])
def test_extend_matches_jax(data, jax_files, name):
    """Encoding, list fill and the capacity split are deterministic: the same
    new vectors extend a loaded index as they extend the JAX one."""
    x, _, _ = data
    jindex, path = jax_files[name]
    new = x[:700] + 0.05
    ids = np.arange(10_000, 10_700, dtype=np.int32)
    j2 = jpq.extend(jindex, jnp.asarray(new), jnp.asarray(ids))
    t2 = tpq.extend(tpq.load(path, res=CPU), new, ids)
    assert t2.n_lists == j2.n_lists and t2.capacity == j2.capacity
    np.testing.assert_array_equal(t2.list_ids.numpy(), np.asarray(j2.list_ids))
    np.testing.assert_array_equal(t2.list_sizes.numpy(), np.asarray(j2.list_sizes))
    np.testing.assert_allclose(t2.centers.numpy(), np.asarray(j2.centers))
    # argmin over float32 scores summed in another order: a rare code may flip
    assert np.mean(t2.list_codes.numpy() != np.asarray(j2.list_codes)) < 1e-3
    if t2.pq_split:
        np.testing.assert_allclose(t2.list_consts.numpy(), np.asarray(j2.list_consts),
                                   rtol=1e-3, atol=1e-3)


def test_not_yet_ported_and_contract_errors(data, jax_files):
    x, q, _ = data

    # a chunked reader streams: the build and the extend equal the in-core
    # ones over the same rows; a tuned index's hook without params serves
    # its pin as JAX's does
    p8 = tpq.IndexParams(n_lists=8)
    streamed = tpq.build(p8, ChunkedReader(x[:1000], chunk_rows=300), res=CPU)
    incore = tpq.build(p8, x[:1000], res=CPU)
    for f in ("centers", "rotation", "codebooks", "list_codes", "list_ids", "list_sizes"):
        assert torch.equal(getattr(streamed, f), getattr(incore, f)), f
    index = tpq.load(jax_files["pq4"][1], res=CPU)
    assert torch.equal(tpq.extend(index, ChunkedReader(x[:300], chunk_rows=128)).list_codes,
                       tpq.extend(index, x[:300]).list_codes)
    jindex = jax_files["pq4"][0]
    pin = {"kind": "ivf_pq", "params": {"n_probes": 4, "scan_impl": "onehot"}}
    jindex.tuned = pin
    try:
        jpin = jpq.batched_searcher(jindex)
    finally:
        jindex.tuned = None
    tpin = tpq.batched_searcher(dataclasses.replace(index, tuned=pin))
    assert tpin.tuned == jpin.tuned == "ivf_pq/float32/any" and tpin.kind == jpin.kind
    _assert_same_answers(*tpin(q, 10), *jpin(jnp.asarray(q), 10))
    for kw, msg in ((dict(codebook_kind="per_tree"), "codebook_kind"),
                    (dict(rotation="pca"), "rotation"), (dict(fast_scan="2bit"), "fast_scan"),
                    (dict(codebook_loss="l1"), "codebook_loss")):
        with pytest.raises(RaftError, match=msg):
            tpq.build(tpq.IndexParams(n_lists=8, **kw), x[:500], res=CPU)
    with pytest.raises(RaftError, match="fast-scan tier"):
        tpq.search(tpq.SearchParams(n_probes=4, funnel_widen=2), index, q, 10, res=CPU)
    with pytest.raises(RaftError, match="scan_order"):
        tpq.search(tpq.SearchParams(n_probes=4, scan_order="sorted"), index, q, 10, res=CPU)
    with pytest.raises(RaftError, match="cover"):
        tpq.search(tpq.SearchParams(n_probes=4), index, q, 10,
                   sample_filter=np.ones(3999, bool), res=CPU)
    with pytest.raises(RaftError, match="one-hot"):
        tpq.search(tpq.SearchParams(n_probes=4, scan_impl="pallas", lut_dtype="int8"),
                   index, q, 10, res=CPU)
    joint = tpq.load(jax_files["pq8joint"][1], res=CPU)
    with pytest.raises(RaftError, match="16-wide"):
        tpq.search(tpq.SearchParams(n_probes=4, scan_impl="kernel"), joint, q, 10, res=CPU)
    assert tpq.resolve_scan_impl(tpq.SearchParams(), joint, 256) == "onehot"
    assert tpq.resolve_scan_impl(tpq.SearchParams(lut_dtype="bfloat16"), index, 16) == "kernel"
    with pytest.raises(RaftError, match="query dim"):
        tpq.search(tpq.SearchParams(), index, q[:, :8], 10, res=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RaftError, match="CUDA"):
            tpq.build(tpq.IndexParams(n_lists=8), x[:500])
        with pytest.raises(RaftError, match="CUDA"):
            tpq.load(jax_files["pq4"][1])


def test_search_refuses_a_handle_on_another_device(data, jax_files):
    """The search runs on the index's device; a handle naming another raises."""
    _, q, _ = data
    index = tpq.load(jax_files["pq4"][1], res=CPU)
    with pytest.raises(RaftError, match="lives on cpu"):
        tpq.search(tpq.SearchParams(n_probes=4), index, q, 10, res=Resources(device="cuda"))


@pytest.mark.parametrize("name,lut", [("pq4", "float32"), ("pq8split", "bfloat16"),
                                      ("pq4ip", "float32")])
def test_fused_route_answers_as_jax(data, jax_files, name, lut, monkeypatch):
    """scan_impl="kernel" with select_impl="pallas" takes pq_scan_topk (its
    plain version on CPU tensors) and gives the JAX search's answers."""
    _, q, _ = data
    q = q[:16]              # each interpret-mode shape costs seconds to trace
    jindex, path = jax_files[name]
    tindex = tpq.load(path, res=CPU)
    routes = []
    real = tpq._fuses_scan_and_select
    monkeypatch.setattr(tpq, "_fuses_scan_and_select",
                        lambda *a: routes.append(real(*a)) or routes[-1])
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, scan_impl="pallas", lut_dtype=lut),
                        jindex, jnp.asarray(q), 10)
    params = tpq.SearchParams(n_probes=N_PROBES, scan_impl="kernel", select_impl="pallas",
                              lut_dtype=lut)
    td, ti = tpq.search(params, tindex, q, 10, res=CPU)
    assert routes == [True]
    _assert_same_answers(td, ti, jd, ji)


@pytest.mark.parametrize("scan,select", [("kernel", "kernel"), ("kernel", "torch"),
                                         ("onehot", "auto")])
def test_one_chunk_and_many_chunks_answer_alike(data, jax_files, scan, select):
    """A tile of one chunk keeps the chunk's k without a merge; a tile of four
    chunks merges them. Both equal the merge of the one chunk's answer with
    itself (the step the one-chunk tile skips), ids and value bits."""
    from raft_tpu_torch.matrix.select_k import select_k_impl

    _, q, _ = data
    for name in ("pq4", "pq8split"):
        index = tpq.load(jax_files[name][1], res=CPU)
        qt = torch.from_numpy(q)
        one = tpq._pq_search(index, qt, N_PROBES, 10, 16, N_PROBES, "float32", scan, select)
        many = tpq._pq_search(index, qt, N_PROBES, 10, 16, 2, "float32", scan, select)
        merged = select_k_impl(one[0], one[1], 10, True, impl=select)
        for a, b, c in zip(one, many, merged):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
