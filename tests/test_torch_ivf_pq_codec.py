"""The rest of raft_tpu_torch.neighbors.ivf_pq against raft_tpu's: byte
ingest, per-cluster and "auto" codebooks, residual_scale_norm, OPQ,
anisotropic codebooks, the fast-scan funnel and the grouped scan order.

Trained artifacts come from other random streams in the port, so, as in
tests/test_torch_ivf_pq.py, the parity seam is the index file: each JAX
build saves, loads into the port byte for byte, and answers the same
searches on every port route (id sets per row, sorted distances at rtol
1e-5 / atol 1e-4 against the JAX package's one-hot scan); a port build
saves and loads into JAX byte for byte; the port's own builds are held to
the JAX builds' recall@10 within 0.03. Encoding (codes, signatures, list
fill) is deterministic, so extending a loaded index matches JAX's extend.

Each JAX build costs seconds of tracing, so features share configurations
(uint8 with "auto" codebooks, per-cluster codebooks with residual_scale_norm)
and :func:`jax_built` builds each once a process; the filter tests
(tests/test_torch_ivf_pq_filter.py) search the same indexes.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.core.chunked import ChunkedReader
from raft_tpu_torch.neighbors import ivf_pq as tpq

CPU = Resources(device="cpu")
N, D, N_PROBES = 3000, 32, 8


def _blobs(seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(50, D)) * 3.0
    x = (centers[rng.integers(0, 50, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 50, 30)] + rng.normal(size=(30, D))).astype(np.float32)
    return x, q


def _heavytail(seed):
    """Clusters whose residual scales span 2.5 decades (the JAX package's
    heavytail family, the case residual_scale_norm is for)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, D)) * 4.0
    scales = 10.0 ** rng.uniform(-1.5, 1.0, 40)
    lab = rng.integers(0, 40, N + 30)
    a = (centers[lab] + rng.normal(size=(N + 30, D)) * scales[lab][:, None]).astype(np.float32)
    return a[:N], a[N:]


def _lines(seed, n_lists=16, rows=100):
    """(residuals (n, 16, 2), labels): each list's residual subvectors on
    one line through its center, 16 lists. Per-cluster codebooks quantize
    these far better than per-subspace ones (the "auto" trial's ratio is
    ~0.5, far below its 0.9 threshold)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n_lists)
    lab = np.repeat(np.arange(n_lists), rows)
    dirs = np.stack([np.cos(theta), np.sin(theta)], 1)[lab][:, None, :]
    resid = rng.normal(size=(len(lab), D // 2, 1)) * dirs
    resid = resid + 0.3 * rng.normal(size=resid.shape)
    return resid.astype(np.float32), lab


def _int8(x, q):
    return tuple(np.clip(np.round(a * 8), -128, 127).astype(np.int8) for a in (x, q))


def _uint8(x, q):
    return tuple(np.clip(np.round(a * 8 + 128), 0, 255).astype(np.uint8) for a in (x, q))


# name -> (IndexParams fields, data); every config n_lists=32 unless stated
CONFIGS = {
    "int8": (dict(pq_dim=16), lambda: _int8(*_blobs(1))),
    "uint8_auto": (dict(pq_dim=8, pq_bits=8, codebook_kind="auto"), lambda: _uint8(*_blobs(2))),
    "per_cluster_scale_norm": (dict(pq_dim=8, pq_bits=8, codebook_kind="per_cluster",
                                    residual_scale_norm=True), lambda: _heavytail(5)),
    "opq_4bit": (dict(pq_dim=16, rotation="opq", fast_scan="4bit"), lambda: _blobs(6)),
    "aniso_1bit_ip": (dict(pq_dim=16, codebook_loss="anisotropic", fast_scan="1bit",
                           metric="inner_product"), lambda: _blobs(7)),
}
FUNNEL = ("opq_4bit", "aniso_1bit_ip")


def _params(name):
    cfg = dict(n_lists=32, seed=0)
    cfg.update(CONFIGS[name][0])
    return cfg


@functools.lru_cache(maxsize=None)
def jax_built(name):
    """(x, q, JAX index, its file's bytes, the port's load of them) of a
    configuration, built once a process."""
    x, q = CONFIGS[name][1]()
    jindex = jpq.build(jpq.IndexParams(**_params(name)), jnp.asarray(x))
    buf = io.BytesIO()
    jpq.write_index(buf, jindex)
    blob = buf.getvalue()
    return x, q, jindex, blob, tpq.read_index(io.BytesIO(blob), torch.device("cpu"))


@pytest.fixture(scope="module")
def built():
    """name -> :func:`jax_built`."""
    return {name: jax_built(name) for name in CONFIGS}


@pytest.fixture(scope="module")
def port_built(built):
    """name -> the port's own build of the same data and params."""
    return {name: tpq.build(tpq.IndexParams(**_params(name)), built[name][0], res=CPU)
            for name in CONFIGS}


def _assert_same_answers(td, ti, jd, ji):
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    assert td.dtype == np.float32 and ti.dtype == np.int32
    for r in range(ti.shape[0]):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-4)


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / gt.shape[1]
                    for r in range(gt.shape[0])])


def _truth(x, q, inner):
    xs, qs = x.astype(np.float64), q.astype(np.float64)
    if x.dtype == np.uint8:
        xs, qs = xs - 128, qs - 128
    s = qs @ xs.T if inner else -((qs[:, None] - xs[None]) ** 2).sum(-1)
    return np.argsort(-s, axis=1, kind="stable")[:, :10]


# the port's routes on CPU tensors: the kernel scan and the plain select
# ("auto"), pq_scan_topk's plain version ("pallas" select), the one-hot form
ROUTES = [dict(), dict(select_impl="pallas"), dict(scan_impl="onehot"),
          dict(lut_dtype="bfloat16")]


@pytest.mark.parametrize("route", ROUTES, ids=["auto", "fused", "onehot", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_index_searches_the_same_in_the_port(built, name, route):
    _, q, jindex, _, tindex = built[name]
    assert tindex.codebook_kind == jindex.codebook_kind
    jsp = {"lut_dtype": route["lut_dtype"]} if "lut_dtype" in route else {}
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, **jsp), jindex, jnp.asarray(q), 10)
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, **route), tindex, q, 10, res=CPU)
    _assert_same_answers(td, ti, jd, ji)


@pytest.mark.parametrize("select", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("name", FUNNEL)
def test_funnel_searches_the_same(built, name, select):
    _, q, jindex, _, tindex = built[name]
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, funnel_widen=4), jindex,
                        jnp.asarray(q), 10)
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, funnel_widen=4, select_impl=select),
                        tindex, q, 10, res=CPU)
    _assert_same_answers(td, ti, jd, ji)


@pytest.mark.parametrize("name,lut", [("int8", "float32"), ("per_cluster_scale_norm", "float32"),
                                      ("per_cluster_scale_norm", "bfloat16"),
                                      ("aniso_1bit_ip", "float32"), ("uint8_auto", "int8")])
def test_grouped_order_searches_the_same(built, name, lut):
    _, q, jindex, _, tindex = built[name]
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, scan_order="grouped",
                                         group_size=4, lut_dtype=lut),
                        jindex, jnp.asarray(q), 10)
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, scan_order="grouped", group_size=4,
                                         lut_dtype=lut), tindex, q, 10, res=CPU)
    _assert_same_answers(td, ti, jd, ji)
    tiled = tpq.search(tpq.SearchParams(n_probes=N_PROBES, lut_dtype=lut, scan_impl="onehot"),
                       tindex, q, 10, res=CPU)
    _assert_same_answers(td, ti, *tiled)


def test_filtered_funnel_and_grouped_search_the_same(built):
    _, q, jindex, _, tindex = built["opq_4bit"]
    keep = np.random.default_rng(0).random(N) < 0.3
    for kw in (dict(funnel_widen=4), dict(scan_order="grouped")):
        jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, **kw), jindex, jnp.asarray(q),
                            10, sample_filter=jnp.asarray(keep))
        td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, **kw), tindex, q, 10,
                            sample_filter=keep, res=CPU)
        _assert_same_answers(td, ti, jd, ji)
        assert keep[ti.numpy()[ti.numpy() >= 0]].all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_file_round_trips_are_byte_identical(built, port_built, tmp_path, name):
    _, _, _, blob, tindex = built[name]
    buf = io.BytesIO()
    tpq.write_index(buf, tindex)
    assert buf.getvalue() == blob
    port = port_built[name]
    ppath = str(tmp_path / "port.bin")
    tpq.save(port, ppath)
    jindex = jpq.load(ppath)
    assert (jindex.codebook_kind, jindex.data_kind, jindex.rotation_kind, jindex.codebook_loss,
            jindex.fast_scan) == (port.codebook_kind, port.data_kind, port.rotation_kind,
                                  port.codebook_loss, port.fast_scan)
    jbuf = io.BytesIO()
    jpq.write_index(jbuf, jindex)
    assert jbuf.getvalue() == open(ppath, "rb").read()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_build_recall_matches_jax(built, port_built, name):
    x, q, jindex, _, _ = built[name]
    port = port_built[name]
    assert port.size == N and port.data_kind == jindex.data_kind
    if name != "uint8_auto":     # test_auto_decides_as_jax holds the decision
        assert port.codebook_kind == jindex.codebook_kind
    assert tuple(port.list_sig.shape[2:]) == tuple(jindex.list_sig.shape[2:])
    gt = _truth(x, q, jindex.metric == jpq.DistanceType.InnerProduct)
    kw = dict(n_probes=N_PROBES, funnel_widen=4 if name in FUNNEL else 1)
    _, ji = jpq.search(jpq.SearchParams(**kw), jindex, jnp.asarray(q), 10)
    _, ti = tpq.search(tpq.SearchParams(**kw), port, q, 10, res=CPU)
    assert _recall(ti, gt) >= _recall(ji, gt) - 0.03


@pytest.mark.parametrize("name", ["uint8_auto", "per_cluster_scale_norm", "opq_4bit",
                                  "aniso_1bit_ip"])
def test_extend_matches_jax(built, name):
    """The same new vectors extend a loaded index as they extend the JAX
    one: ids, sizes and splits exactly; codes, signatures and split L2
    constants up to rare argmin / rounding flips of float32 sums taken in
    another order."""
    x, _, jindex, blob, _ = built[name]
    new = x[:600]
    if x.dtype == np.float32:
        new = new + np.float32(0.05)
    ids = np.arange(10_000, 10_600, dtype=np.int32)
    j2 = jpq.extend(jindex, jnp.asarray(new), jnp.asarray(ids))
    t2 = tpq.extend(tpq.read_index(io.BytesIO(blob), torch.device("cpu")), new, ids)
    assert t2.n_lists == j2.n_lists and t2.capacity == j2.capacity
    np.testing.assert_array_equal(t2.list_ids.numpy(), np.asarray(j2.list_ids))
    np.testing.assert_array_equal(t2.list_sizes.numpy(), np.asarray(j2.list_sizes))
    assert t2.list_sig.shape == tuple(j2.list_sig.shape)
    for a in ("list_codes", "list_sig"):
        flips = (getattr(t2, a).numpy() != np.asarray(getattr(j2, a))).sum()
        assert flips <= 1e-3 * max(getattr(t2, a).numel(), 1), a
    for a in ("list_consts", "list_scales", "sig_scales", "codebooks"):
        np.testing.assert_allclose(getattr(t2, a).numpy(), np.asarray(getattr(j2, a)),
                                   rtol=1e-3, atol=1e-3)


def test_auto_decides_as_jax():
    """The "auto" trial (``_per_cluster_gain``) on the same residuals,
    lists and per-subspace codebooks gives the JAX package's ratio (within
    its random trial's spread) and the same side of 0.9; a port build over
    such clusters takes per-cluster codebooks. The build's own lists come
    from the coarse k-means, whose random streams differ, so the builds are
    not compared here."""
    import jax

    resid, lab = _lines(8)
    sub = resid.transpose(1, 0, 2).copy()
    cb = np.asarray(jpq._train_codebooks_batched(jnp.asarray(sub), jax.random.PRNGKey(0),
                                                 16, 20))
    jr = jpq._per_cluster_gain(jnp.asarray(resid), jnp.asarray(lab), jnp.asarray(cb), False,
                               jax.random.PRNGKey(1), 10)
    tr = tpq._per_cluster_gain(torch.from_numpy(resid), torch.from_numpy(lab),
                               torch.from_numpy(cb), False, torch.Generator().manual_seed(1), 10)
    assert jr < 0.7 and tr < 0.7 and abs(jr - tr) < 0.1, (jr, tr)
    # eight such clusters, which the coarse k-means cuts into 16 lists
    resid, lab = _lines(8, n_lists=8, rows=200)
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(8, D)).astype(np.float32) * 40.0
    x = centers[lab] + resid.reshape(len(lab), D)
    index = tpq.build(tpq.IndexParams(n_lists=16, pq_dim=16, codebook_kind="auto",
                                      kmeans_trainset_fraction=1.0), x, res=CPU)
    assert index.codebook_kind == "per_cluster"
    assert tuple(index.codebooks.shape) == (index.n_lists, 16, 2)


def test_byte_ingest_contract(built):
    x, q, _, _, tindex = built["uint8_auto"]
    # uint8 queries shift with the index; float queries are in its original domain
    d0, i0 = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tindex, q, 10, res=CPU)
    d1, i1 = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tindex, q.astype(np.float32), 10,
                        res=CPU)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    with pytest.raises(RaftError, match="stores uint8"):
        tpq.search(tpq.SearchParams(), tindex, q.astype(np.int8), 10, res=CPU)
    with pytest.raises(RaftError, match="stores uint8"):
        tpq.extend(tindex, x[:10].astype(np.int8))
    with pytest.raises(RaftError, match="uint8 \\+ inner_product"):
        tpq.build(tpq.IndexParams(n_lists=8, metric="inner_product"), x[:500], res=CPU)
    ip = tpq.build(tpq.IndexParams(n_lists=8, metric="inner_product"),
                   x[:500].astype(np.int16).clip(-128, 127).astype(np.int8), res=CPU)
    assert ip.data_kind == "int8"


def test_batched_searcher(built):
    _, q, _, _, tindex = built["uint8_auto"]
    sp = tpq.SearchParams(n_probes=N_PROBES)
    hook = tpq.batched_searcher(tindex, sp)
    assert (hook.kind, hook.dim, hook.query_dtype) == ("ivf_pq", D, "uint8")
    for a, b in zip(hook(q, 10), tpq.search(sp, tindex, q, 10, res=CPU)):
        assert torch.equal(a, b)
    tuned = dataclasses.replace(tindex, tuned={"n_probes": 4})
    assert tpq.batched_searcher(tuned, sp).kind == "ivf_pq"
    with pytest.raises(RaftError, match="not yet ported"):
        tpq.batched_searcher(tuned)


def test_contract_errors(built):
    x, q, _, _, plain = built["per_cluster_scale_norm"]
    _, fq, _, _, funnel = built["opq_4bit"]
    with pytest.raises(RaftError, match="fast-scan tier"):
        tpq.search(tpq.SearchParams(n_probes=4, funnel_widen=2), plain, q, 10, res=CPU)
    for kw, msg in ((dict(scan_order="grouped"), "tiled scan"),
                    (dict(scan_impl="kernel"), "one-hot signature"),
                    (dict(lut_dtype="int8"), "signature tier")):
        with pytest.raises(RaftError, match=msg):
            tpq.search(tpq.SearchParams(n_probes=4, funnel_widen=2, **kw), funnel, fq, 10,
                       res=CPU)
    for kw, k, msg in ((dict(), plain.capacity + 1, "capacity"),
                       (dict(scan_impl="select"), 10, "one-hot contraction"),
                       (dict(group_size=0), 10, "group_size"),
                       (dict(group_size=1025), 10, "group_size")):
        with pytest.raises(RaftError, match=msg):
            tpq.search(tpq.SearchParams(n_probes=32, scan_order="grouped", **kw), plain, q, k,
                       res=CPU)
    with pytest.raises(RaftError, match="anisotropic"):
        tpq.build(tpq.IndexParams(n_lists=8, pq_bits=8, codebook_loss="anisotropic"),
                  x[:500], res=CPU)

    # a chunked reader streams, to the in-core build of its rows
    p8 = tpq.IndexParams(n_lists=8, pq_bits=8, codebook_kind="per_cluster")
    streamed = tpq.build(p8, ChunkedReader(x[:600], chunk_rows=250), res=CPU)
    incore = tpq.build(p8, x[:600], res=CPU)
    for f in ("codebooks", "list_codes", "list_consts", "list_ids"):
        assert torch.equal(getattr(streamed, f), getattr(incore, f)), f
