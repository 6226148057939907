"""The out-of-core streamed builds of raft_tpu_torch, against its in-core
builds and against the JAX package (tests/test_ooc_build.py's contracts).

- (a) A build or extend from a ``core.chunked.ChunkedReader`` (a ``.npy``
  or raw ``np.memmap`` file, or an array) equals the port's in-core build of
  the same rows in every tensor field, list layout included: brute force,
  IVF-Flat, IVF-PQ and CAGRA, in float32 and the byte dtypes.
- (b) An index the JAX package streamed, saved and loaded into the port,
  searches to the JAX answers.
- (c) ``obs.mem.plan()`` returns the JAX plan's numbers for the same
  arguments, and at 100k rows is within ±20% of the port's measured bytes
  (in-core, every kind) and ledger peak (streamed IVF-Flat).
- (d) Armed device and host budgets refuse a streamed build at
  ``site="build_stream"`` / ``"build_stream/host"`` with the JAX build's
  numbers, before any chunk stages.
- (e) A second streamed build builds no kernel.

Plus the extend's auto-wrap of large host batches, the stream layer's
``compact("rebuild", ooc_chunk_rows=)`` and ``@instrument``.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core import Resources as JResources
from raft_tpu.core import chunked as jch
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import mem as jmem
from raft_tpu.obs import metrics as jmetrics
from raft_tpu.serve.errors import MemoryBudgetError as JMemoryBudgetError
from raft_tpu_torch import obs, stream
from raft_tpu_torch.core import RaftError, Resources, chunked
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import mem, metrics
from raft_tpu_torch.serve.errors import MemoryBudgetError

CPU = Resources(device="cpu")
KINDS = ("brute_force", "ivf_flat", "ivf_pq", "cagra")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The builds here are many small ops; with several test workers on one
    machine, torch's intra-op threads contend far more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, d), dtype=np.uint8)
    if dtype == np.int8:
        return rng.integers(-128, 128, (n, d)).astype(np.int8)
    return rng.standard_normal((n, d)).astype(dtype)


def _reader(x, tmp_path, chunk_rows, kind="npy"):
    """The corpus on disk, read back as a memmap: ``.npy`` or raw bytes."""
    if kind == "npy":
        path = tmp_path / "corpus.npy"
        np.save(path, x)
        return chunked.ChunkedReader.from_file(path, chunk_rows=chunk_rows)
    path = tmp_path / "corpus.raw"
    x.tofile(path)
    return chunked.ChunkedReader.from_file(path, dtype=x.dtype, shape=x.shape,
                                           chunk_rows=chunk_rows)


def _tensors(ix):
    if isinstance(ix, brute_force.BruteForce):
        return {"dataset": ix.dataset}
    return {f.name: getattr(ix, f.name) for f in dataclasses.fields(ix)
            if isinstance(getattr(ix, f.name), torch.Tensor)}


def _assert_bit_equal(a, b, what=""):
    fa, fb = _tensors(a), _tensors(b)
    assert fa.keys() == fb.keys()
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype or fa[k].shape != fb[k].shape
           or not torch.equal(fa[k], fb[k])]
    assert not bad, f"fields differ {what}: {bad}"


def _chunks_total(kind=None):
    snap = metrics.snapshot().get("raft_tpu_build_ooc_chunks_total")
    if snap is None:
        return 0
    return sum(s["value"] for s in snap["series"]
               if kind is None or s["labels"].get("kind") == kind)


def _staging_entries():
    return [r for r in mem.breakdown() if r["component"] == "build/staging"]


def _port_build(kind, x, res=CPU, **p):
    if kind == "brute_force":
        return brute_force.BruteForce().build(x, res)
    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "cagra": cagra}[kind]
    return mod.build(mod.IndexParams(**p), x, res=res)


PARAMS = {"brute_force": {}, "ivf_flat": dict(n_lists=32, seed=3),
          "ivf_pq": dict(n_lists=32, pq_dim=8, seed=5),
          "cagra": dict(intermediate_graph_degree=16, graph_degree=8)}


# -- (a) streamed equals in-core ------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype,file", [(np.float32, "npy"), (np.int8, "raw"),
                                        (np.uint8, "raw")])
def test_streamed_build_equals_in_core(tmp_path, kind, dtype, file):
    """Each kind's build from a memmap reader of ~5 chunks equals its
    in-core build of the same rows bit for bit, every field. The chunk
    counters tick for each streamed pass."""
    n = 600 if kind == "cagra" else 3000
    x = _corpus(n, 16 if dtype != np.float32 else 32, dtype)
    incore = _port_build(kind, x, **PARAMS[kind])
    before = _chunks_total()
    reader = _reader(x, tmp_path, chunk_rows=-(-n // 5), kind=file)
    assert reader.n_chunks == 5
    streamed = _port_build(kind, reader, **PARAMS[kind])
    _assert_bit_equal(incore, streamed, f"({kind} {np.dtype(dtype)})")
    passes = 2 if kind in ("ivf_flat", "ivf_pq") else 1
    assert _chunks_total() >= before + passes * reader.n_chunks


def test_streamed_build_metrics_and_ledger(tmp_path):
    """The ooc metrics family moves (chunks by stage, staged bytes, the
    chunk-rows gauge), and no staging entry outlives the build."""
    x = _corpus(8000, 16, np.float32)
    reader = _reader(x, tmp_path, 2000)
    snap0 = metrics.snapshot()
    ivf_flat.build(ivf_flat.IndexParams(n_lists=16, seed=1), reader, res=CPU)
    snap = metrics.snapshot()
    stages = {s["labels"]["stage"]: s["value"]
              for s in snap["raft_tpu_build_ooc_chunks_total"]["series"]
              if s["labels"]["kind"] == "ivf_flat"}
    stages0 = {s["labels"]["stage"]: s["value"]
               for s in snap0.get("raft_tpu_build_ooc_chunks_total", {"series": []})["series"]
               if s["labels"]["kind"] == "ivf_flat"}
    assert {k: v - stages0.get(k, 0) for k, v in stages.items()} == {"assign": 4, "fill": 4}
    staged = {s["labels"]["kind"]: s["value"]
              for s in snap["raft_tpu_build_ooc_staged_bytes_total"]["series"]}
    assert staged["ivf_flat"] >= 8 * 2000 * 16 * 4
    rows = {s["labels"]["kind"]: s["value"]
            for s in snap["raft_tpu_build_ooc_chunk_rows"]["series"]}
    assert rows["ivf_flat"] == 2000
    gc.collect()
    assert not [r for r in _staging_entries() if r["name"] == "ivf_flat"]
    assert not [r for r in mem.breakdown() if r["component"] == "build/ooc"]


@pytest.mark.parametrize("params", [
    dict(n_lists=32, pq_dim=8, pq_bits=8, seed=2),                 # split pq8 + consts
    dict(n_lists=32, pq_dim=8, pq_bits=8, pq8_split=False, seed=2, metric="inner_product"),
    dict(n_lists=16, pq_dim=8, codebook_kind="per_cluster", residual_scale_norm=True,
         fast_scan="4bit", seed=2),
    dict(n_lists=16, pq_dim=8, rotation="opq", codebook_loss="anisotropic",
         fast_scan="1bit", seed=2),
], ids=["pq8split", "pq8ip", "per_cluster_scaled_4bit", "opq_aniso_1bit"])
def test_streamed_ivf_pq_codecs_equal_in_core(params):
    x = _corpus(2000, 32, np.float32, seed=4)
    _assert_bit_equal(ivf_pq.build(ivf_pq.IndexParams(**params), x, res=CPU),
                      ivf_pq.build(ivf_pq.IndexParams(**params),
                                   chunked.ChunkedReader(x, chunk_rows=489), res=CPU))


@pytest.mark.parametrize("params", [dict(n_lists=16, seed=1, metric="inner_product"),
                                    dict(n_lists=16, seed=1, list_dtype="bfloat16"),
                                    dict(n_lists=16, seed=1, kmeans_trainset_fraction=1.0)],
                         ids=["ip", "bf16_lists", "whole_trainset"])
def test_streamed_ivf_flat_variants_equal_in_core(params):
    x = _corpus(4000, 16, np.float64, seed=5)      # float64 rows land as float32
    _assert_bit_equal(ivf_flat.build(ivf_flat.IndexParams(**params), x, res=CPU),
                      ivf_flat.build(ivf_flat.IndexParams(**params),
                                     chunked.ChunkedReader(x, chunk_rows=999), res=CPU))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_streamed_extend_equals_in_core(kind, dtype):
    """An extend from a reader equals the extend of the same rows as a
    tensor, onto the same index (old rows first, then the new ones)."""
    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}[kind]
    x, batch = _corpus(4000, 16, dtype, seed=6), _corpus(1500, 16, dtype, seed=7)
    base = mod.build(mod.IndexParams(**PARAMS[kind]), x, res=CPU)
    ids = torch.arange(10_000, 11_500, dtype=torch.int32)
    _assert_bit_equal(mod.extend(base, torch.from_numpy(batch), ids, res=CPU),
                      mod.extend(base, chunked.ChunkedReader(batch, chunk_rows=400), ids,
                                 res=CPU), kind)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_extend_auto_wraps_large_host_batches(monkeypatch, kind):
    """A host ndarray past ``chunked.STREAM_EXTEND_BYTES`` streams (the
    chunk counters tick) with the in-core result; one threshold serves both
    IVF kinds, as in the JAX package."""
    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}[kind]
    x, batch = _corpus(4000, 16, np.float32, seed=8), _corpus(1500, 16, np.float32, seed=9)
    monkeypatch.setattr(chunked, "STREAM_EXTEND_BYTES", 1 << 12)
    base = mod.build(mod.IndexParams(**PARAMS[kind]), x, res=CPU)
    incore = mod.extend(base, torch.from_numpy(batch), res=CPU)   # a tensor stays in-core
    before = _chunks_total(kind)
    streamed = mod.extend(base, batch, res=CPU)
    assert _chunks_total(kind) > before, f"{kind}: the large host batch must stream"
    _assert_bit_equal(incore, streamed, kind)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_extend_small_batches_stay_in_core(kind):
    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}[kind]
    idx = mod.build(mod.IndexParams(**PARAMS[kind]), _corpus(3000, 16, np.float32), res=CPU)
    before = _chunks_total(kind)
    out = mod.extend(idx, _corpus(64, 16, np.float32, seed=1), res=CPU)
    assert _chunks_total(kind) == before and out.size == 3064


def test_streamed_extend_refuses_a_wrong_byte_dtype():
    x = _corpus(2000, 16, np.uint8)
    for mod in (ivf_flat, ivf_pq):
        idx = mod.build(mod.IndexParams(**PARAMS[mod.__name__.rsplit(".", 1)[1]]), x, res=CPU)
        with pytest.raises(RaftError, match="stores uint8"):
            mod.extend(idx, chunked.ChunkedReader(x[:100].astype(np.int8)), res=CPU)


# -- (b) a JAX streamed build searches to the JAX answers in the port -----------------

@pytest.fixture(scope="module")
def jax_streamed(tmp_path_factory):
    """kind -> (JAX index built from a reader, path of its saved file, queries)."""
    out = {}
    d = tmp_path_factory.mktemp("jax_ooc")
    x = _corpus(6000, 32, np.float32, seed=11)
    q = _corpus(40, 32, np.float32, seed=12)
    # whole chunks only: a tail chunk of another shape would compile the JAX
    # programs again
    reader = jch.ChunkedReader(x, chunk_rows=1500)
    for kind, build, mod in (
            ("brute_force", lambda r: jbf.BruteForce().build(r), jbf),
            ("ivf_flat", lambda r: jflat.build(jflat.IndexParams(n_lists=32, seed=3), r), jflat),
            ("ivf_pq", lambda r: jpq.build(jpq.IndexParams(n_lists=32, pq_dim=16, seed=5), r),
             jpq)):
        index = build(reader)
        path = str(d / f"{kind}.bin")
        mod.save(index, path)
        out[kind] = (index, path, q)
    xc = x[:1500, :16].copy()
    index = jcagra.build(jcagra.IndexParams(**PARAMS["cagra"]),
                         jch.ChunkedReader(xc, chunk_rows=500))
    path = str(d / "cagra.bin")
    jcagra.save(index, path)
    out["cagra"] = (index, path, q[:, :16].copy())
    return out


def _same_ids_and_distances(td, ti, jd, ji, overlap=1.0, rtol=1e-5):
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    assert td.shape == jd.shape and ti.dtype == np.int32
    agree = np.mean([len(set(ti[r].tolist()) & set(ji[r].tolist())) / ti.shape[1]
                     for r in range(ti.shape[0])])
    assert agree >= overlap, agree
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_streamed_index_searches_the_same_in_the_port(jax_streamed, kind):
    jindex, path, q = jax_streamed[kind]
    if kind == "brute_force":
        tindex = brute_force.load(path, res=CPU)
        jd, ji = jindex.search(jnp.asarray(q), 10)
        td, ti = tindex.search(q, 10)
        _same_ids_and_distances(td, ti, jd, ji)
    elif kind == "cagra":
        tindex = cagra.load(path, res=CPU)
        sp = dict(itopk_size=32, hop_impl="xla")
        jd, ji = jcagra.search(jcagra.SearchParams(**sp), jindex, jnp.asarray(q), 10)
        td, ti = cagra.search(cagra.SearchParams(**sp), tindex, q, 10)
        _same_ids_and_distances(td, ti, jd, ji, overlap=0.99, rtol=1e-4)
    else:
        mod, jmod = {"ivf_flat": (ivf_flat, jflat), "ivf_pq": (ivf_pq, jpq)}[kind]
        tindex = mod.load(path, res=CPU)
        jd, ji = jmod.search(jmod.SearchParams(n_probes=8), jindex, jnp.asarray(q), 10)
        td, ti = mod.search(mod.SearchParams(n_probes=8), tindex, q, 10)
        _same_ids_and_distances(td, ti, jd, ji)
    for name, t in _tensors(tindex).items():
        a = getattr(jindex, name)
        assert tuple(t.shape) == tuple(a.shape), name


# -- (c) plan() --------------------------------------------------------------------------

_PLAN_PARAMS = {
    "brute_force": [None],
    "ivf_flat": [dict(n_lists=256, kmeans_n_iters=4), dict(n_lists=64, list_dtype="bfloat16")],
    "ivf_pq": [dict(n_lists=256, pq_bits=4, pq_dim=8, kmeans_n_iters=4),
               dict(n_lists=64, pq_bits=8),
               dict(n_lists=64, pq_bits=8, metric="inner_product", codebook_kind="per_cluster",
                    residual_scale_norm=True, fast_scan="4bit")],
    "cagra": [dict(intermediate_graph_degree=32, graph_degree=16, build_n_probes=8), {}],
}


def _params(kind, kw, port=True):
    if kw is None:
        return None
    mods = {"ivf_flat": (ivf_flat, jflat), "ivf_pq": (ivf_pq, jpq), "cagra": (cagra, jcagra)}
    return mods[kind][0 if port else 1].IndexParams(**kw)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint8"])
@pytest.mark.parametrize("storage", ["hbm", "tiered"])
def test_plan_equals_jax(kind, streamed, dtype, storage):
    for kw in _PLAN_PARAMS[kind]:
        for rows, dim, cr in ((100_000, 16, 8192), (1_000_000, 128, None), (5000, 96, 1 << 20)):
            args = dict(dtype=dtype, storage=storage, streamed=streamed, chunk_rows=cr)
            got = mem.plan(kind, _params(kind, kw), rows, dim, **args)
            want = jmem.plan(kind, _params(kind, kw, port=False), rows, dim, **args)
            assert got == want, (kind, kw, rows, dim, args)


def test_plan_refusals():
    with pytest.raises(RaftError, match="unknown index kind"):
        mem.plan("nope", None, 10, 10)
    with pytest.raises(RaftError, match="rows > 0"):
        mem.plan("brute_force", None, 0, 10)
    with pytest.raises(RaftError, match="unknown dtype"):
        mem.plan("brute_force", None, 10, 10, dtype="float64")
    with pytest.raises(RaftError, match="storage"):
        mem.plan("brute_force", None, 10, 10, storage="disk")
    # a tier policy is taken as the JAX plan takes it (duck-typed on
    # disk_path), not refused
    for tier in (object(), type("Disk", (), {"disk_path": "/x"})()):
        for storage in ("hbm", "tiered"):
            assert (mem.plan("ivf_pq", None, 1000, 16, storage=storage, tier=tier)
                    == jmem.plan("ivf_pq", None, 1000, 16, storage=storage, tier=tier))


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq"])
def test_plan_within_20pct_of_the_built_index_at_100k(kind):
    """tests/test_obs_mem.py's accuracy bar on the port's own builds: the
    planned index bytes against the built index's tensor bytes."""
    n, d = 100_000, 16
    kw = _PLAN_PARAMS[kind][0]
    x = np.random.default_rng(0).random((n, d), dtype=np.float32)
    idx = _port_build(kind, x, **(kw or {}))
    measured = sum(t.numel() * t.element_size() for t in _tensors(idx).values())
    est = mem.plan(kind, _params(kind, kw), n, d)["index_bytes"]
    assert abs(est - measured) <= 0.20 * measured, (kind, est, measured)


def test_plan_cagra_exact_and_within_20pct_at_100k():
    """A CAGRA index's tensors are shape-exact (dataset + graph): the real
    build at 2k against the plan exactly, and the 100k layout through the
    ledger hook."""
    kw = _PLAN_PARAMS["cagra"][0]
    x = np.random.default_rng(0).random((2048, 16), dtype=np.float32)
    small = cagra.build(cagra.IndexParams(**kw), x, res=CPU)
    assert mem.plan("cagra", _params("cagra", kw), 2048, 16)["index_bytes"] == \
        sum(t.numel() * t.element_size() for t in _tensors(small).values())
    big = cagra.CagraIndex(dataset=torch.rand((100_000, 16)),
                           graph=torch.zeros((100_000, 16), dtype=torch.int32))
    tok = mem.account_index(big, name="plan_cagra_100k")
    try:
        entry = [r for r in mem.breakdown() if r["name"] == "plan_cagra_100k"][0]
        est = mem.plan("cagra", _params("cagra", kw), 100_000, 16)["index_bytes"]
        assert abs(est - entry["device_bytes"]) <= 0.20 * entry["device_bytes"]
    finally:
        mem.release(tok)


def test_plan_streamed_within_20pct_of_the_ledger_peak_at_100k():
    """The streamed IVF-Flat build's ledger peak (staged chunks + the
    scatter's accumulators and label / id vectors) against
    plan(streamed=True) at 100k rows."""
    n, d, cr = 100_000, 16, 8192
    params = ivf_flat.IndexParams(n_lists=256, kmeans_n_iters=4)
    x = np.random.default_rng(1).random((n, d), dtype=np.float32)
    est = mem.plan("ivf_flat", params, n, d, streamed=True, chunk_rows=cr)
    assert est["host_peak_bytes"] > 0
    gc.collect()
    baseline = mem.totals()["device_bytes"]
    mem.reset_peak()
    ivf_flat.build(params, chunked.ChunkedReader(x, chunk_rows=cr), res=CPU)
    measured = mem.totals()["device_peak_bytes"] - baseline
    assert measured > 0
    assert abs(est["build_peak_bytes"] - measured) <= 0.20 * measured, (est, measured)


# -- (d) budgets ---------------------------------------------------------------------------

def _jax_build(kind, x, res, **p):
    if kind == "brute_force":
        return jbf.BruteForce().build(x, res)
    mod = {"ivf_flat": jflat, "ivf_pq": jpq, "cagra": jcagra}[kind]
    return mod.build(mod.IndexParams(**p), x, res=res)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("budget", ["device", "host"])
def test_armed_budget_refuses_a_streamed_build_before_any_chunk(kind, budget):
    """A 1 KiB budget refuses the streamed build at build_stream (device)
    or build_stream/host, with the JAX build's numbers, before the trainer
    or any chunk spends: no chunk counted, no staging entry, no device
    bytes accounted."""
    x = _corpus(4000, 16, np.float32)
    key = "memory_budget_bytes" if budget == "device" else "host_budget_bytes"
    p = dict(PARAMS[kind], n_lists=16) if kind.startswith("ivf") else PARAMS[kind]
    with pytest.raises(JMemoryBudgetError) as jexc:
        _jax_build(kind, jch.ChunkedReader(x, chunk_rows=1000), JResources(**{key: 1 << 10}),
                   **p)
    gc.collect()
    dev0, chunks0, staging0 = mem.totals()["device_bytes"], _chunks_total(), len(_staging_entries())
    with pytest.raises(MemoryBudgetError) as exc:
        _port_build(kind, chunked.ChunkedReader(x, chunk_rows=1000),
                    Resources(device="cpu", **{key: 1 << 10}), **p)
    got, want = exc.value, jexc.value
    site = "build_stream" if budget == "device" else "build_stream/host"
    assert (got.site, got.need_bytes, got.budget_bytes) == \
        (want.site, want.need_bytes, want.budget_bytes)
    assert got.site == site and got.need_bytes > 1 << 10
    assert mem.totals()["device_bytes"] == dev0
    assert _chunks_total() == chunks0 and len(_staging_entries()) == staging0


@pytest.mark.parametrize("kind", KINDS)
def test_roomy_budgets_admit_a_streamed_build(kind):
    x = _corpus(800 if kind == "cagra" else 3000, 16, np.float32)
    roomy = Resources(device="cpu", memory_budget_bytes=mem.totals()["device_bytes"] + (1 << 30),
                      host_budget_bytes=mem.totals()["host_bytes"] + (1 << 30))
    p = dict(PARAMS[kind], n_lists=16) if kind.startswith("ivf") else PARAMS[kind]
    _assert_bit_equal(_port_build(kind, x, **p),
                      _port_build(kind, chunked.ChunkedReader(x, chunk_rows=700), roomy, **p))


def test_gate_host_and_gate_host_bytes_as_jax():
    """gate(host_bytes=) and gate_host refuse with the JAX gate's site and
    numbers; zero host need admits; an unarmed host budget is one check."""
    for gate_mod, res_cls, err in ((mem, Resources, MemoryBudgetError),
                                   (jmem, JResources, JMemoryBudgetError)):
        used = gate_mod.totals()["host_bytes"]
        res = (res_cls(device="cpu", host_budget_bytes=used + 100) if res_cls is Resources
               else res_cls(host_budget_bytes=used + 100))
        gate_mod.gate(res, 1 << 40, site="x")            # no device budget armed
        gate_mod.gate(res, 0, site="x", host_bytes=0)
        gate_mod.gate_host(res, 100, site="y")
        with pytest.raises(err) as exc:
            gate_mod.gate(res, 0, site="x", host_bytes=lambda: 101)
        assert (exc.value.site, exc.value.need_bytes, exc.value.budget_bytes) == \
            ("x/host", 101, used + 100)
        with pytest.raises(err) as exc:
            gate_mod.gate_host(res, 101, site="y", detail="tier")
        assert exc.value.site == "y/host" and "(tier)" in str(exc.value)
    unarmed = Resources(device="cpu")
    mem.gate_host(unarmed, 1 << 60, site="z")


def test_armed_host_budget_without_observability_raises():
    from raft_tpu.core.errors import RaftError as JRaftError

    for mod, gate_mod, res, err in (
            (metrics, mem, Resources(device="cpu", host_budget_bytes=1 << 40), RaftError),
            (jmetrics, jmem, JResources(host_budget_bytes=1 << 40), JRaftError)):
        mod.disable()
        try:
            for fn in (lambda: gate_mod.gate(res, 0, site="s", host_bytes=1),
                       lambda: gate_mod.gate_host(res, 1, site="s")):
                with pytest.raises(err, match="observability is disabled"):
                    fn()
        finally:
            mod.enable()


# -- (e) no kernel build on a second streamed build -----------------------------------------

def test_second_streamed_build_builds_nothing():
    x = _corpus(8000, 16, np.float32)
    params = ivf_pq.IndexParams(n_lists=32, pq_dim=4, seed=2)
    reader = chunked.ChunkedReader(x, chunk_rows=2000)
    first = ivf_pq.build(params, reader, res=CPU)
    with obs_compile.attribution() as rec:
        second = ivf_pq.build(params, reader, res=CPU)
    assert rec.programs == 0 and rec.cache_misses == 0, rec.summary()
    _assert_bit_equal(first, second, "(streamed rebuild determinism)")


# -- the stream layer --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ivf_flat", "brute_force"])
def test_compact_rebuild_takes_ooc_chunk_rows(kind):
    """The out-of-core rebuild fold equals the in-core fold, bit for bit."""
    rng = np.random.default_rng(2)
    data = rng.standard_normal((2500, 16)).astype(np.float32)
    extra = rng.standard_normal((50, 16)).astype(np.float32)
    params = ivf_flat.IndexParams(n_lists=16, seed=2) if kind == "ivf_flat" else None

    def make(name):
        sealed = (ivf_flat.build(params, data, res=CPU) if params is not None
                  else brute_force.BruteForce().build(data, CPU))
        m = stream.MutableIndex(sealed, dataset=data, index_params=params, name=name)
        m.upsert(extra)
        m.delete(np.arange(10))
        return m

    a, b = make(f"ooc_cmp_a_{kind}"), make(f"ooc_cmp_b_{kind}")
    ra = a.compact(mode="rebuild")
    rb = b.compact(mode="rebuild", ooc_chunk_rows=777)
    assert ra["mode"] == rb["mode"] == "rebuild"
    _assert_bit_equal(a._state.sealed, b._state.sealed, "(rebuild compact via reader)")
    q = data[:5]
    assert torch.equal(a.search(q, 5)[1], b.search(q, 5)[1])


def test_compact_ooc_chunk_rows_requires_rebuild():
    data = _corpus(2000, 16, np.float32)
    params = ivf_flat.IndexParams(n_lists=16, seed=4)
    m = stream.MutableIndex(ivf_flat.build(params, data, res=CPU), dataset=data,
                            index_params=params, name="ooc_mode_guard")
    with pytest.raises(RaftError, match="REBUILD"):
        m.compact(mode="extend", ooc_chunk_rows=512)


def test_mutable_over_a_reader_keeps_the_memmap(tmp_path):
    """dataset= a reader: the row store is the reader's backing memmap (no
    copy into memory), and a rebuild fold reads it."""
    x = _corpus(3000, 16, np.float32)
    reader = _reader(x, tmp_path, 700)
    params = ivf_pq.IndexParams(n_lists=16, pq_dim=4, seed=1)
    m = stream.MutableIndex(ivf_pq.build(params, reader, res=CPU), dataset=reader,
                            index_params=params, name="ooc_reader_store")
    assert isinstance(m._state.store, np.memmap)
    m.delete(np.arange(5))
    rep = m.compact(mode="rebuild", ooc_chunk_rows=1000)
    assert rep["mode"] == "rebuild" and m._state.sealed.size == 2995
    assert m.search(x[10:14], 5)[1].shape == (4, 5)


# -- @instrument -----------------------------------------------------------------------------

SITES = [(brute_force, "knn"), (ivf_flat, "build"), (ivf_flat, "extend"),
         (ivf_flat, "search"), (ivf_pq, "build"), (ivf_pq, "extend"), (ivf_pq, "search"),
         (cagra, "build"), (cagra, "search")]


def test_instrumented_entry_points():
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.distance import pairwise
    from raft_tpu_torch.matrix import select_k

    fns = [getattr(m, f) for m, f in SITES] + [
        select_k, pairwise.pairwise_distance, kmeans.fit, kmeans.predict]
    assert len(fns) == 13
    assert all(hasattr(fn, "__wrapped__") for fn in fns)


def _call_series(snap, op):
    series = snap.get("raft_tpu_call_seconds", {"series": []})["series"]
    return [s for s in series if s["labels"]["op"] == op]


def test_instrument_metrics_match_jax(jax_streamed):
    """The same three metric names, op labels and per-op label keys as the
    JAX package's decorator, for an IVF-Flat build and search and a knn
    (at the JAX fixture's shapes, whose programs that fixture compiled)."""
    x = _corpus(6000, 32, np.float32, seed=11)
    q = x[:7]
    metrics.reset()
    jmetrics.reset()
    tix = ivf_flat.build(ivf_flat.IndexParams(n_lists=32, seed=3), x, res=CPU)
    ivf_flat.search(ivf_flat.SearchParams(n_probes=4), tix, q, 5)
    brute_force.knn(x, q, 3, res=CPU)
    jix = jflat.build(jflat.IndexParams(n_lists=32, seed=3), jch.ChunkedReader(x, chunk_rows=1500))
    jflat.search(jflat.SearchParams(n_probes=4), jix, jnp.asarray(q), 5)
    jbf.knn(x, q, 3)
    snap, jsnap = metrics.snapshot(), jmetrics.snapshot()
    for name in ("raft_tpu_call_seconds", "raft_tpu_call_compile_seconds",
                 "raft_tpu_items_total"):
        assert name in snap and snap[name]["type"] == jsnap[name]["type"], name
    for op in ("ivf_flat.build", "ivf_flat.search", "brute_force.knn"):
        got, want = _call_series(snap, op), _call_series(jsnap, op)
        assert [s["labels"] for s in got] == [s["labels"] for s in want], op
    items = {s["labels"]["op"]: s["value"] for s in snap["raft_tpu_items_total"]["series"]}
    jitems = {s["labels"]["op"]: s["value"] for s in jsnap["raft_tpu_items_total"]["series"]}
    assert items == jitems == {"ivf_flat.build": 6000, "ivf_flat.search": 7,
                               "brute_force.knn": 7}


def test_instrument_passes_through_when_disabled():
    from raft_tpu_torch.obs.instrument import dtype_of, instrument, nrows

    calls = []

    @instrument("t.op", items=lambda a, kw: 1 / 0, labels=lambda a, kw: 1 / 0)
    def op(a, b=2):
        calls.append((a, b))
        return a + b

    metrics.reset()
    obs.disable()
    try:
        assert op(1, b=5) == 6
        assert not _call_series(metrics.snapshot(), "t.op")
    finally:
        obs.enable()
    assert op(2) == 4                      # raising hooks drop labels, never the call
    assert calls == [(1, 5), (2, 2)] and op.__name__ == "op"
    assert [s["labels"] for s in _call_series(metrics.snapshot(), "t.op")] == [{"op": "t.op"}]
    assert (nrows(np.zeros((3, 2))), nrows([1, 2]), nrows(np.float32(1))) == (3, 2, 1)
    assert dtype_of(torch.zeros(1, dtype=torch.int8)) == dtype_of(np.zeros(1, np.int8)) == "int8"
