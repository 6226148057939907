"""raft_tpu_torch.stream.tiered against raft_tpu.stream.tiered (tier-1
``tiering`` marker).

The contracts of tests/test_tiered.py at its small size (2,048 x 16, chunks
of 512 rows), on the port, each held against the JAX package where the two
can meet:

- **bit parity** between a tiered twin and an all-HBM twin: ``search`` and
  ``search_refined`` on ids and distances before and after one upsert /
  delete / compact script, for float32, uint8 and int8; the chunked
  oracle's ids always, and its distances bit for bit where each chunk takes
  the fused route (d >= 64, chunks >= 4,096 rows). On the GEMM route (d =
  16) the distances are held to 1e-6 of the expanded-L2 scale: a float32
  sum there may depend on how many rows one product holds, which is the
  reference's own failing test (pinned below);
- **JAX against the port**: a JAX-built IVF-PQ index loaded into the port,
  the JAX and port tiered indexes over the same rows and script return
  equal ids, distances within the stream tests' tolerance; ``fetch`` and
  the oracle chunks equal the JAX store's bit for bit; ``plan()``,
  ``tier_bytes()``, the host gate's refusal and the residency moves give
  the JAX module's numbers; tiered files are byte for byte JAX's and each
  side loads the other's, ``raft_tpu/11`` files included;
- spill / promote, the hit-rate promote, the ``tier/fetch`` fault recovered
  by WAL replay, compaction carrying residency and retiring the old store,
  the disk tier's epoch files, memmap adoption, the ``tiers`` debug
  section, constant slot bytes across refine cycles.

Everything runs on the CPU (the port's kernels on their plain versions);
torch runs on one thread, as in the other files that build indexes.
"""

import gc
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import stream as js
from raft_tpu.core import serialize as jser
from raft_tpu.core.chunked import ChunkedReader as JReader
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import mem as jmem
from raft_tpu.stream import TieredStore as JStore
from raft_tpu.stream import TierPolicy as JPolicy
from raft_tpu_torch import stream
from raft_tpu_torch.core import RaftError, Resources, chunked
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.obs import mem
from raft_tpu_torch.serve.errors import MemoryBudgetError
from raft_tpu_torch.stream import TieredStore, TierPolicy
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.tiering

CPU = Resources(device="cpu")
N, D = 2048, 16
PARAMS = ivf_pq.IndexParams(n_lists=32, pq_bits=4, pq_dim=8, seed=0)
JPARAMS = jpq.IndexParams(n_lists=32, pq_bits=4, pq_dim=8, seed=0)
SP = ivf_pq.SearchParams(n_probes=8)
JSP = jpq.SearchParams(n_probes=8)
POLICY = TierPolicy(oracle_chunk=512, auto_promote=False)
JPOL = JPolicy(oracle_chunk=512, auto_promote=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Q = rng.standard_normal((32, D)).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def jsealed(corpus, tmp_path_factory):
    """(JAX-built sealed index, the path of its file)."""
    X, _ = corpus
    path = str(tmp_path_factory.mktemp("tiered") / "pq.bin")
    j = jpq.build(JPARAMS, jnp.asarray(X))
    jpq.save(j, path)
    return j, path


def _wrap(path, X, storage, name, **kw):
    kw.setdefault("tier", POLICY if storage == "tiered" else None)
    return stream.MutableIndex(ivf_pq.load(path, res=CPU), search_params=SP,
                               index_params=PARAMS, dataset=X, storage=storage,
                               name=name, **kw)


def _jwrap(j, X, storage, name, **kw):
    kw.setdefault("tier", JPOL if storage == "tiered" else None)
    return js.MutableIndex(j, search_params=JSP, index_params=JPARAMS, dataset=X,
                           storage=storage, name=name, **kw)


def _churn(m, d=D, dtype=np.float32, rng_seed=3):
    """tests/test_tiered.py's script, for every dtype."""
    r = np.random.default_rng(rng_seed)

    def rows(n):
        if dtype == np.float32:
            return r.standard_normal((n, d)).astype(np.float32)
        lo, hi = (0, 255) if dtype == np.uint8 else (-127, 127)
        return r.integers(lo, hi, (n, d)).astype(dtype)

    m.upsert(rows(24), ids=np.arange(50_000, 50_024))
    m.delete([1, 7, 50_003])
    m.compact()
    m.upsert(rows(8), ids=np.arange(60_000, 60_008))
    m.delete([60_001, 2])


def _bits(a, b, what):
    assert torch.equal(a[1], b[1]), f"{what}: ids diverge"
    assert torch.equal(a[0], b[0]), f"{what}: distances diverge"


def _close(t, j, q, rtol, what):
    """Ids equal; distances within ``rtol`` of the expanded-L2 scale
    ``|d| + |q|^2`` (tests/test_torch_stream.py's ``_assert_same``)."""
    ti, td = np.asarray(t[1]), np.asarray(t[0])
    ji, jd = np.asarray(j[1]), np.asarray(j[0])
    np.testing.assert_array_equal(ti, ji, err_msg=what)
    scale = np.abs(jd) + (q.astype(np.float64) ** 2).sum(1, keepdims=True)
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td)), what
    err = np.abs(td.astype(np.float64) - jd)[fin] / scale[fin]
    assert err.max(initial=0.0) <= rtol, (what, err.max())


# -- bit parity with the all-HBM twin ----------------------------------------------

def _byte_corpus(dtype, n=1024):
    r = np.random.default_rng(11)
    lo, hi = (0, 255) if dtype == "uint8" else (-127, 127)
    X = r.integers(lo, hi, (n, D)).astype(dtype)
    Q = r.integers(lo, hi, (16, D)).astype(dtype)
    return X, Q


@pytest.mark.parametrize("dtype", ["float32", "uint8", "int8"])
def test_tiered_vs_hbm_bit_parity(jsealed, corpus, dtype):
    """Same script, two storage policies: ``search`` and ``search_refined``
    equal bit for bit before and after the churn (through a compaction),
    the oracle's ids equal; the fold keeps the store tiered and cold."""
    if dtype == "float32":
        X, Q = corpus
        a = _wrap(jsealed[1], X, "hbm", "par_hbm")
        b = _wrap(jsealed[1], X, "tiered", "par_tiered")
        k, dt = 10, np.float32
    else:
        X, Q = _byte_corpus(dtype)
        p = ivf_pq.IndexParams(n_lists=16, pq_bits=4, pq_dim=8, seed=0)
        idx = ivf_pq.build(p, X, res=CPU)
        a = stream.MutableIndex(idx, search_params=SP, index_params=p, dataset=X,
                                name=f"pb_hbm_{dtype}")
        b = stream.MutableIndex(idx, search_params=SP, index_params=p, dataset=X,
                                storage="tiered", tier=POLICY, name=f"pb_tier_{dtype}")
        k, dt = 5, np.dtype(dtype).type
    assert b.tiered_store.residency == "host"
    _bits(a.search_refined(Q, k, 4), b.search_refined(Q, k, 4), "refined pre-churn")
    _churn(a, dtype=dt)
    _churn(b, dtype=dt)
    _bits(a.search(Q, k), b.search(Q, k), "search post-churn")
    _bits(a.search_refined(Q, k, 4), b.search_refined(Q, k, 4), "refined post-churn")
    ea, eb = a.exact_search(Q, k), b.exact_search(Q, k)
    assert torch.equal(ea[1], eb[1]), "oracle ids"
    assert isinstance(b._state.store, TieredStore)
    assert b.tiered_store.residency == "host" and b.tiered_store._epoch == 1


@pytest.mark.parametrize("route", ["fused", "gemm"])
def test_oracle_distances_by_route(route):
    """The chunked oracle against the whole-store scan. On the fused route
    (d = 64, chunks of 4,096 rows: ``brute_force._fused_eligible``) each
    pair's sum does not depend on how many rows a launch holds, so the
    distances are bit for bit. On the GEMM route (d = 16, chunks of 512)
    the ids are equal and the distances held to 1e-6 of the expanded-L2
    scale: a float32 GEMM's sums may depend on the operand's row count (the
    reference's failure, ``test_reference_oracle_ids_equal``)."""
    from raft_tpu_torch.neighbors.brute_force import _fused_eligible
    from raft_tpu_torch.distance.types import DistanceType

    d, n, chunk = (64, 12_000, 4096) if route == "fused" else (16, 2048, 512)
    assert _fused_eligible(DistanceType.L2Expanded, 10, chunk, d, "exact",
                           "float32") == (route == "fused")
    r = np.random.default_rng(5)
    X = r.standard_normal((n, d)).astype(np.float32)
    Q = r.standard_normal((24, d)).astype(np.float32)
    p = ivf_pq.IndexParams(n_lists=16, pq_bits=4, pq_dim=16, seed=0)
    idx = ivf_pq.build(p, X, res=CPU)
    a = stream.MutableIndex(idx, search_params=SP, dataset=X, name=f"rt_hbm_{route}")
    b = stream.MutableIndex(idx, search_params=SP, dataset=X, storage="tiered",
                            tier=TierPolicy(oracle_chunk=chunk, auto_promote=False),
                            name=f"rt_tier_{route}")
    a.delete([0, 4097, n - 1])
    b.delete([0, 4097, n - 1])
    assert b.tiered_store.n_oracle_chunks() == -(-n // chunk)
    ea, eb = a.exact_search(Q, 10), b.exact_search(Q, 10)
    assert torch.equal(ea[1], eb[1])
    if route == "fused":
        assert torch.equal(ea[0], eb[0])
    else:
        _close(eb, ea, Q, 1e-6, "gemm-route oracle")


# -- the reference and the port against it ------------------------------------------

@pytest.fixture(scope="module")
def jax_script(jsealed, corpus):
    """The JAX package's tiered and all-HBM twins through the script, as
    tests/test_tiered.py runs them (its oracle fails there on distances)."""
    X, Q = corpus
    j = jsealed[0]
    out = {}
    for storage in ("tiered", "hbm"):
        m = _jwrap(j, X, storage, f"jref_{storage}")
        pre = m.search_refined(jnp.asarray(Q), 10, 4)
        _churn(m)
        out[storage] = {
            "pre": tuple(np.asarray(a) for a in pre),
            "search": tuple(np.asarray(a) for a in m.search(jnp.asarray(Q), 10)),
            "refined": tuple(np.asarray(a) for a in m.search_refined(jnp.asarray(Q), 10, 4)),
            "exact": tuple(np.asarray(a) for a in m.exact_search(jnp.asarray(Q), 10)),
            "residency": m.tiered_store.residency if storage == "tiered" else None,
            "stats": m.stats()}
    return out


def test_reference_oracle_ids_equal(jax_script):
    """tests/test_tiered.py::test_tiered_vs_hbm_bit_parity_f32 fails on the
    oracle's distances only: the JAX tiered twin scans the cold store in
    chunks of 512 rows, the all-HBM twin all 2,048 in one GEMM, and at d = 16
    both take XLA's GEMM route, whose float32 sums depend on the operand's
    shape. Its ids are equal, and ``search`` / ``search_refined`` are bit
    for bit. The port holds the same (``test_tiered_vs_hbm_bit_parity``,
    ``test_oracle_distances_by_route``): ids and the serving paths bit for
    bit, and the oracle's distances bit for bit on the fused route."""
    t, h = jax_script["tiered"], jax_script["hbm"]
    for key in ("pre", "search", "refined"):
        assert np.array_equal(t[key][0], h[key][0]), key
        assert np.array_equal(t[key][1], h[key][1]), key
    assert np.array_equal(t["exact"][1], h["exact"][1])
    np.testing.assert_allclose(t["exact"][0], h["exact"][0], rtol=1e-5, atol=1e-5)


def test_port_tiered_matches_jax_tiered(jsealed, corpus, jax_script):
    """The JAX tiered index and the port's over the same JAX-built index,
    rows and script: ids equal, distances within the stream tests'
    tolerance (1e-4 of the scale on the PQ search, 1e-5 on the exact
    ones), the same stats and the same residency."""
    X, Q = corpus
    m = _wrap(jsealed[1], X, "tiered", "port_vs_jax")
    want = jax_script["tiered"]
    _close(m.search_refined(Q, 10, 4), want["pre"], Q, 1e-5, "refined pre-churn")
    _churn(m)
    _close(m.search(Q, 10), want["search"], Q, 1e-4, "search")
    _close(m.search_refined(Q, 10, 4), want["refined"], Q, 1e-5, "refined")
    _close(m.exact_search(Q, 10), want["exact"], Q, 1e-5, "oracle")
    got = dict(m.stats())
    ref = dict(want["stats"])
    got.pop("delta_oldest_at"), ref.pop("delta_oldest_at")
    assert got == ref
    assert m.tiered_store.residency == want["residency"] == "host"


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_fetch_and_oracle_chunks_equal_jax(dtype):
    """``fetch`` is a gather: the port's equals the JAX store's bit for bit,
    padding slots (-1) included; so do the oracle chunks, the padded last
    one and its ``valid`` count included."""
    r = np.random.default_rng(2)
    n = 1000
    X = (r.standard_normal((n, D)).astype(np.float32) if dtype == "float32"
         else r.integers(0, 255, (n, D)).astype(np.uint8))
    slots = r.integers(-1, n, (9, 7)).astype(np.int32)
    ts = TieredStore(X, name=f"fetch_{dtype}", policy=POLICY, device="cpu")
    jt = JStore(X, name=f"fetch_{dtype}", policy=JPOL)
    got = ts.fetch(torch.from_numpy(slots))
    assert got.dtype == torch.from_numpy(X).dtype and got.shape == (9, 7, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt.fetch(jnp.asarray(slots))))
    assert ts.n_oracle_chunks() == jt.n_oracle_chunks() == 2
    for ci in range(2):
        dv, base, valid = ts.oracle_chunk_dev(ci)
        jv, jbase, jvalid = jt.oracle_chunk_dev(ci)
        assert (base, valid) == (jbase, jvalid)
        np.testing.assert_array_equal(dv.numpy(), np.asarray(jv))
    assert ts.tier_bytes() == jt.tier_bytes()
    keep = ("rows", "dim", "dtype", "residency", "tier_bytes", "rows_fetched",
            "h2d_bytes", "spills", "promotes")
    assert {k: ts.stats()[k] for k in keep} == {k: jt.stats()[k] for k in keep}
    # the CPU store reads the slots where they are: no host sync counted
    assert ts.stats()["host_syncs"] == 0


# -- residency moves ------------------------------------------------------------------

def _moves(make, led, R, X):
    """One sequence of residency moves; the budgets are relative to each
    package's own ledger. Returns what each step answered."""
    ts = make(X, name="moves")
    out = [ts.residency, ts.promote(force=True), ts.mirror_resident]
    out.append(ts.spill(reason="explicit"))
    used = led.totals()["device_bytes"]
    out += [ts.promote(res=R(used + ts.row_bytes // 2)),
            ts.promote(res=R(used + 2 * ts.row_bytes)), ts.residency,
            ts.spill(reason="pressure"), ts.residency]
    st = ts.stats()
    out += [st["spills"], st["promotes"], [(e["event"], e["reason"]) for e in st["events"]]]
    return out


def test_residency_moves_match_jax(corpus):
    """promote / spill / the budget's headroom answer as the JAX store's,
    with the same counts and event trail."""
    from raft_tpu.core.resources import Resources as JRes

    X, _ = corpus
    got = _moves(lambda x, **kw: TieredStore(x, device="cpu", policy=POLICY, **kw), mem,
                 lambda b: Resources(device="cpu", memory_budget_bytes=b), X)
    want = _moves(lambda x, **kw: JStore(x, policy=JPOL, **kw), jmem,
                  lambda b: JRes(memory_budget_bytes=b), X)
    assert got == want
    assert got[:4] == ["host", True, True, X.nbytes]


def test_spill_through_the_gate_then_promote(jsealed, corpus):
    """A budget squeeze spills the mirror through the gate's pressure
    handler (the upsert is admitted, not refused), as the JAX index does;
    headroom promotes it back; the answers never change."""
    from raft_tpu.core.resources import Resources as JRes

    X, Q = corpus
    m = _wrap(jsealed[1], X, "tiered", "squeeze")
    jm = _jwrap(jsealed[0], X, "tiered", "squeeze")
    hbm = _wrap(jsealed[1], X, "hbm", "squeeze_twin")
    rows = np.zeros((16, D), np.float32)
    for mut, led, R in ((m, mem, lambda b: Resources(device="cpu", memory_budget_bytes=b)),
                        (jm, jmem, lambda b: JRes(memory_budget_bytes=b))):
        ts = mut.tiered_store
        assert ts.promote(force=True) and ts.mirror_resident
        dev_with_mirror = led.totals()["device_bytes"]
        mut.upsert(rows, ids=np.arange(70_000, 70_016), res=R(dev_with_mirror + 1))
        assert not ts.mirror_resident
        assert ts.stats()["spills"] == 1
        assert ts.stats()["events"][-1]["reason"] == "pressure"
        assert led.totals()["device_bytes"] < dev_with_mirror - ts.row_bytes // 2
    hbm.upsert(rows, ids=np.arange(70_000, 70_016))
    _bits(hbm.search_refined(Q, 10, 4), m.search_refined(Q, 10, 4), "post-spill")
    ts = m.tiered_store
    assert not ts.promote(res=Resources(device="cpu", memory_budget_bytes=(
        mem.totals()["device_bytes"] + ts.row_bytes // 2)))
    assert ts.promote(res=Resources(device="cpu", memory_budget_bytes=(
        mem.totals()["device_bytes"] + 2 * ts.row_bytes)))
    _bits(hbm.search_refined(Q, 10, 4), m.search_refined(Q, 10, 4), "post-promote")
    assert mem.headroom(Resources(device="cpu", memory_budget_bytes=1 << 40))[
        "spillable_bytes"] >= ts.row_bytes


def test_hit_rate_auto_promote(corpus):
    """``promote_min_hits`` cold fetches under an armed budget with headroom
    lift the mirror; with no budget the store stays cold. The JAX store
    answers the same fetches the same way."""
    from raft_tpu.core.resources import Resources as JRes

    X, _ = corpus
    slots = np.arange(64, dtype=np.int32).reshape(8, 8)
    pol = dict(oracle_chunk=512, promote_min_hits=2)
    out = []
    for store, led, R, sl in (
            (TieredStore(X, name="auto", policy=TierPolicy(**pol), device="cpu"), mem,
             lambda b: Resources(device="cpu", memory_budget_bytes=b), torch.from_numpy(slots)),
            (JStore(X, name="auto", policy=JPolicy(**pol)), jmem,
             lambda b: JRes(memory_budget_bytes=b), jnp.asarray(slots))):
        for _ in range(4):
            store.fetch(sl)
        cold = store.mirror_resident
        roomy = R(led.totals()["device_bytes"] + 2 * store.row_bytes)
        store.fetch(sl, res=roomy)
        store.fetch(sl, res=roomy)
        out.append((cold, store.mirror_resident, store.stats()["events"][-1]["reason"],
                    store.stats()["rows_fetched"]))
    assert out[0] == out[1] == (False, True, "hit-rate", 6 * 64)


def test_tier_fetch_crash_recovers_via_wal(jsealed, corpus, tmp_path):
    """A crash at the ``tier/fetch`` fault point recovers through load() and
    WAL replay with the uncrashed twin's answers, still tiered."""
    X, Q = corpus
    snap, wal = str(tmp_path / "t.idx"), str(tmp_path / "t.wal")
    m = _wrap(jsealed[1], X, "tiered", "crash", wal=wal, snapshot_path=snap)
    stream.save(m, snap)
    m.upsert(np.ones((4, D), np.float32), ids=[90_000, 90_001, 90_002, 90_003])
    m.delete([90_001, 5])
    with faults.scope():
        faults.inject("tier/fetch", exc=faults.SimulatedCrash("die"))
        with pytest.raises(faults.SimulatedCrash):
            m.search_refined(Q, 10, 4)
        assert faults.fired("tier/fetch") == 1
    del m
    gc.collect()
    twin = _wrap(jsealed[1], X, "tiered", "crash_twin")
    twin.upsert(np.ones((4, D), np.float32), ids=[90_000, 90_001, 90_002, 90_003])
    twin.delete([90_001, 5])
    rec = stream.load(snap, search_params=SP, wal=wal, tier=POLICY, res=CPU)
    assert rec.last_recovery["replayed"] == 2
    assert rec.storage == "tiered" and rec.tiered_store is not None
    _bits(twin.search_refined(Q, 10, 4), rec.search_refined(Q, 10, 4), "recovered refined")
    _bits(twin.search(Q, 10), rec.search(Q, 10), "recovered search")


def test_compaction_migrates_residency_and_retires_old_store(jsealed, corpus):
    """The fold carries residency to the successor's store and retires the
    predecessor's ledger entry, which frees once nothing holds the old
    epoch; the JAX index carries the same residency."""
    X, _ = corpus
    res = []
    for mut in (_wrap(jsealed[1], X, "tiered", "fold"), _jwrap(jsealed[0], X, "tiered", "fold")):
        assert mut.tiered_store.promote(force=True)
        mut.upsert(np.zeros((4, D), np.float32), ids=[80_000, 80_001, 80_002, 80_003])
        mut.compact()
        res.append((mut.tiered_store._epoch, mut.tiered_store.residency,
                    mut.tiered_store.shape))
    assert res[0] == res[1] == (1, "device", (N + 4, D))
    gc.collect()
    leaks = [r for r in mem.audit(collect=True)["retired_unfreed"] if r["component"] == "tier"]
    assert not leaks, leaks


def test_oracle_and_refine_keep_device_bytes_constant(jsealed, corpus):
    """Once a shape's ring holds ``fetch_slots`` uploads, refine cycles past
    it and chunked oracle passes add no device bytes (the ring replaces, the
    accounted slot bytes stay), no lazy full copy is made, and the rows are
    accounted once, under the tier entry."""
    X, Q = corpus
    m = _wrap(jsealed[1], X, "tiered", "const")
    rep = m.warm_refined([Q.shape[0]], ks=(10,), refine_ratio=4)
    assert rep[10][Q.shape[0]]["wall_s"] >= 0.0
    m.search_refined(Q, 10, 4)      # the warm call made the ring's first slot
    m.exact_search(Q, 10)
    before = mem.totals()["device_bytes"]
    slots = m.tiered_store.tier_bytes()["device"]
    for _ in range(4):
        m.search_refined(Q, 10, 4)
    for _ in range(2):
        m.exact_search(Q, 10)
    assert mem.totals()["device_bytes"] == before
    assert m.tiered_store.tier_bytes()["device"] == slots > 0
    assert m._state.store_dev is None
    tier = [r for r in mem.breakdown() if r["component"] == "tier" and r["name"] == "const"]
    assert len(tier) == 1 and tier[0]["host_bytes"] >= X.nbytes
    st = [r for r in mem.breakdown() if r["component"] == "stream" and r["name"] == "const"]
    assert st and st[0]["host_bytes"] < X.nbytes


def test_refined_hook_pins_its_epoch(jsealed, corpus):
    X, Q = corpus
    m = _wrap(jsealed[1], X, "tiered", "pinned_hook")
    hook = m.refined_searcher(refine_ratio=4)
    before = hook(Q, 10)[1].clone()
    m.upsert(np.full((4, D), 7.0, np.float32), ids=[95_000, 95_001, 95_002, 95_003])
    m.compact()
    assert torch.equal(hook(Q, 10)[1], before)
    assert m.tiered_store._epoch == 1
    assert torch.equal(m.refined_searcher(4)(Q, 10)[1], m.search_refined(Q, 10, 4)[1])


# -- cold tiers and files ---------------------------------------------------------------

def test_disk_tier_epoch_files(jsealed, corpus, tmp_path):
    """``TierPolicy(disk_path=)`` keeps the rows in an epoch file (the JAX
    store's file, byte for byte), prices 0 host bytes, answers as the HBM
    twin, and a fold's successor writes ``.e1`` while the collected
    predecessor's ``.e0`` is unlinked."""
    X, Q = corpus
    pol = TierPolicy(disk_path=str(tmp_path / "cold"), oracle_chunk=512, auto_promote=False)
    m = stream.MutableIndex(ivf_pq.load(jsealed[1], res=CPU), search_params=SP, dataset=X,
                            storage="tiered", tier=pol, name="cold_store")
    ts = m.tiered_store
    assert ts.residency == "disk"
    assert ts.tier_bytes() == {"device": 0, "host": 0, "disk": X.nbytes}
    entry = [r for r in mem.breakdown() if r["component"] == "tier"
             and r["name"] == "cold_store"][0]
    assert entry["host_bytes"] == 0
    jt = JStore(X, name="cold_store", policy=JPolicy(disk_path=str(tmp_path / "jcold")))
    with open(ts._disk_file, "rb") as a, open(jt._disk_file, "rb") as b:
        assert a.read() == b.read()
    assert os.path.basename(ts._disk_file) == "cold.cold_store.e0"
    hbm = _wrap(jsealed[1], X, "hbm", "cold_twin")
    _bits(hbm.search_refined(Q, 10, 4), m.search_refined(Q, 10, 4), "disk refined")
    f0 = ts._disk_file
    del ts
    m.compact()
    assert m.tiered_store._disk_file.endswith(".e1")
    gc.collect()
    assert not os.path.exists(f0)
    assert os.path.exists(m.tiered_store._disk_file)


def test_mmap_adoption(tmp_path):
    """tests/test_ooc_build.py:328's contract: ``MutableIndex(dataset=reader,
    storage="tiered")`` over a ``.npy`` memmap adopts the mapping in place
    (residency "disk", 0 host and device bytes), as the JAX index does, and
    the refine hop serves off it as the all-HBM twin."""
    r = np.random.default_rng(4)
    n, d = 4000, 24
    data = r.standard_normal((n, d)).astype(np.float32)
    path = tmp_path / "corpus.npy"
    np.save(path, data)
    reader = chunked.ChunkedReader.from_file(path, chunk_rows=900)
    params = ivf_pq.IndexParams(n_lists=16, seed=1)
    sealed = ivf_pq.build(params, reader, res=CPU)
    mi = stream.MutableIndex(sealed, dataset=reader, index_params=params,
                             storage="tiered", name="adopt")
    ts = mi.tiered_store
    assert ts.host_view() is reader.host_view()
    jt = JStore(JReader.from_file(path, chunk_rows=900).host_view(), name="adopt")
    assert ts.residency == jt.residency == "disk"
    assert ts.tier_bytes() == jt.tier_bytes() == {"device": 0, "host": 0, "disk": n * d * 4}
    twin = stream.MutableIndex(sealed, dataset=data, index_params=params, name="adopt_twin")
    _bits(twin.search_refined(data[:8], 5, 4), mi.search_refined(data[:8], 5, 4), "adopted")


@pytest.mark.parametrize("residency", ["device", "host"])
def test_tiered_files_are_jax_files(jsealed, corpus, tmp_path, residency):
    """A tiered index saved by the port is the JAX file of the same state,
    byte for byte; each side loads the other's file tiered, with the saved
    residency restored without deciding again (one placement promote for a
    device layout, no event for a cold one)."""
    X, Q = corpus
    m = _wrap(jsealed[1], X, "tiered", "layout")
    jm = _jwrap(jsealed[0], X, "tiered", "layout")
    for mut in (m, jm):
        mut.upsert(np.full((3, D), 0.5, np.float32), ids=[7_000, 7_001, 7_002])
        mut.delete([4])
        if residency == "device":
            assert mut.tiered_store.promote(force=True)
    p, jp = str(tmp_path / "port.idx"), str(tmp_path / "jax.idx")
    stream.save(m, p)
    js.save(jm, jp)
    with open(p, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    rec = stream.load(jp, search_params=SP, tier=POLICY, res=CPU)
    jrec = js.load(p, search_params=JSP, tier=JPOL)
    for r in (rec, jrec):
        assert r.storage == "tiered" and r.tiered_store.residency == residency
        ev = [e["event"] for e in r.tiered_store.stats()["events"]]
        assert ev == (["promote"] if residency == "device" else [])
    _bits(m.search_refined(Q, 10, 4), rec.search_refined(Q, 10, 4), "reloaded")
    _close(rec.search_refined(Q, 10, 4), jrec.search_refined(jnp.asarray(Q), 10, 4), Q, 1e-5,
           "JAX-loaded port file")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serialize_11_files_load_as_hbm(jsealed, corpus, tmp_path, monkeypatch, writer):
    """A ``raft_tpu/11`` file (no tier fields) loads as ``storage="hbm"`` on
    either side, whoever wrote it; ``tier=`` on such a file is refused as in
    the JAX package."""
    X, Q = corpus
    path = str(tmp_path / "v11.idx")
    if writer == "jax":
        jm = _jwrap(jsealed[0], X, "hbm", "compat")
        monkeypatch.setattr(jser, "SERIALIZATION_VERSION", "raft_tpu/11")
        js.save(jm, path)
    else:
        m = _wrap(jsealed[1], X, "hbm", "compat")
        monkeypatch.setattr(tser, "SERIALIZATION_VERSION", "raft_tpu/11")
        stream.save(m, path)
    monkeypatch.undo()
    with open(path, "rb") as f:
        assert b"raft_tpu/11" in f.read(64)
    rec = stream.load(path, search_params=SP, res=CPU)
    jrec = js.load(path, search_params=JSP)
    assert rec.storage == jrec.storage == "hbm" and rec.tiered_store is None
    _close(rec.search(Q, 10), jrec.search(jnp.asarray(Q), 10), Q, 1e-4, "/11 search")
    with pytest.raises(RaftError, match="applies to storage='tiered' only"):
        stream.load(path, search_params=SP, res=CPU, tier=POLICY)


# -- plan, the host gate, the debug section ---------------------------------------------

@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq", "cagra"])
@pytest.mark.parametrize("cold", ["host", "disk", "duck"])
def test_plan_per_tier_equals_jax(kind, cold, tmp_path):
    """``plan(storage="tiered", tier=)`` gives the JAX plan's numbers: the
    rows on the host tier, or on the disk tier when the policy has a
    ``disk_path`` (any object with one, as in JAX); the host figure equals
    a store's measured ledger bytes."""
    tier = {"host": (None, None),
            "disk": (TierPolicy(disk_path=str(tmp_path / "x")),
                     JPolicy(disk_path=str(tmp_path / "x"))),
            "duck": (object(), object())}[cold]
    for dtype in ("float32", "uint8"):
        got = mem.plan(kind, None, 5000, 96, dtype=dtype, storage="tiered", tier=tier[0])
        want = jmem.plan(kind, None, 5000, 96, dtype=dtype, storage="tiered", tier=tier[1])
        assert got == want
        where = "disk" if cold == "disk" else "host"
        assert got["tiers"][where] == 5000 * 96 * np.dtype(dtype).itemsize
    X = np.zeros((300, 96), np.float32)
    ts = TieredStore(X, name=f"plan_probe_{kind}_{cold}", device="cpu")
    entry = [r for r in mem.breakdown() if r["component"] == "tier"
             and r["name"] == f"plan_probe_{kind}_{cold}"][0]
    assert entry["host_bytes"] == mem.plan(kind, None, 300, 96, storage="tiered")["tiers"]["host"]
    del ts


def test_host_budget_gate_equals_jax(corpus, tmp_path):
    """``Resources.host_budget_bytes`` refuses a RAM store as the JAX gate
    does (site, need and budget against each package's own ledger), and a
    disk-backed store prices nothing against it."""
    from raft_tpu.core.resources import Resources as JRes
    from raft_tpu.serve.errors import MemoryBudgetError as JMBE

    X, _ = corpus
    errs = []
    for make, led, R, E in ((lambda **kw: TieredStore(X, device="cpu", **kw), mem,
                             lambda b: Resources(device="cpu", host_budget_bytes=b),
                             MemoryBudgetError),
                            (lambda **kw: JStore(X, **kw), jmem,
                             lambda b: JRes(host_budget_bytes=b), JMBE)):
        used = led.totals()["host_bytes"]
        res = R(used + X.nbytes // 2)
        with pytest.raises(E) as ei:
            make(name="hb_refused", res=res)
        errs.append((ei.value.site, ei.value.need_bytes, ei.value.budget_bytes - used,
                     ei.value.accounted_bytes - used))
        ts = make(name="hb_disk", res=res, policy=type(POLICY if E is MemoryBudgetError
                                                     else JPOL)(disk_path=str(tmp_path / "c")))
        assert ts.residency == "disk"
    assert errs[0] == errs[1] == ("tier/host", X.nbytes, X.nbytes // 2, 0)


def test_debug_mem_tiers_section(jsealed, corpus):
    """The ledger's debug payload carries the ``tiers`` section: per-store
    residency, tier bytes and the spill / promote trail, with the JAX
    store's keys (the port adds ``host_syncs`` and ``gather_wall_s``)."""
    X, _ = corpus
    m = _wrap(jsealed[1], X, "tiered", "dbg")
    ts = m.tiered_store
    ts.promote(force=True)
    ts.spill()
    payload = mem.debug_payload()
    mine = [s for s in payload["tiers"]["stores"] if s["name"] == "dbg"]
    assert mine and mine[0]["residency"] == "host"
    assert [e["event"] for e in mine[0]["events"]] == ["promote", "spill"]
    assert payload["tiers"]["totals"].get("host", 0) >= X.nbytes
    jt = JStore(X, name="dbg_keys")
    assert set(mine[0]) == set(jt.stats()) | {"host_syncs", "gather_wall_s"}
    assert set(jmem.debug_payload()["tiers"]) == set(payload["tiers"])


def test_tier_policy_checks_match_jax():
    for kw in (dict(oracle_chunk=12), dict(oracle_chunk=4), dict(fetch_slots=1)):
        with pytest.raises(RaftError) as e:
            TierPolicy(**kw)
        with pytest.raises(Exception) as je:
            JPolicy(**kw)
        assert str(e.value) == str(je.value)
    assert TierPolicy() == TierPolicy(None, 8192, 2, 3, True)
    with pytest.raises(RaftError, match="residency must be one of"):
        TieredStore(np.zeros((4, 2), np.float32), residency="tape", device="cpu")
    with pytest.raises(RaftError, match="stores the raw refine rows cold"):
        stream.MutableIndex(ivf_pq.build(PARAMS, np.zeros((64, D), np.float32) + np.arange(
            64, dtype=np.float32)[:, None], res=CPU), storage="tiered")
