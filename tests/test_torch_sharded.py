"""raft_tpu_torch.stream.sharded / replicated against raft_tpu.stream (tier-1
``stream`` marker).

The cases of tests/test_stream_sharded.py and of the ReplicatedShard section
of tests/test_faults.py at their sizes (260 x 16, 256 x 16), on the port,
each held against the JAX package where the two meet:

- ``shard_of`` equals the JAX function bit for bit on random and extreme
  int64 ids;
- a 1-shard mesh equals a plain ``MutableIndex`` bit for bit (ids and
  distances) under the same write script;
- the port's brute-force mesh and the JAX mesh return equal ids under one
  write script (distances within the stream tests' expanded-L2 tolerance);
- multi-shard search, the exact oracle, hash routing, cross-shard
  whole-or-nothing admission, the staggered compactor (fill, age and
  tombstone picks), the service's write path over a mesh (held against the
  JAX service's answers), a swap under load, the recall canary, per-shard
  request-log spans, gauges, the drift sample and an int8 mesh;
- replica groups: lockstep twins, same-call failover, the breaker, probes
  and backoff, slow strikes on an injected clock, stale twins, the
  structured all-out error, group admission, the group WAL and its
  rollback, and a replicated mesh with one dead twin.

Every shard is unpinned or on the CPU: the tests make no virtual devices.
torch runs on one thread, as in the other files that build indexes.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import stream as js
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.serve import SearchService as JService
from raft_tpu_torch import stream
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.serve import ReplicaUnavailableError, SearchService
from raft_tpu_torch.stream import (FencingPolicy, MutableIndex, ReplicatedShard,
                                   ShardedMutableIndex)
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.stream

CPU = Resources(device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    leaked = faults.armed()
    faults.clear()
    assert not leaked, "test left faults armed"


@pytest.fixture
def data(rng):
    return rng.standard_normal((260, 16)).astype(np.float32)


@pytest.fixture
def queries(rng):
    return rng.standard_normal((5, 16)).astype(np.float32)


def bf_build(x):
    return brute_force.BruteForce().build(x, res=CPU)


def jbf_build(x):
    return jbf.BruteForce().build(jnp.asarray(x))


def sharded_bf(data, n_shards, **kw):
    return ShardedMutableIndex(data, n_shards=n_shards, build=bf_build, **kw)


def truth_gids(live_mat, live_gids, q, k):
    """Exact neighbours of ``q`` among the live rows, in float64, as global
    ids (ties to the lower row)."""
    d2 = ((q.astype(np.float64)[:, None] - live_mat.astype(np.float64)[None]) ** 2).sum(-1)
    pos = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.asarray(live_gids)[pos]


def assert_same(td, ti, jd, ji, q, rtol=1e-5):
    """Ids equal; distances within ``rtol`` of the expanded-L2 scale
    ``|d| + |q|^2`` (tests/test_torch_stream.py's rule)."""
    ti, td = np.asarray(ti), np.asarray(td)
    ji, jd = np.asarray(ji), np.asarray(jd)
    np.testing.assert_array_equal(ti, ji)
    scale = np.abs(jd) + (q.astype(np.float64) ** 2).sum(1, keepdims=True)
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td))
    err = np.abs(td.astype(np.float64) - jd)[fin] / scale[fin]
    assert err.max(initial=0.0) <= rtol, err.max()


# -- routing ------------------------------------------------------------------

def test_shard_of_stable_and_balanced():
    ids = np.arange(100_000)
    s1 = stream.shard_of(ids, 8)
    np.testing.assert_array_equal(s1, stream.shard_of(ids, 8))
    counts = np.bincount(s1, minlength=8)
    assert counts.min() > 0.8 * counts.mean(), counts
    assert counts.max() < 1.2 * counts.mean(), counts
    assert set(np.unique(stream.shard_of(ids[:100], 3))) <= {0, 1, 2}
    # a tensor routes as its values
    np.testing.assert_array_equal(stream.shard_of(torch.arange(1000), 5),
                                  stream.shard_of(np.arange(1000), 5))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8, 64, 1000])
def test_shard_of_equals_jax_bit_for_bit(n_shards):
    r = np.random.default_rng(n_shards)
    ids = np.concatenate([
        r.integers(0, 2 ** 63 - 1, 20_000, dtype=np.int64),
        r.integers(-2 ** 63, 0, 2_000, dtype=np.int64),
        np.array([0, 1, -1, 2 ** 31 - 1, 2 ** 31, 2 ** 32, 2 ** 63 - 1, -2 ** 63],
                 np.int64)])
    got, want = stream.shard_of(ids, n_shards), js.shard_of(ids, n_shards)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_constructor_validations(data):
    with pytest.raises(RaftError, match="fewer shards"):
        sharded_bf(data[:4], 16)
    with pytest.raises(RaftError, match="n_shards"):
        sharded_bf(data, 0)
    with pytest.raises(RaftError, match="devices"):
        sharded_bf(data, 4, devices=["cpu", "cpu"])
    # comms= (here a stand-in for a communicator of one rank) and devices=
    # name the same thing: one of them at a time; each rank of a larger
    # communicator would build every shard
    with pytest.raises(RaftError, match="not both"):
        sharded_bf(data, 2, comms=SimpleNamespace(devices=["cpu"], size=lambda: 1),
                   devices=["cpu", "cpu"])
    with pytest.raises(RaftError, match="one rank, got 2"):
        sharded_bf(data, 2, comms=SimpleNamespace(devices=["cpu"] * 2, size=lambda: 2))
    with pytest.raises(RaftError, match="ids= must match"):
        sharded_bf(data, 2, ids=np.arange(5))


# -- the parity spine ---------------------------------------------------------

def test_one_shard_parity_bitequal(data, queries, rng):
    """The same write script on a 1-shard mesh and a plain MutableIndex:
    equal ids AND distances, bit for bit, at every step."""
    clock = FakeClock()
    plain = MutableIndex(bf_build(data), delta_capacity=64, clock=clock)
    shard = sharded_bf(data, 1, delta_capacity=64, clock=clock)

    def check():
        for fn in ("search", "exact_search"):
            dp, ip = getattr(plain, fn)(queries, 10)
            ds, is_ = getattr(shard, fn)(queries, 10)
            assert torch.equal(ip, is_) and torch.equal(dp, ds), fn

    check()
    ins = rng.standard_normal((12, 16)).astype(np.float32)
    g1 = plain.upsert(ins)
    g2 = shard.upsert(ins)
    np.testing.assert_array_equal(g1, g2)
    check()
    for m in (plain, shard):
        m.delete([3, 17, int(g1[4]), 9999])
    check()
    for m in (plain, shard):
        rep = m.compact(mode="rebuild")
        assert rep["reclaimed"] == 2 and rep["folded"] == 11
    check()
    g3, g4 = plain.upsert(ins[:2] + 1.0), shard.upsert(ins[:2] + 1.0)
    np.testing.assert_array_equal(g3, g4)
    check()
    assert plain.size == shard.size


def test_multi_shard_search_matches_fresh_build_and_jax(data, queries, rng):
    """4 hash-routed shards, upserts and deletes: the port's mesh returns the
    ids of an exact search over exactly the live rows, and the JAX mesh's
    ids under the same script."""
    shard = sharded_bf(data, 4, delta_capacity=64)
    jshard = js.ShardedMutableIndex(data, n_shards=4, build=jbf_build, delta_capacity=64)
    sizes = [sh._state.id_map.shape[0] for sh in shard.shards]
    assert sum(sizes) == len(data) and len(set(sizes)) > 1, sizes
    assert sizes == [sh._state.id_map.shape[0] for sh in jshard.shards]
    ins = rng.standard_normal((20, 16)).astype(np.float32)
    gids = shard.upsert(ins)
    np.testing.assert_array_equal(gids, jshard.upsert(ins))
    dele = [3, 17, 44, 101, int(gids[4])]
    assert shard.delete(dele) == 5 == jshard.delete(dele)
    live_mask = np.ones(len(data), bool)
    live_mask[[3, 17, 44, 101]] = False
    ins_mask = np.ones(20, bool)
    ins_mask[4] = False
    live_mat = np.concatenate([data[live_mask], ins[ins_mask]])
    live_g = np.concatenate([np.nonzero(live_mask)[0], np.asarray(gids)[ins_mask]])
    d, got = shard.search(queries, 10)
    np.testing.assert_array_equal(got.numpy(), truth_gids(live_mat, live_g, queries, 10))
    assert got.dtype == torch.int32 and d.dtype == torch.float32
    assert_same(d, got, *jshard.search(queries, 10), queries)
    assert_same(*shard.exact_search(queries, 10), *jshard.exact_search(queries, 10), queries)
    assert shard.size == len(live_g) == jshard.size


def test_uneven_tiny_corpus_underfill_sentinels(rng):
    data = rng.standard_normal((24, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    shard = sharded_bf(data, 3, delta_capacity=8)
    shard.delete(np.arange(20))  # 4 live rows remain
    d, i = shard.search(q, 10)
    d, i = d.numpy(), i.numpy()
    assert (i[:, 4:] == -1).all() and np.isinf(d[:, 4:]).all()
    assert (i[:, :4] >= 0).all() and np.isfinite(d[:, :4]).all()


def test_exact_search_matches_brute_force(data, queries, rng):
    shard = sharded_bf(data, 4, delta_capacity=32)
    gids = shard.upsert(rng.standard_normal((8, 16)).astype(np.float32))
    shard.delete([0, 1, int(gids[0])])
    mats, gs = [], []
    for sh in shard.shards:
        st = sh._state
        alive = np.nonzero(st.sealed_alive)[0]
        mats.append(st.store[alive])
        gs.append(st.id_map[alive])
        dal = np.nonzero(st.delta_alive[:st.delta_n])[0]
        mats.append(st.delta[dal])
        gs.append(st.delta_ids[dal])
    live_mat = np.concatenate([m for m in mats if len(m)])
    live_g = np.concatenate([g for g in gs if len(g)])
    _, got = shard.exact_search(queries, 10)
    np.testing.assert_array_equal(got.numpy(), truth_gids(live_mat, live_g, queries, 10))


# -- writes -------------------------------------------------------------------

def test_upsert_routes_by_hash_and_read_your_writes(data, queries):
    shard = sharded_bf(data, 4, delta_capacity=32)
    g = shard.upsert(queries[0:1] + 1e-3)
    home = int(stream.shard_of(g, 4)[0])
    assert shard.shards[home].stats()["delta_rows"] == 1
    assert all(sh.stats()["delta_rows"] == 0
               for s, sh in enumerate(shard.shards) if s != home)
    _, ids = shard.search(queries, 5)
    assert int(ids[0, 0]) == int(g[0])
    far = (queries[0:1] * 0.0) + 100.0
    shard.upsert(far, ids=[int(g[0])])
    _, ids2 = shard.search(queries, 5)
    assert int(g[0]) != int(ids2[0, 0])
    assert shard.size == len(data) + 1


def test_upsert_atomic_across_shards(data):
    """Whole-or-nothing admission: a batch that would overflow ONE home
    shard is refused before any row lands anywhere; so is one the summed
    memory budget refuses."""
    from raft_tpu_torch.serve.errors import MemoryBudgetError

    shard = sharded_bf(data, 2, delta_capacity=8)
    cand = np.arange(10_000, 30_000)
    homes = stream.shard_of(cand, 2)
    to0, to1 = cand[homes == 0], cand[homes == 1]
    shard.upsert(np.zeros((7, 16), np.float32) + 0.5, ids=to0[:7])
    before = shard.stats()["delta_rows"]
    mixed = np.concatenate([to0[7:9], to1[:3]])
    with pytest.raises(stream.DeltaFullError, match="shard 0"):
        shard.upsert(np.ones((5, 16), np.float32), ids=mixed)
    assert shard.stats()["delta_rows"] == before
    with pytest.raises(MemoryBudgetError):
        shard.upsert(np.ones((3, 16), np.float32), ids=to1[:3],
                     res=Resources(device="cpu", memory_budget_bytes=1))
    assert shard.stats()["delta_rows"] == before
    shard.upsert(np.ones((3, 16), np.float32), ids=to1[:3])


# -- staggered compaction -----------------------------------------------------

def test_staggered_compaction_folds_one_shard_at_a_time(data, queries, rng):
    clock = FakeClock()
    shard = sharded_bf(data, 4, delta_capacity=16, clock=clock)
    comp = stream.Compactor(
        shard, policy=stream.CompactionPolicy(delta_fill=0.5, tombstone_ratio=None),
        clock=clock)
    assert comp.due() is None
    ins = rng.standard_normal((40, 16)).astype(np.float32)
    gids = shard.upsert(ins)
    folded = []
    while comp.due():
        rep = comp.run_once()
        assert rep["trigger"] == "delta_fill"
        folded.append(rep["shard"])
        assert rep["shard_epoch"] == 1
    assert len(folded) >= 2 and len(set(folded)) == len(folded)
    assert shard.stats()["epoch"] == len(folded)
    live_g = np.concatenate([np.arange(len(data)), gids])
    live_mat = np.concatenate([data, ins])
    _, got = shard.search(queries, 10)
    np.testing.assert_array_equal(got.numpy(), truth_gids(live_mat, live_g, queries, 10))


def test_age_trigger_folds_the_stalest_shard_not_the_fullest(data):
    clock = FakeClock()
    shard = sharded_bf(data, 4, delta_capacity=16, clock=clock)
    comp = stream.Compactor(
        shard, policy=stream.CompactionPolicy(delta_fill=None, tombstone_ratio=None,
                                              max_age_s=5.0), clock=clock)
    cand = np.arange(10_000, 40_000)
    homes = stream.shard_of(cand, 4)
    quiet, busy = cand[homes == 1], cand[homes == 3]
    shard.upsert(np.zeros((1, 16), np.float32), ids=quiet[:1])
    clock.advance(3.0)
    shard.upsert(np.ones((5, 16), np.float32), ids=busy[:5])
    clock.advance(2.5)
    assert comp.due() == "age"
    rep = comp.run_once()
    assert rep["shard"] == 1 and rep["folded"] == 1, rep
    assert comp.due() is None
    clock.advance(3.0)
    assert comp.due() == "age"
    assert comp.run_once()["shard"] == 3


def test_tombstone_watermark_picks_dirtiest_shard(data):
    clock = FakeClock()
    shard = sharded_bf(data, 4, delta_capacity=16, clock=clock)
    victim = 2
    vic_ids = shard.shards[victim]._state.id_map
    shard.delete(vic_ids[:len(vic_ids) // 3 + 1])
    comp = stream.Compactor(
        shard, policy=stream.CompactionPolicy(delta_fill=None, tombstone_ratio=0.25),
        clock=clock)
    assert comp.due() == "tombstone_ratio"
    rep = comp.run_once()
    assert rep["shard"] == victim and rep["mode"] == "rebuild"
    assert rep["reclaimed"] == len(vic_ids) // 3 + 1
    assert comp.due() is None
    with pytest.raises(RaftError, match="out of range"):
        shard.compact(shard=4)


# -- serve --------------------------------------------------------------------

def test_serve_publish_resolves_sharded_duck_typed(data, queries):
    """SearchService.publish of a mesh opens the write path; the served
    answers equal the JAX service's over the JAX mesh under the same
    writes; a hook republish keeps the write path open."""
    clock = FakeClock()
    shard = sharded_bf(data, 3, delta_capacity=16, clock=clock)
    jshard = js.ShardedMutableIndex(data, n_shards=3, build=jbf_build, delta_capacity=16,
                                    clock=clock)
    svc = SearchService(max_batch=4, clock=clock, start_workers=False)
    jsvc = JService(max_batch=4, clock=clock, start_workers=False)
    assert svc.publish("mesh", shard, k=5)["version"] == 1
    jsvc.publish("mesh", jshard, k=5)
    g = svc.upsert("mesh", queries[0:1] + 1e-3)
    np.testing.assert_array_equal(g, jsvc.upsert("mesh", queries[0:1] + 1e-3))
    fut, jfut = svc.submit("mesh", queries[:3], 5), jsvc.submit("mesh", queries[:3], 5)
    clock.advance(1.0)
    svc.pump()
    jsvc.pump()
    got, want = fut.result(timeout=0), jfut.result(timeout=0)
    assert int(got[1][0, 0]) == int(g[0])
    assert_same(*got, *want, queries[:3])
    assert svc.delete("mesh", g) == 1 == jsvc.delete("mesh", g)
    svc.publish("mesh", shard.searcher(), k=5)
    svc.upsert("mesh", queries[1:2])
    assert shard.stats()["delta_rows"] == 2
    with pytest.raises(RaftError, match="wrap time"):
        svc.publish("mesh2", shard, search_params=object(), warm=False)
    svc.shutdown()
    jsvc.shutdown()


def test_swap_under_load_on_one_shard_loses_nothing(data):
    """A compaction swap of ONE shard landing mid-load (reads and writes on
    every shard) fails no request and loses no write."""
    shard = sharded_bf(data, 4, delta_capacity=64, name="load")
    svc = SearchService(max_batch=8, max_wait_us=200.0, max_queue_rows=512)
    svc.publish("load", shard, k=5)
    shard.warm(svc.buckets, ks=(5,))
    comp = stream.Compactor(
        shard, publisher=svc, name="load", ks=(5,),
        policy=stream.CompactionPolicy(delta_fill=0.125, tombstone_ratio=None))
    errors, done = [], []
    lock = threading.Lock()

    def reader(tid):
        for j in range(25):
            lo = (tid * 31 + j) % 200
            try:
                _, ids = svc.search("load", data[lo:lo + 1], 5)
                with lock:
                    done.append((lo, int(ids[0, 0])))
            except Exception as e:
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    swaps, written = 0, []
    for step in range(30):
        written.append(svc.upsert("load", data[step % 100:step % 100 + 2] + 0.5))
        while comp.due():
            comp.run_once()
            swaps += 1
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "reader wedged"
    svc.shutdown()
    assert errors == []
    assert len(done) == 100
    assert all(lo == top for lo, top in done)       # each row finds itself
    assert swaps >= 2 and shard.stats()["epoch"] == swaps
    assert sum(sh.stats()["epoch"] for sh in shard.shards) == swaps
    assert shard.size == len(data) + 60
    _, ids = shard.search(data[:2] + 0.5, 2)
    assert {int(written[0][0]), int(written[0][1])} <= set(ids.numpy().ravel().tolist())


def test_device_list_places_shards_and_moves_nothing_resident(data, queries):
    """``devices=`` puts shard s on devices[s] (here every device is the
    CPU); parts already on the merge device do not move."""
    from raft_tpu_torch.obs import requestlog

    shard = sharded_bf(data, 4, devices=["cpu"] * 4, delta_capacity=16)
    assert [sh.device for sh in shard.shards] == [torch.device("cpu")] * 4
    assert [sh._state.sealed.dataset.device for sh in shard.shards] == [torch.device("cpu")] * 4
    with requestlog.collect() as c:
        d, i = shard.search(data[:3], 5)
    assert tuple(i.shape) == (3, 5) and c.notes["stream_moved_parts"] == 0
    plain = sharded_bf(data, 4, delta_capacity=16)
    assert torch.equal(plain.search(queries, 5)[1], shard.search(queries, 5)[1])


def test_warm_ladder_keeps_sharded_hot_path_build_free(data, queries):
    """After warm() and publish, searches at every delta fill level, the
    writes between them and a staggered fold with its republish build no
    kernel (``obs.compile`` attribution; on the CPU the plain versions
    build nothing, on the card this is the kernel-build count)."""
    from raft_tpu_torch.obs import compile as obs_compile

    clock = FakeClock()

    def run(name):
        shard = sharded_bf(data, 2, delta_capacity=16, clock=clock, name=name)
        svc = SearchService(max_batch=4, clock=clock, start_workers=False)
        svc.publish(name, shard, k=5)
        rep = shard.warm(svc.buckets, ks=(5,))
        assert sorted(rep[5]) == sorted(svc.buckets)
        comp = stream.Compactor(
            shard, publisher=svc, name=name, ks=(5,),
            policy=stream.CompactionPolicy(delta_fill=0.5, tombstone_ratio=None),
            clock=clock)
        folds = 0
        for step in range(24):
            shard.upsert(data[step:step + 1] + 0.5, ids=[1000 + step])
            while comp.due():
                comp.run_once()
                folds += 1
            fut = svc.submit(name, queries[:2], 5)
            clock.advance(1.0)
            svc.pump()
            fut.result(timeout=0)
        svc.shutdown()
        return folds

    assert run("rehearsal") >= 2
    with obs_compile.attribution() as rec:
        run("live")
    assert rec.compile_s == 0.0 and rec.programs == 0


def test_canary_oracle_covers_the_mesh(data):
    from raft_tpu_torch.obs import quality
    from raft_tpu_torch.serve import bucket_sizes

    clock = FakeClock()
    shard = sharded_bf(data, 3, delta_capacity=16, clock=clock)
    canary = quality.RecallCanary(quality.exact_oracle(shard), k=5, sample_rate=1.0,
                                  buckets=bucket_sizes(4), name="mesh")
    svc = SearchService(max_batch=4, clock=clock, start_workers=False, canary=canary)
    svc.publish("mesh", shard, k=5)
    for lo in range(0, 12, 4):
        fut = svc.submit("mesh", data[lo:lo + 4], 5)
        clock.advance(1.0)
        svc.pump()
        fut.result(timeout=0)
    canary.drain()
    est = canary.estimate()
    assert est["reranked"] > 0
    assert est["recall"] == 1.0, est
    svc.shutdown()


def test_requestlog_per_shard_spans(data, queries):
    from raft_tpu_torch.obs import requestlog

    shard = sharded_bf(data, 2, delta_capacity=16)
    with requestlog.collect() as c:
        shard.search(queries, 5)
    for s in range(2):
        assert f"stream/shard{s}/stream/sealed" in c.spans, c.spans
        assert f"stream/shard{s}/stream/delta" in c.spans, c.spans
        assert c.notes[f"stream/shard{s}/stream_epoch"] == 0
    assert "stream/merge" in c.spans
    assert c.notes["stream_shards"] == 2 and c.notes["stream_moved_parts"] == 0


def test_sharded_stats_and_gauges(data):
    from raft_tpu_torch.obs import metrics

    shard = sharded_bf(data, 4, delta_capacity=16, name="gauges")
    shard.upsert(data[:3] + 0.5)
    st = shard.stats()
    assert st["shards"] == 4 and len(st["per_shard"]) == 4
    assert st["delta_rows"] == 3
    assert st["live"] == len(data) + 3
    assert st["delta_fill"] == max(p["delta_fill"] for p in st["per_shard"])
    snap = metrics.to_json()
    assert snap.get('raft_tpu_stream_shards{name="gauges"}') == 4
    assert 'raft_tpu_stream_delta_rows{name="gauges"}' in snap
    assert any(k.startswith('raft_tpu_stream_delta_rows{name="gauges/shard')
               for k in snap), [k for k in snap if "gauges" in k]


def test_shard_ledger_attribution(data):
    """Each shard's bytes land in the obs.mem ledger under its ordinal."""
    from raft_tpu_torch.obs import mem as obs_mem

    shard = sharded_bf(data, 3, delta_capacity=16, name="ledger")
    rows = [r for r in obs_mem.breakdown() if r["name"].startswith("ledger/shard")]
    want = {(f"ledger/shard{s}", s) for s in range(3)}
    assert {(r["name"], r["shard"]) for r in rows if r["component"] == "stream"} == want
    assert {(r["name"], r["shard"]) for r in rows
            if r["component"].startswith("index/")} == want
    assert shard.n_shards == 3


def test_drift_store_interleaves_shards(data):
    shard = sharded_bf(data, 4, delta_capacity=16)
    store = shard._drift_store()
    assert store is not None and store.shape == (len(data), 16)
    assert sharded_bf(data, 2, delta_capacity=16, retain_vectors=False)._drift_store() is None


def test_byte_sharded_index(rng):
    xb = rng.integers(-128, 128, (180, 16), dtype=np.int8)
    shard = ShardedMutableIndex(
        xb, n_shards=2, delta_capacity=16,
        build=lambda x: ivf_flat.build(
            ivf_flat.IndexParams(n_lists=4, list_dtype="int8", seed=0), x, res=CPU),
        search_params=ivf_flat.SearchParams(n_probes=16))
    assert shard.query_dtype == "int8"
    with pytest.raises(RaftError, match="int8"):
        shard.upsert(np.zeros((1, 16), np.float32))
    q = xb[:3]
    g = shard.upsert(q[0:1])
    _, ids = shard.search(q, 3)
    assert int(g[0]) in set(ids[0].tolist())


# -- ReplicatedShard (tests/test_faults.py's replica section) ----------------

@pytest.fixture
def rdata(rng):
    return rng.standard_normal((256, 16)).astype(np.float32)


@pytest.fixture
def rqueries(rng):
    return rng.standard_normal((6, 16)).astype(np.float32)


def group(data, clock, *, n_replicas=2, policy=None, **kw):
    return ReplicatedShard(
        bf_build(data), n_replicas=n_replicas, delta_capacity=64,
        policy=policy or FencingPolicy(max_consecutive=1, backoff_s=5.0),
        clock=clock, name="g", **kw)


def test_replicas_lockstep_and_r1_parity(rdata, rqueries, rng):
    clock = FakeClock()
    g = group(rdata, clock)
    single = MutableIndex(bf_build(rdata), delta_capacity=64)
    rows = rng.standard_normal((8, 16)).astype(np.float32)
    np.testing.assert_array_equal(g.upsert(rows), single.upsert(rows))
    g.delete([1, 2])
    single.delete([1, 2])
    assert [r.size for r in g.replicas] == [single.size, single.size]
    dg, ig = g.search(rqueries, 10)
    ds, is_ = single.search(rqueries, 10)
    assert torch.equal(ig, is_) and torch.equal(dg, ds)
    de, ie = g.exact_search(rqueries, 10)
    assert torch.equal(ie, single.exact_search(rqueries, 10)[1])
    assert g.searcher().device == torch.device("cpu")


def test_read_failover_same_call(rdata, rqueries):
    clock = FakeClock()
    g = group(rdata, clock)
    want = g.search(rqueries, 5)[1]
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"),
                      match=lambda c: c["replica"].endswith("/r0"))
        got = g.search(rqueries, 5)[1]
        assert faults.fired("replica/search") >= 1
    assert torch.equal(got, want)
    r0 = next(r for r in g.health()["replicas"] if r["replica"].endswith("/r0"))
    assert r0["fenced"] and not r0["stale"]
    assert "FaultError" in r0["last_error"]


def test_breaker_opens_after_consecutive_strikes(rdata, rqueries):
    clock = FakeClock()
    g = group(rdata, clock, policy=FencingPolicy(max_consecutive=2, backoff_s=5.0))
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"),
                      match=lambda c: c["replica"].endswith("/r0"))
        while g._health[0].consecutive < 1:
            g.search(rqueries, 5)
        assert g.health()["healthy"] == 2
        while g._health[0].consecutive < 2:
            g.search(rqueries, 5)
        assert g.health()["healthy"] == 1
        n = faults.fired("replica/search")
        g.search(rqueries, 5)
        assert faults.fired("replica/search") == n


def test_probe_heals_and_failed_probe_doubles_backoff(rdata, rqueries):
    clock = FakeClock()
    g = group(rdata, clock)
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"),
                      match=lambda c: c["replica"].endswith("/r0"))
        while g._health[0].fenced_until is None:
            g.search(rqueries, 5)
        assert g._health[0].fenced_until == pytest.approx(5.0)
        clock.advance(6.0)
        g.search(rqueries, 5)
        assert g._health[0].fenced_until == pytest.approx(6.0 + 10.0)
    clock.advance(11.0)
    g.search(rqueries, 5)
    assert g.health()["healthy"] == 2
    assert g._health[0].backoff == 5.0


def test_wedged_replica_slow_strike_no_wall_sleep(rdata, rqueries):
    clock = FakeClock()
    g = group(rdata, clock, policy=FencingPolicy(deadline_s=0.5, max_consecutive=1,
                                                 backoff_s=5.0))
    want = g.search(rqueries, 5)[1]
    with faults.scope():
        faults.inject("replica/search", callback=lambda c: clock.advance(10.0), times=1)
        got = g.search(rqueries, 5)[1]
    assert torch.equal(got, want)
    assert sum(1 for r in g.health()["replicas"] if r["fenced"]) == 1


def test_write_failure_marks_stale_not_lost(rdata, rng):
    clock = FakeClock()
    g = group(rdata, clock)
    rows = rng.standard_normal((4, 16)).astype(np.float32)
    with faults.scope():
        faults.inject("replica/upsert", exc=faults.FaultError("dev fault"),
                      match=lambda c: c["replica"].endswith("/r1"), times=1)
        gids = g.upsert(rows)
    assert g.stats()["stale"] == 1
    assert g.replicas[0].size == rdata.shape[0] + 4
    _, ids = g.search(rows[:1], 1)
    assert int(ids[0, 0]) == int(gids[0])
    g.upsert(rng.standard_normal((2, 16)).astype(np.float32))
    assert g.replicas[0].size == g.replicas[1].size + 6
    clock.advance(100.0)
    assert g.stats()["stale"] == 1 and g.stats()["healthy"] == 1


def test_all_replicas_out_raises_structured(rdata, rqueries):
    clock = FakeClock()
    g = group(rdata, clock)
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"))
        with pytest.raises(ReplicaUnavailableError) as ei:
            g.search(rqueries, 5)
    assert ei.value.name == "g" and ei.value.replicas == 2
    assert ei.value.fenced == 2
    assert isinstance(ei.value.__cause__, faults.FaultError)
    clock.advance(6.0)
    assert tuple(g.search(rqueries, 5)[0].shape) == (6, 5)


def test_group_admission_whole_or_nothing(rdata, rng):
    from raft_tpu_torch.serve.errors import MemoryBudgetError

    clock = FakeClock()
    g = ReplicatedShard(bf_build(rdata), n_replicas=2, delta_capacity=8, clock=clock,
                        name="g")
    g.upsert(rng.standard_normal((6, 16)).astype(np.float32))
    with pytest.raises(stream.DeltaFullError):
        g.upsert(rng.standard_normal((4, 16)).astype(np.float32))
    with pytest.raises(MemoryBudgetError):
        g.upsert(rng.standard_normal((2, 16)).astype(np.float32),
                 res=Resources(device="cpu", memory_budget_bytes=1))
    assert [r.stats()["delta_rows"] for r in g.replicas] == [6, 6]


def test_all_stale_group_refuses_writes(rdata, rng):
    clock = FakeClock()
    g = group(rdata, clock)
    rows = rng.standard_normal((4, 16)).astype(np.float32)
    with faults.scope():
        faults.inject("replica/upsert", exc=faults.FaultError("dev fault"))
        with pytest.raises(faults.FaultError):
            g.upsert(rows)
    assert g.stats()["stale"] == 2
    with pytest.raises(ReplicaUnavailableError):
        g.upsert(rows)
    with pytest.raises(ReplicaUnavailableError):
        g.delete([0, 1])


def test_failed_group_write_rolls_back_wal(tmp_path, rdata, rng):
    clock = FakeClock()
    snap, wpath = str(tmp_path / "snap.bin"), str(tmp_path / "wal.log")
    g = group(rdata, clock, wal=wpath, snapshot_path=snap)
    g.save(snap)
    g.upsert(rng.standard_normal((4, 16)).astype(np.float32))
    seq_before, size_before = g._wal.seq, g._wal.size_bytes
    with faults.scope():
        faults.inject("replica/upsert", exc=faults.FaultError("dev fault"))
        with pytest.raises(faults.FaultError):
            g.upsert(rng.standard_normal((4, 16)).astype(np.float32))
    assert g._wal.seq == seq_before and g._wal.size_bytes == size_before
    rec = stream.load(snap, wal=wpath, res=CPU)
    assert rec.last_recovery["replayed"] == 1
    assert rec.size == rdata.shape[0] + 4


def test_validation_error_does_not_strike(rdata, rqueries):
    clock = FakeClock()
    g = group(rdata, clock)
    bad = np.zeros((3, 7), np.float32)
    for _ in range(3):
        with pytest.raises(Exception) as ei:
            g.search(bad, 5)
        assert not isinstance(ei.value, ReplicaUnavailableError)
    assert all(r["strikes_total"] == 0 and not r["fenced"]
               for r in g.health()["replicas"]), g.health()
    assert tuple(g.search(rqueries, 5)[0].shape) == (6, 5)


def test_replica_devices_must_not_collide(rdata):
    with pytest.raises(RaftError, match="anti-affinity"):
        ShardedMutableIndex(rdata, n_shards=2, build=bf_build, replicas=3,
                            delta_capacity=64, devices=["cpu", "cpu"])
    with pytest.raises(RaftError, match="3 replicas need 3 devices"):
        ReplicatedShard(bf_build(rdata), n_replicas=3, devices=["cpu"])


def test_group_wal_durability_against_jax(tmp_path, rdata, rqueries, rng):
    """The group log holds every acknowledged write once; recovery is a
    degraded-to-one stream.load, in the port and in the JAX package (the
    snapshot and the log are the JAX formats)."""
    clock = FakeClock()
    snap, wpath = str(tmp_path / "snap.bin"), str(tmp_path / "wal.log")
    g = group(rdata, clock, wal=wpath, snapshot_path=snap)
    g.save(snap)
    rows = rng.standard_normal((8, 16)).astype(np.float32)
    gids = g.upsert(rows)
    g.delete(gids[:2].tolist())
    rec = stream.load(snap, wal=wpath, res=CPU)
    assert rec.last_recovery["replayed"] == 2 and rec.size == g.size
    assert torch.equal(rec.search(rqueries, 10)[1], g.search(rqueries, 10)[1])
    rec._wal.close()
    jrec = js.load(snap, wal=wpath)
    assert jrec.last_recovery["replayed"] == 2 and jrec.size == g.size
    assert_same(*g.search(rqueries, 10), *jrec.search(rqueries, 10), rqueries)


def test_group_save_truncates_and_compact_snapshots(tmp_path, rdata, rng):
    clock = FakeClock()
    snap, wpath = str(tmp_path / "snap.bin"), str(tmp_path / "wal.log")
    g = group(rdata, clock, wal=wpath, snapshot_path=snap)
    g.upsert(rng.standard_normal((4, 16)).astype(np.float32))
    assert g._wal.size_bytes > 0
    report = g.compact()
    assert report["snapshot"] == snap and len(report["replica_wall_s"]) == 2
    assert g._wal.size_bytes == 0
    rec = stream.load(snap, wal=wpath, res=CPU)
    assert rec.last_recovery["replayed"] == 0 and rec.size == g.size


def test_mesh_replica_parity_and_one_dead_replica(rdata, rqueries, rng):
    clock = FakeClock()
    sm = ShardedMutableIndex(rdata, n_shards=3, build=bf_build, replicas=2,
                             delta_capacity=64,
                             fencing=FencingPolicy(max_consecutive=1, backoff_s=5.0),
                             clock=clock, name="mesh")
    plain = sharded_bf(rdata, 3, delta_capacity=64, name="plainmesh")
    rows = rng.standard_normal((12, 16)).astype(np.float32)
    sm.upsert(rows)
    plain.upsert(rows)
    sm.delete([3, 7])
    plain.delete([3, 7])
    want = plain.search(rqueries, 10)[1]
    assert torch.equal(sm.search(rqueries, 10)[1], want)
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"),
                      match=lambda c: c["replica"] == "mesh/shard1/r0")
        for _ in range(4):
            assert torch.equal(sm.search(rqueries, 10)[1], want)
    assert sm.health()["healthy_min"] >= 1
    st = sm.stats()
    assert st["replicas"] == 6 and st["shards"] == 3
    assert torch.equal(sm.exact_search(rqueries, 10)[1], plain.exact_search(rqueries, 10)[1])


def test_mesh_staggered_compact_with_replicas(rdata, rng, rqueries):
    clock = FakeClock()
    sm = ShardedMutableIndex(rdata, n_shards=2, build=bf_build, replicas=2,
                             delta_capacity=32, clock=clock, name="m2")
    sm.upsert(rng.standard_normal((8, 16)).astype(np.float32))
    report = sm.compact()
    assert "shard" in report and len(report["replica_wall_s"]) == 2
    assert tuple(sm.search(rqueries, 10)[0].shape) == (6, 10)
    assert sm.warm([1, 2], ks=(5,))[5][2]["programs"] == 0


def test_mesh_hook_serves_through_failover(rdata, rqueries):
    clock = FakeClock()
    sm = ShardedMutableIndex(rdata, n_shards=2, build=bf_build, replicas=2,
                             delta_capacity=64,
                             fencing=FencingPolicy(max_consecutive=1, backoff_s=5.0),
                             clock=clock, name="hookmesh")
    hook = sm.searcher()
    want = hook(rqueries, 10)[1]
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"),
                      match=lambda c: c["replica"].endswith("shard0/r0"))
        got = hook(rqueries, 10)[1]
    assert torch.equal(got, want)
    h = sm.health()
    assert h["shards"][0]["healthy"] == 1 and h["reshard"] is None
