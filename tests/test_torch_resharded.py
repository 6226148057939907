"""raft_tpu_torch's elastic resharding, mesh durability, tiered and CAGRA
meshes against raft_tpu.stream (tier-1 ``stream`` marker).

The cases of tests/test_stream_resharded.py at its size (280 x 16), on the
port, and where the two packages meet:

- a power-of-two split and merge after a write script equal an exact search
  over exactly the live rows, and the JAX mesh's ids after the same
  reshards;
- mid-migration writes carry over, a reshard under serving load fails no
  query and loses no write, replicated splits rebuild healthy twins, a twin
  killed or staled mid-migration loses nothing;
- a ``SimulatedCrash`` at each of ``reshard/split``, ``reshard/flip`` and
  ``reshard/manifest`` recovers the old topology id for id against an
  uncrashed twin, in the port's directory and in a JAX mesh's directory
  loaded into the port (and the reverse); a committed reshard recovers the
  new topology; crashes mid-save, a failed manifest, WAL attribution and
  truncation, a save racing a reshard;
- the files: a brute-force mesh saved by either package is the other's
  byte for byte; JAX-saved IVF-Flat and IVF-PQ mesh directories load into
  the port and search with the JAX ids, and the port's save of them is the
  JAX directory byte for byte and loads back in JAX;
- the compactor's reshard advisory, held against the JAX Compactor's;
- tiered shards: a tiered IVF-PQ mesh's ``search`` and ``search_refined``
  equal its all-HBM twin bit for bit at 2,048 x 16 and at d = 64, the
  oracle's ids equal and its distances within 1e-6 of the expanded-L2
  scale (every chunk here takes the GEMM route), a JAX tiered mesh loaded
  into the port returns the JAX ids;
- a CAGRA mesh: recall against its exact oracle, a split and a rebuild
  fold.

Every shard is unpinned on the CPU. torch runs on one thread.
"""

import filecmp
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import stream as js
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import stream
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.serve import SearchService
from raft_tpu_torch.stream import ShardedMutableIndex, TierPolicy
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.stream

CPU = Resources(device="cpu")
POINTS = ("reshard/split", "reshard/flip", "reshard/manifest")


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
    leaked = faults.armed() or jfaults.armed()
    faults.clear()
    jfaults.clear()
    assert not leaked, "test left faults armed"


@pytest.fixture
def data(rng):
    return rng.standard_normal((280, 16)).astype(np.float32)


@pytest.fixture
def queries(rng):
    return rng.standard_normal((5, 16)).astype(np.float32)


def bf_build(x):
    return brute_force.BruteForce().build(x, res=CPU)


def jbf_build(x):
    return jbf.BruteForce().build(jnp.asarray(x))


def sharded_bf(data, n_shards, **kw):
    return ShardedMutableIndex(data, n_shards=n_shards, build=bf_build, **kw)


def jsharded_bf(data, n_shards, **kw):
    return js.ShardedMutableIndex(data, n_shards=n_shards, build=jbf_build, **kw)


def load(d, **kw):
    return ShardedMutableIndex.load(d, res=CPU, **kw)


def truth_gids(live_mat, live_gids, q, k):
    d2 = ((q.astype(np.float64)[:, None] - live_mat.astype(np.float64)[None]) ** 2).sum(-1)
    return np.asarray(live_gids)[np.argsort(d2, axis=1, kind="stable")[:, :k]]


def assert_same(t, j, q, rtol=1e-5, what=""):
    """Ids equal; distances within ``rtol`` of the expanded-L2 scale
    ``|d| + |q|^2`` (tests/test_torch_stream.py's rule)."""
    ti, td = np.asarray(t[1]), np.asarray(t[0])
    ji, jd = np.asarray(j[1]), np.asarray(j[0])
    np.testing.assert_array_equal(ti, ji, err_msg=what)
    scale = np.abs(jd) + (q.astype(np.float64) ** 2).sum(1, keepdims=True)
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td)), what
    err = np.abs(td.astype(np.float64) - jd)[fin] / scale[fin]
    assert err.max(initial=0.0) <= rtol, (what, err.max())


def same_files(a, b):
    """Every file of directory ``a`` equals the file of that name in ``b``
    byte for byte (and the two hold the same names)."""
    na, nb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert na == nb, (na, nb)
    _, mismatch, errors = filecmp.cmpfiles(a, b, na, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# -- the parity spine ---------------------------------------------------------

def test_split_and_merge_parity_vs_fresh_build_and_jax(data, queries, rng):
    sm = sharded_bf(data, 2, delta_capacity=64)
    jm = jsharded_bf(data, 2, delta_capacity=64)
    ins = rng.standard_normal((14, 16)).astype(np.float32)
    gids = sm.upsert(ins)
    jm.upsert(ins)
    dele = [3, 17, 101, int(gids[4])]
    assert sm.delete(dele) == 4 == jm.delete(dele)
    live_mask = np.ones(len(data), bool)
    live_mask[[3, 17, 101]] = False
    ins_mask = np.ones(14, bool)
    ins_mask[4] = False
    live_mat = np.concatenate([data[live_mask], ins[ins_mask]])
    live_g = np.concatenate([np.nonzero(live_mask)[0], np.asarray(gids)[ins_mask]])
    want = truth_gids(live_mat, live_g, queries, 10)

    rep = sm.reshard(4, warm_buckets=(5,))
    jm.reshard(4)
    assert sm.n_shards == 4 and rep["to"] == 4
    assert rep["rows_moved"] == len(live_g)
    _, got = sm.search(queries, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert_same(sm.search(queries, 10), jm.search(queries, 10), queries)
    for s, sh in enumerate(sm.shards):
        st = sh._state
        lives = np.concatenate([st.id_map[st.sealed_alive],
                                st.delta_ids[:st.delta_n][st.delta_alive[:st.delta_n]]])
        assert set(np.asarray(stream.shard_of(lives, 4))) <= {s}, s
        # each successor holds the JAX successor's live ids
        jst = jm.shards[s]._state
        assert (np.sort(st.id_map[st.sealed_alive])
                == np.sort(jst.id_map[jst.sealed_alive])).all()

    sm.reshard(2)
    jm.reshard(2)
    assert sm.n_shards == 2
    np.testing.assert_array_equal(sm.search(queries, 10)[1].numpy(), want)
    assert sm.size == len(live_g)
    rep = sm.reshard(8)
    jm.reshard(8)
    assert sm.n_shards == 8 and len(rep["steps"]) == 2
    np.testing.assert_array_equal(sm.search(queries, 10)[1].numpy(), want)
    assert_same(sm.search(queries, 10), jm.search(queries, 10), queries)
    assert_same(sm.exact_search(queries, 10), jm.exact_search(queries, 10), queries)


def test_reshard_validations(data, tmp_path):
    sm = sharded_bf(data, 2, delta_capacity=32)
    with pytest.raises(RaftError, match="power-of-two"):
        sm.reshard(3)
    with pytest.raises(RaftError, match="already at"):
        sm.reshard(2)
    with pytest.raises(RaftError, match="n_shards"):
        sm.reshard(0)
    with pytest.raises(RaftError, match="published name"):
        sm.reshard(4, publisher=SearchService(start_workers=False))
    bare = sharded_bf(data, 2, delta_capacity=32, retain_vectors=False)
    with pytest.raises(RaftError, match="retained row store"):
        bare.reshard(4)
    tiny = sharded_bf(data[:6], 2, delta_capacity=32)
    with pytest.raises(RaftError, match="no live rows|no rows"):
        tiny.reshard(32)
    assert tiny.n_shards == 2 and tiny.size == 6
    sm2 = sharded_bf(data, 2, delta_capacity=32, wal_dir=str(tmp_path))
    del sm2
    rec = load(str(tmp_path))
    with pytest.raises(RaftError, match="build recipe"):
        rec.reshard(4)
    # comms= (a stand-in for a communicator of one rank) loads like devices=
    one_rank = SimpleNamespace(devices=["cpu"], size=lambda: 1)
    by_comms = ShardedMutableIndex.load(str(tmp_path), comms=one_rank)
    assert by_comms.n_shards == 2 and by_comms.size == rec.size
    with pytest.raises(RaftError, match="not both"):
        ShardedMutableIndex.load(str(tmp_path), comms=one_rank, devices=["cpu"])
    with pytest.raises(RaftError, match="one rank, got 2"):
        ShardedMutableIndex.load(str(tmp_path),
                                 comms=SimpleNamespace(devices=["cpu"] * 2, size=lambda: 2))


def test_mid_migration_writes_carry_over(data, queries):
    sm = sharded_bf(data, 2, delta_capacity=64)
    probe = np.full((2, 16), 7.5, np.float32)
    mid = {}

    def midwrite(ctx):
        mid["g"] = sm.upsert(probe, ids=[2000, 2001])
        sm.delete([11])

    with faults.scope():
        faults.inject("reshard/split", callback=midwrite, after=1, times=1)
        rep = sm.reshard(4)
    assert rep["steps"][0]["carried_over"] >= 1
    _, ids = sm.search(probe[:1], 4)
    assert {2000, 2001} <= set(ids[0].tolist())
    assert sm.delete([11]) == 0
    live_mask = np.ones(len(data), bool)
    live_mask[11] = False
    live_mat = np.concatenate([data[live_mask], probe])
    live_g = np.concatenate([np.nonzero(live_mask)[0], [2000, 2001]])
    np.testing.assert_array_equal(sm.search(queries, 10)[1].numpy(),
                                  truth_gids(live_mat, live_g, queries, 10))


def test_reshard_under_load_loses_nothing(data):
    sm = sharded_bf(data, 2, delta_capacity=256, name="live")
    svc = SearchService(max_batch=8, max_wait_us=200.0, max_queue_rows=512)
    svc.publish("live", sm, k=5)
    sm.warm(svc.buckets, ks=(5,))
    errors, done = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def reader(tid):
        j = 0
        while not (stop.is_set() and j >= 25):
            lo = (tid * 37 + j) % 200
            try:
                _, ids = svc.search("live", data[lo:lo + 1], 5)
                with lock:
                    done.append(int(ids[0, 0]))
            except Exception as e:
                with lock:
                    errors.append(repr(e))
            j += 1

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for step in range(8):
        svc.upsert("live", data[step:step + 2] + 0.5, ids=[900 + 2 * step, 901 + 2 * step])
    rep = sm.reshard(4, publisher=svc, name="live", ks=(5,))
    for step in range(8, 12):
        svc.upsert("live", data[step:step + 2] + 0.5, ids=[900 + 2 * step, 901 + 2 * step])
    stop.set()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "reader wedged"
    svc.shutdown()
    assert errors == []
    assert len(done) >= 75
    assert sm.n_shards == 4 and rep["steps"][0]["publish"]["version"] == 2
    assert sm.size == len(data) + 24
    for gid in range(900, 924):
        row = (gid - 900) // 2 + (gid - 900) % 2
        _, ids = sm.search(data[row:row + 1] + 0.5, 4)
        assert gid in set(ids[0].tolist()), gid


def test_leased_hook_keeps_its_topology_until_it_drains(data, queries):
    """A flush that leased the 2-shard hook before a publisher-driven flip
    serves the 2-shard view to its end (writes after the flip are not in
    it); the old version retires when the lease drains, and the next lease
    is the 4-shard hook."""
    clock = FakeClock()
    sm = sharded_bf(data, 2, delta_capacity=64, clock=clock, name="lease")
    svc = SearchService(max_batch=4, clock=clock, start_workers=False)
    svc.publish("lease", sm, k=5)
    with svc.registry.lease("lease") as v:
        old = v.searcher
        before = old(queries, 5)
        sm.reshard(4, publisher=svc, name="lease", ks=(5,))
        g = sm.upsert(queries[:1] + 1e-4)
        assert svc.registry.live_versions("lease") == (1, 2)
        after = old(queries, 5)
        assert torch.equal(before[1], after[1]) and int(g[0]) not in after[1][0].tolist()
    assert svc.registry.live_versions("lease") == (2,)
    with svc.registry.lease("lease") as v:
        assert int(v.searcher(queries[:1], 5)[1][0, 0]) == int(g[0])
    svc.shutdown()


# -- replicated split ---------------------------------------------------------

def test_replicated_split_twins_in_lockstep_fenced_twin_excluded(data):
    sm = ShardedMutableIndex(data, n_shards=2, replicas=2, build=bf_build,
                             delta_capacity=64, name="rs")
    probe = np.full((1, 16), 3.3, np.float32)
    with faults.scope():
        faults.inject("replica/upsert", RuntimeError("device fault"),
                      match=lambda c: c["replica"] == "rs/shard0/r1", times=1)
        sm.upsert(probe, ids=[5000])
    assert sm.stats()["stale"] == 1
    sm.reshard(4)
    st = sm.stats()
    assert st["shards"] == 4 and st["replicas"] == 8
    assert st["stale"] == 0 and st["healthy"] == 2, st
    for sh in sm.shards:
        assert isinstance(sh, stream.ReplicatedShard) and sh.n_replicas == 2
        assert torch.equal(sh.replicas[0].search(probe, 3)[1],
                           sh.replicas[1].search(probe, 3)[1])
    assert 5000 in set(sm.search(probe, 3)[1][0].tolist())


def test_replica_killed_mid_split_never_fails_a_query(data):
    sm = ShardedMutableIndex(data, n_shards=2, replicas=2, build=bf_build,
                             delta_capacity=64,
                             fencing=stream.FencingPolicy(max_consecutive=1, backoff_s=1e9),
                             name="kz")
    outcomes = []

    def kill_and_read(ctx):
        faults.inject("replica/search", faults.FaultError("killed"),
                      match=lambda c: c["replica"].startswith("kz/shard0/r0"))
        for lo in (0, 40):
            outcomes.append(tuple(sm.search(data[lo:lo + 2], 5)[1].shape))

    with faults.scope():
        faults.inject("reshard/split", callback=kill_and_read, times=1)
        sm.reshard(4)
    assert outcomes == [(2, 5), (2, 5)]
    assert sm.n_shards == 4
    assert tuple(sm.search(data[:3], 5)[1].shape) == (3, 5)


def test_replicated_primary_goes_stale_mid_migration_nothing_lost(data):
    sm = ShardedMutableIndex(data, n_shards=2, replicas=2, build=bf_build,
                             delta_capacity=64, name="sg")
    cand = np.arange(10_000, 40_000)
    to0 = cand[stream.shard_of(cand, 2) == 0]

    def midwrite(ctx):
        faults.inject("replica/upsert", RuntimeError("dev fault"),
                      match=lambda c: c["replica"] == "sg/shard0/r0", times=1)
        sm.upsert(np.full((1, 16), 4.5, np.float32), ids=[int(to0[0])])
        sm.upsert(np.full((1, 16), -4.5, np.float32), ids=[int(to0[1])])

    with faults.scope():
        faults.inject("reshard/split", callback=midwrite, after=1, times=1)
        sm.reshard(4)
    for gid, val in ((int(to0[0]), 4.5), (int(to0[1]), -4.5)):
        _, ids = sm.search(np.full((1, 16), val, np.float32), 3)
        assert gid in set(ids[0].tolist()), (gid, ids)


# -- crash recovery -----------------------------------------------------------

def _write_script(sm, seed=9):
    r = np.random.default_rng(seed)
    g = sm.upsert(r.standard_normal((10, 16)).astype(np.float32), ids=np.arange(1000, 1010))
    sm.delete([5, 7, 1003])
    return g


@pytest.mark.parametrize("point", POINTS)
def test_kill_mid_reshard_recovers_at_every_fault_point(data, queries, tmp_path, point):
    """A SimulatedCrash at each reshard fault point recovers (manifest plus
    per-shard WAL replay) the OLD topology, id for id against an uncrashed
    twin: no acknowledged write lost, none brought back."""
    d = str(tmp_path / "mesh")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)
    with faults.scope():
        faults.inject(point, faults.SimulatedCrash("kill -9"))
        with pytest.raises(faults.SimulatedCrash):
            sm.reshard(4)
    del sm
    rec = load(d, build=bf_build)
    assert rec.n_shards == 2, point
    twin = sharded_bf(data, 2, delta_capacity=64)
    _write_script(twin)
    dt, it = twin.search(queries, 10)
    dr, ir = rec.search(queries, 10)
    assert torch.equal(it, ir) and torch.equal(dt, dr)
    assert rec.size == twin.size
    assert rec.last_recovery["replayed"] > 0
    # the recovered mesh reshards cleanly afterwards
    rec.reshard(4)
    assert torch.equal(rec.search(queries, 10)[1], it)


@pytest.mark.parametrize("point", POINTS)
def test_jax_crash_directory_recovers_in_the_port(data, queries, tmp_path, point):
    """The JAX mesh crashes at a reshard fault point; the port recovers its
    directory to the old topology with the JAX uncrashed twin's ids."""
    d = str(tmp_path / "jmesh")
    jm = jsharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(jm)
    with jfaults.scope():
        jfaults.inject(point, jfaults.SimulatedCrash("kill -9"))
        with pytest.raises(jfaults.SimulatedCrash):
            jm.reshard(4)
    del jm
    rec = load(d, build=bf_build)
    assert rec.n_shards == 2 and rec.last_recovery["replayed"] > 0
    twin = jsharded_bf(data, 2, delta_capacity=64)
    _write_script(twin)
    assert_same(rec.search(queries, 10), twin.search(queries, 10), queries, what=point)
    assert rec.size == twin.size


def test_port_crash_directory_recovers_in_jax(data, queries, tmp_path):
    d = str(tmp_path / "tmesh")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)
    with faults.scope():
        faults.inject("reshard/flip", faults.SimulatedCrash("kill -9"))
        with pytest.raises(faults.SimulatedCrash):
            sm.reshard(4)
    want = sharded_bf(data, 2, delta_capacity=64)
    _write_script(want)
    del sm
    rec = js.ShardedMutableIndex.load(d)
    assert rec.n_shards == 2 and rec.last_recovery["replayed"] > 0
    assert_same(want.search(queries, 10), rec.search(queries, 10), queries)


def test_committed_reshard_recovers_to_the_new_topology(data, queries, tmp_path):
    d = str(tmp_path / "committed")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)

    def midwrite(ctx):
        sm.upsert(np.full((1, 16), 9.25, np.float32), ids=[7000])

    with faults.scope():
        faults.inject("reshard/split", callback=midwrite, after=1, times=1)
        sm.reshard(4)
    post_flip = sm.upsert(np.full((1, 16), -9.25, np.float32), ids=[7001])
    dt, it = sm.search(queries, 10)
    del sm
    rec = load(d, build=bf_build)
    assert rec.n_shards == 4 and rec.last_recovery["topology_epoch"] == 1
    assert torch.equal(rec.search(queries, 10)[1], it)
    for gid, val in ((7000, 9.25), (int(post_flip[0]), -9.25)):
        _, ids = rec.search(np.full((1, 16), val, np.float32), 3)
        assert gid in set(ids[0].tolist()), gid
    # the JAX package recovers the same committed directory
    jrec = js.ShardedMutableIndex.load(d)
    assert jrec.n_shards == 4
    assert_same((dt, it), jrec.search(queries, 10), queries)


def test_mesh_save_load_and_crash_mid_save(data, queries, tmp_path):
    d = str(tmp_path / "mesh")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)
    want_i = sm.search(queries, 10)[1]
    with faults.scope():
        faults.inject("serialize/atomic-write", faults.SimulatedCrash("kill -9"),
                      match=lambda c: "shard1" in c["path"])
        with pytest.raises(faults.SimulatedCrash):
            sm.save()
    assert torch.equal(load(d, build=bf_build).search(queries, 10)[1], want_i)
    with faults.scope():
        faults.inject("serialize/atomic-write", faults.SimulatedCrash("kill -9"),
                      match=lambda c: c["path"].endswith("manifest"))
        with pytest.raises(faults.SimulatedCrash):
            sm.save()
    assert torch.equal(load(d, build=bf_build).search(queries, 10)[1], want_i)
    sm.save()
    rec = load(d, build=bf_build)
    assert rec.last_recovery["replayed"] == 0
    plain = sharded_bf(data, 2, delta_capacity=64)
    _write_script(plain)
    d2 = str(tmp_path / "snaponly")
    plain.save(d2)
    rec2 = load(d2)
    assert rec2._wal_dir is None
    assert torch.equal(rec2.search(queries, 10)[1], want_i)
    with pytest.raises(RaftError, match="wal_dir"):
        sm.save(d2)


def test_wal_dir_refuses_an_earlier_meshes_directory(data, tmp_path):
    d = str(tmp_path / "life1")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)
    del sm
    with pytest.raises(RaftError, match="already holds a mesh manifest"):
        sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    rec = load(d, build=bf_build)
    rec.reshard(4)
    del rec
    with pytest.raises(RaftError, match="already holds a mesh manifest"):
        sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    assert load(d, build=bf_build).n_shards == 4


def test_manifest_write_failure_rolls_the_flip_back(data, queries, tmp_path):
    d = str(tmp_path / "roll")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)
    want_i = sm.search(queries, 10)[1]
    with faults.scope():
        faults.inject("serialize/atomic-write", OSError("disk full"),
                      match=lambda c: c["path"].endswith("manifest"))
        with pytest.raises(OSError, match="disk full"):
            sm.reshard(4)
    assert sm.n_shards == 2
    assert torch.equal(sm.search(queries, 10)[1], want_i)
    g = sm.upsert(np.full((1, 16), 6.5, np.float32))
    rep = sm.reshard(4)
    assert sm.n_shards == 4 and rep["epoch"] == 1
    assert int(g[0]) in set(sm.search(np.full((1, 16), 6.5, np.float32), 3)[1][0].tolist())
    rec = load(d, build=bf_build)
    assert rec.n_shards == 4
    assert int(g[0]) in set(rec.search(np.full((1, 16), 6.5, np.float32), 3)[1][0].tolist())


def test_per_shard_wal_attribution_and_sawtooth(data, tmp_path):
    from raft_tpu_torch.obs import metrics

    d = str(tmp_path / "saw")
    sm = sharded_bf(data, 2, delta_capacity=16, wal_dir=d, name="saw")
    cand = np.arange(10_000, 40_000)
    homes = stream.shard_of(cand, 2)
    to0, to1 = cand[homes == 0], cand[homes == 1]
    sm.upsert(np.zeros((6, 16), np.float32), ids=to0[:6])
    sm.upsert(np.ones((3, 16), np.float32), ids=to1[:3])
    snap = metrics.to_json()
    assert snap.get('raft_tpu_wal_appends_total{name="saw/shard0"}') >= 1
    assert snap.get('raft_tpu_wal_appends_total{name="saw/shard1"}') >= 1
    w0, w1 = sm.shards[0]._wal, sm.shards[1]._wal
    assert w0.size_bytes > 0 and w1.size_bytes > 0
    rep = sm.compact(shard=0)
    assert rep["snapshot"].endswith("shard0.e0.idx")
    assert w0.size_bytes == 0 and w1.size_bytes > 0
    want_i = sm.search(data[:4], 10)[1]
    del sm
    assert torch.equal(load(d).search(data[:4], 10)[1], want_i)


def test_save_serializes_with_a_live_reshard(data, tmp_path):
    d = str(tmp_path / "ser")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=d)
    _write_script(sm)
    box = {}

    def midsave(ctx):
        t = threading.Thread(target=lambda: box.setdefault("ok", (sm.save(), True)[1]))
        t.start()
        box["t"] = t

    with faults.scope():
        faults.inject("reshard/split", callback=midsave, after=1, times=1)
        sm.reshard(4)
    box["t"].join(60)
    assert not box["t"].is_alive() and box.get("ok")
    rec = load(d, build=bf_build)
    assert rec.n_shards == 4 and rec.last_recovery["topology_epoch"] == 1


def test_build_free_warm_ladder_across_the_flip(data, queries):
    """After a rehearsal run, an identical publish -> serve -> reshard ->
    serve schedule builds no kernel (obs.compile attribution; the count of
    kernel builds on the card)."""
    from raft_tpu_torch.obs import compile as obs_compile

    clock = FakeClock()

    def run(name):
        sm = sharded_bf(data, 2, delta_capacity=16, clock=clock, name=name)
        svc = SearchService(max_batch=4, clock=clock, start_workers=False)
        svc.publish(name, sm, k=5)
        sm.warm(svc.buckets, ks=(5,))
        for step in range(8):
            if step == 4:
                sm.reshard(4, publisher=svc, name=name, ks=(5,),
                           warm_buckets=svc.buckets)
            sm.upsert(data[step:step + 1] + 0.5, ids=[600 + step])
            fut = svc.submit(name, queries[:2], 5)
            clock.advance(1.0)
            svc.pump()
            assert int(fut.result(timeout=0)[1].shape[1]) == 5
        svc.shutdown()
        assert sm.n_shards == 4

    run("rehearsal")
    with obs_compile.attribution() as rec:
        run("live")
    assert rec.compile_s == 0.0 and rec.programs == 0


# -- the files, both ways -------------------------------------------------------

def test_brute_force_mesh_files_equal_jax_byte_for_byte(data, queries, tmp_path):
    """The same rows, ids and write script through each package's mesh with
    ``wal_dir=``: the manifests, shard snapshots and shard WALs are equal
    byte for byte, before and after a reshard; each side loads the other's."""
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    sm = sharded_bf(data, 2, delta_capacity=64, wal_dir=dt, name="files")
    jm = jsharded_bf(data, 2, delta_capacity=64, wal_dir=dj, name="files")
    for m in (sm, jm):
        _write_script(m)
    same_files(dt, dj)
    for m in (sm, jm):
        m.save()
    same_files(dt, dj)
    for m in (sm, jm):
        m.reshard(4)
        m.upsert(np.full((1, 16), 2.5, np.float32), ids=[4242])
    same_files(dt, dj)
    want = jm.search(queries, 10)
    del sm, jm
    assert_same(load(dj, build=bf_build).search(queries, 10), want, queries)
    assert_same(load(dt).search(queries, 10), js.ShardedMutableIndex.load(dt).search(queries, 10),
                queries)


def _ivf_mesh(kind, X):
    if kind == "ivf_flat":
        params = jfl.IndexParams(n_lists=8, seed=0)
        return js.ShardedMutableIndex(
            X, n_shards=2, delta_capacity=32, name="jivf_flat",
            build=lambda x: jfl.build(params, jnp.asarray(x)),
            search_params=jfl.SearchParams(n_probes=4)), ivf_flat.SearchParams(n_probes=4)
    params = jpq.IndexParams(n_lists=8, pq_dim=8, pq_bits=4, seed=0)
    return js.ShardedMutableIndex(
        X, n_shards=2, delta_capacity=32, name="jivf_pq",
        build=lambda x: jpq.build(params, jnp.asarray(x)),
        search_params=jpq.SearchParams(n_probes=4)), ivf_pq.SearchParams(n_probes=4)


@pytest.fixture(scope="module")
def ivf_meshes(tmp_path_factory):
    """kind -> (JAX mesh after the write script, its saved directory, port
    search params, queries); the JAX builds run once a module."""
    r = np.random.default_rng(21)
    X = r.standard_normal((600, 16)).astype(np.float32)
    Q = r.standard_normal((8, 16)).astype(np.float32)
    out = {}
    for kind in ("ivf_flat", "ivf_pq"):
        jm, sp = _ivf_mesh(kind, X)
        jm.upsert(r.standard_normal((10, 16)).astype(np.float32), ids=np.arange(5000, 5010))
        jm.delete([2, 5003, 77])
        d = str(tmp_path_factory.mktemp(kind))
        jm.save(d)
        out[kind] = (jm, d, sp, Q)
    return out


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_jax_saved_ivf_mesh_loads_into_the_port(ivf_meshes, tmp_path, kind):
    """A JAX IVF mesh directory loads into the port and searches with the
    JAX ids; the port's save of it is the JAX directory byte for byte, and
    the JAX package loads the port's directory."""
    jm, d, sp, Q = ivf_meshes[kind]
    rec = load(d, search_params=sp)
    assert rec.n_shards == 2 and rec.kind == kind and rec.size == jm.size
    rtol = 1e-5 if kind == "ivf_flat" else 1e-4
    assert_same(rec.search(Q, 10), jm.search(jnp.asarray(Q), 10), Q, rtol)
    assert_same(rec.exact_search(Q, 10), jm.exact_search(jnp.asarray(Q), 10), Q)
    d2 = str(tmp_path / "resaved")
    rec.save(d2)
    same_files(d, d2)
    jrec = js.ShardedMutableIndex.load(
        d2, search_params=(jfl.SearchParams(n_probes=4) if kind == "ivf_flat"
                           else jpq.SearchParams(n_probes=4)))
    assert_same(rec.search(Q, 10), jrec.search(jnp.asarray(Q), 10), Q, rtol)


def test_ivf_flat_mesh_write_script_matches_jax(ivf_meshes):
    """After the load, the same writes and a per-shard extend fold on both
    sides keep the ids equal."""
    jm, d, sp, Q = ivf_meshes["ivf_flat"]
    rec = load(d, search_params=sp)
    jrec = js.ShardedMutableIndex.load(d, search_params=jfl.SearchParams(n_probes=4))
    r = np.random.default_rng(4)
    rows = r.standard_normal((12, 16)).astype(np.float32)
    for m in (rec, jrec):
        m.upsert(rows, ids=np.arange(6000, 6012))
        m.delete([6001, 9, 5005])
        for s in range(2):
            assert m.compact(shard=s)["mode"] == "extend"
    assert_same(rec.search(Q, 10), jrec.search(jnp.asarray(Q), 10), Q)


# -- the compactor's advisory -----------------------------------------------------

def test_compactor_reshard_advised_trigger(data):
    """The reshard advisory over a mesh: a standing once-per-transition
    advice, cleared when the reshard lands, equal to the JAX Compactor's
    over the JAX mesh at every step; a plain index never gets one."""
    from raft_tpu_torch.obs import metrics

    clock = FakeClock()
    sm = sharded_bf(data, 2, delta_capacity=32, clock=clock, name="adv")
    jm = jsharded_bf(data, 2, delta_capacity=32, clock=clock, name="adv")

    def pair(m, jmesh, **pol):
        return (stream.Compactor(m, policy=stream.CompactionPolicy(
                    delta_fill=None, tombstone_ratio=None, **pol), clock=clock),
                js.Compactor(jmesh, policy=js.CompactionPolicy(
                    delta_fill=None, tombstone_ratio=None, **pol), clock=clock))

    comp, jcomp = pair(sm, jm, reshard_rows_per_shard=100)
    key = 'raft_tpu_reshard_advised_total{action="split",name="adv"}'
    before = metrics.to_json().get(key, 0)
    assert comp.run_once() is None and jcomp.run_once() is None
    adv = comp.last_advice
    assert adv == jcomp.last_advice
    assert adv["action"] == "split" and adv["target"] == 4 and adv["auto_apply"] is False
    after = metrics.to_json().get(key, 0)
    assert after == before + 1
    comp.run_once()
    assert metrics.to_json().get(key, 0) == after
    sm.reshard(4)
    jm.reshard(4)
    comp.run_once()
    jcomp.run_once()
    assert comp.last_advice is None and jcomp.last_advice is None
    comp2, jcomp2 = pair(sm, jm, reshard_rows_per_shard=10)
    rep, jrep = comp2.run_once(force=True), jcomp2.run_once(force=True)
    assert rep["reshard_advised"]["action"] == "split"
    assert rep["reshard_advised"] == jrep["reshard_advised"]
    assert rep["shard"] == jrep["shard"]
    comp3, jcomp3 = pair(sm, jm, reshard_min_rows_per_shard=1000)
    comp3.run_once()
    jcomp3.run_once()
    assert comp3.last_advice == jcomp3.last_advice
    assert comp3.last_advice["action"] == "merge" and comp3.last_advice["target"] == 2
    odd = sharded_bf(data, 3, delta_capacity=32, clock=clock, name="odd")
    comp4 = stream.Compactor(odd, policy=stream.CompactionPolicy(
        delta_fill=None, tombstone_ratio=None, reshard_min_rows_per_shard=1000), clock=clock)
    comp4.run_once()
    assert comp4.last_advice is None
    plain = stream.MutableIndex(bf_build(data), delta_capacity=32)
    comp5 = stream.Compactor(plain, policy=stream.CompactionPolicy(
        reshard_rows_per_shard=1), clock=clock)
    comp5.run_once(force=True)
    assert comp5.last_advice is None


def test_reshard_metrics_ledger_and_health(data):
    import gc

    from raft_tpu_torch.obs import events as obs_events
    from raft_tpu_torch.obs import mem as obs_mem
    from raft_tpu_torch.obs import metrics

    sm = sharded_bf(data, 2, delta_capacity=32, name="met")
    seen = {}

    def observe(ctx):
        seen["health"] = sm.health()["reshard"]
        seen["gauge_mid"] = metrics.to_json().get('raft_tpu_stream_shards{name="met"}')

    assert sm.health()["reshard"] is None
    with faults.scope():
        faults.inject("reshard/split", callback=observe, after=1, times=1)
        sm.reshard(4)
    assert seen["health"]["action"] == "split"
    assert seen["health"]["from"] == 2 and seen["health"]["to"] == 4
    assert seen["health"]["folded_donors"] == 1
    assert seen["gauge_mid"] == 2
    snap = metrics.to_json()
    assert snap.get('raft_tpu_stream_shards{name="met"}') == 4
    assert snap.get('raft_tpu_reshard_migrations_total'
                    '{action="split",name="met",phase="started"}') == 1
    assert snap.get('raft_tpu_reshard_migrations_total'
                    '{action="split",name="met",phase="completed"}') == 1
    assert snap.get('raft_tpu_reshard_rows_moved_total{name="met"}') == len(data)
    assert any(k.startswith("raft_tpu_reshard_seconds") for k in snap)
    kinds = [e["kind"] for e in obs_events.query(component="reshard", name="met")]
    for kind in ("reshard_started", "reshard_flip", "reshard_committed"):
        assert kind in kinds, kinds
    assert sm.health()["reshard"] is None
    gc.collect()
    aud = obs_mem.audit(collect=True)
    leaks = [r for r in aud["retired_unfreed"] if r["name"].startswith("met/")]
    assert leaks == [], leaks


# -- tiered shards ---------------------------------------------------------------

TIER = TierPolicy(oracle_chunk=512, auto_promote=False)


def _tier_pair(X, d, n_shards=2):
    p = ivf_pq.IndexParams(n_lists=16, pq_bits=4, pq_dim=8, seed=0)
    sp = ivf_pq.SearchParams(n_probes=8)

    def build(x):
        return ivf_pq.build(p, x, res=CPU)

    common = dict(n_shards=n_shards, build=build, search_params=sp, index_params=p,
                  delta_capacity=32)
    hbm = ShardedMutableIndex(X, name=f"tm_hbm_{d}", **common)
    tiered = ShardedMutableIndex(X, name=f"tm_tier_{d}", storage="tiered", tier=TIER, **common)
    return hbm, tiered


def _bits(a, b, what):
    assert torch.equal(a[1], b[1]), f"{what}: ids diverge"
    assert torch.equal(a[0], b[0]), f"{what}: distances diverge"


@pytest.mark.parametrize("d", [16, 64])
def test_tiered_mesh_vs_hbm_mesh_bit_parity(d):
    """A tiered IVF-PQ mesh and its all-HBM twin under one write script:
    ``search`` and ``search_refined`` (the batch and a 1-row flush) bit for
    bit, the oracle's ids equal and its distances within 1e-6 of the
    expanded-L2 scale (chunks of 512 rows take the GEMM route)."""
    r = np.random.default_rng(d)
    X = r.standard_normal((2048, d)).astype(np.float32)
    Q = r.standard_normal((16, d)).astype(np.float32)
    hbm, tiered = _tier_pair(X, d)
    assert all(sh.tiered_store.residency == "host" for sh in tiered.shards)
    assert [sh.tiered_store._shard for sh in tiered.shards] == [0, 1]
    _bits(hbm.search_refined(Q, 10, 4), tiered.search_refined(Q, 10, 4), "refined")
    rows24 = r.standard_normal((24, d)).astype(np.float32)
    rows = r.standard_normal((8, d)).astype(np.float32)
    for m in (hbm, tiered):
        m.upsert(rows24, ids=np.arange(50_000, 50_024))
        m.upsert(rows, ids=np.arange(60_000, 60_008))
        m.delete([1, 7, 60_003])
        m.compact(shard=0)
    _bits(hbm.search(Q, 10), tiered.search(Q, 10), "search post-churn")
    _bits(hbm.search_refined(Q, 10, 4), tiered.search_refined(Q, 10, 4), "refined post-churn")
    _bits(hbm.search_refined(Q[:1], 10, 4), tiered.search_refined(Q[:1], 10, 4), "1-row flush")
    _bits(hbm.refined_searcher(4)(Q, 10), tiered.refined_searcher(4)(Q, 10), "refined hook")
    eh, et = hbm.exact_search(Q, 10), tiered.exact_search(Q, 10)
    assert torch.equal(eh[1], et[1])
    assert_same(et, eh, Q, 1e-6, "gemm-route oracle")
    assert tiered.shards[0].tiered_store._epoch == 1
    assert tiered.shards[0].tiered_store.residency == "host"


def test_tiered_mesh_reshards_and_saves(tmp_path):
    """A tiered mesh splits into tiered successors (their stores under the
    new ordinals), and a saved tiered mesh loads back tiered with the same
    answers."""
    r = np.random.default_rng(3)
    X = r.standard_normal((2048, 16)).astype(np.float32)
    Q = r.standard_normal((8, 16)).astype(np.float32)
    hbm, tiered = _tier_pair(X, 16)
    for m in (hbm, tiered):
        m.reshard(4)
    assert [sh.tiered_store._shard for sh in tiered.shards] == [0, 1, 2, 3]
    _bits(hbm.search_refined(Q, 10, 4), tiered.search_refined(Q, 10, 4), "after the split")
    d = str(tmp_path / "tiered")
    tiered.save(d)
    rec = load(d, search_params=ivf_pq.SearchParams(n_probes=8), tier=TIER)
    assert rec.n_shards == 4 and all(sh.storage == "tiered" for sh in rec.shards)
    _bits(tiered.search_refined(Q, 10, 4), rec.search_refined(Q, 10, 4), "loaded")


def test_jax_tiered_mesh_loads_into_the_port(tmp_path):
    """A JAX tiered IVF-PQ mesh saved and loaded into the port:
    ``search_refined`` returns the JAX ids (distances within 1e-5 of the
    scale), and the loaded shards stay tiered and cold."""
    from raft_tpu.stream import TierPolicy as JPolicy

    r = np.random.default_rng(8)
    X = r.standard_normal((2048, 16)).astype(np.float32)
    Q = r.standard_normal((8, 16)).astype(np.float32)
    params = jpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=4, seed=0)
    jm = js.ShardedMutableIndex(
        X, n_shards=2, delta_capacity=32, name="jtier",
        build=lambda x: jpq.build(params, jnp.asarray(x)),
        search_params=jpq.SearchParams(n_probes=8), storage="tiered",
        tier=JPolicy(oracle_chunk=512, auto_promote=False))
    jm.upsert(r.standard_normal((6, 16)).astype(np.float32), ids=np.arange(9000, 9006))
    jm.delete([0, 9001])
    d = str(tmp_path / "jtier")
    jm.save(d)
    rec = load(d, search_params=ivf_pq.SearchParams(n_probes=8), tier=TIER)
    assert all(sh.tiered_store.residency == "host" for sh in rec.shards)
    assert_same(rec.search_refined(Q, 10, 4), jm.search_refined(jnp.asarray(Q), 10, 4), Q)
    d2 = str(tmp_path / "resaved")
    rec.save(d2)
    same_files(d, d2)


# -- a CAGRA mesh ------------------------------------------------------------------

def test_cagra_mesh_recall_split_and_rebuild():
    """A 2-shard CAGRA mesh: recall@10 against its own exact oracle, kept
    through writes, a rebuild fold of one shard and a split to 4."""
    r = np.random.default_rng(12)
    centers = r.standard_normal((8, 16)) * 3.0
    X = (centers[r.integers(0, 8, 1200)] + r.standard_normal((1200, 16))).astype(np.float32)
    Q = (centers[r.integers(0, 8, 32)] + r.standard_normal((32, 16))).astype(np.float32)
    params = cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16, seed=0)
    sm = ShardedMutableIndex(X, n_shards=2, delta_capacity=32, index_params=params,
                             build=lambda x: cagra.build(params, x, res=CPU),
                             search_params=cagra.SearchParams(itopk_size=32), name="cg")
    assert sm.kind == "cagra"

    def recall():
        _, got = sm.search(Q, 10)
        _, want = sm.exact_search(Q, 10)
        got, want = got.numpy(), want.numpy()
        return np.mean([len(set(got[i]) & set(want[i])) / 10 for i in range(len(Q))])

    assert recall() >= 0.9
    g = sm.upsert(Q[:4] + 1e-3)
    assert (sm.search(Q[:4], 1)[1][:, 0].numpy() == g).all()
    sm.delete(np.arange(0, 1200, 7))
    assert sm.compact(shard=1, mode="rebuild")["reclaimed"] > 0
    assert recall() >= 0.9
    sm.reshard(4)
    assert sm.n_shards == 4 and recall() >= 0.9
    assert (sm.search(Q[:4], 1)[1][:, 0].numpy() == g).all()
