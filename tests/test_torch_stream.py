"""raft_tpu_torch.stream against raft_tpu.stream (tier-1 ``stream`` marker).

The seam is the sealed index: the JAX package builds it once per module, a
JAX ``MutableIndex`` wraps it, and the port's ``MutableIndex`` wraps the same
index loaded from its raft_tpu/13 file. One seeded write script (fresh rows,
an existing sealed id and a delta id replaced, unknown ids deleted, the delta
grown across the 8 -> 16 -> 32 buckets until ``DeltaFullError``) runs on
both, with a search after every step:

- brute force and IVF-Flat: ids exact, distances within 1e-5 of the
  expanded-L2 scale ``|d| + |q|^2``;
- IVF-PQ: ids exact, distances within 1e-4 of that scale (both routes: the
  plain one and ``pq_scan_topk``'s, fed the packed tombstone bitset);
- CAGRA, whose entry pools come from different random streams: recall@10
  against the exact neighbours of the live rows within 0.05 of JAX's.

Then the folds (``extend`` gives the JAX fold's lists; a brute-force rebuild
is exact, the trained kinds' rebuilds are held at recall), the files (a
JAX-saved mutable loads into the port and searches the same, the port's
save of that state is byte-identical, and the port's file loads in JAX), the
compactor's watermarks under an injected clock and its thread joined by a
deadline, the service's write path, and each left-out piece's refusal.
Everything runs on the CPU; the port's kernels run their plain versions.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import stream as js
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import stream
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops.pq_scan import pack_keep_words
from raft_tpu_torch.serve import (IndexRegistry, OverloadedError,
                                  SearchService, ServiceClosedError)
from raft_tpu_torch.stream.mutable import _map_ids, _pack_words

pytestmark = pytest.mark.stream

CPU = Resources(device="cpu")
N, D, CAP = 400, 32, 32
RTOL = {"brute_force": 1e-5, "ivf_flat": 1e-5, "ivf_pq": 1e-4, "ivf_pq_fused": 1e-4}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(20, D)) * 3.0
    x = (centers[rng.integers(0, 20, N)] + rng.normal(size=(N, D))).astype(np.float32)
    pool = (centers[rng.integers(0, 20, 200)] + rng.normal(size=(200, D))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 12)] + rng.normal(size=(12, D))).astype(np.float32)
    q[:4] = pool[:4] + 1e-3          # four queries sit on the first upserted rows
    return x, pool, q


@pytest.fixture(scope="module")
def sealed(data, tmp_path_factory):
    """kind -> (JAX sealed index, path of its file, port loader)."""
    x, _, _ = data
    d = tmp_path_factory.mktemp("sealed")
    out = {}
    j = jbf.BruteForce().build(jnp.asarray(x))
    jbf.save(j, str(d / "bf.bin"))
    out["brute_force"] = (j, str(d / "bf.bin"), brute_force.load)
    j = jfl.build(jfl.IndexParams(n_lists=8, seed=0), jnp.asarray(x))
    jfl.save(j, str(d / "fl.bin"))
    out["ivf_flat"] = (j, str(d / "fl.bin"), ivf_flat.load)
    j = jpq.build(jpq.IndexParams(n_lists=8, pq_dim=16, pq_bits=4, seed=0), jnp.asarray(x))
    jpq.save(j, str(d / "pq.bin"))
    out["ivf_pq"] = (j, str(d / "pq.bin"), ivf_pq.load)
    j = jc.build(jc.IndexParams(intermediate_graph_degree=32, graph_degree=16, seed=0),
                 jnp.asarray(x))
    jc.save(j, str(d / "cagra.bin"))
    out["cagra"] = (j, str(d / "cagra.bin"), cagra.load)
    return out


def _params(kind):
    """(JAX wrap kwargs, port wrap kwargs) beyond the sealed index."""
    if kind == "ivf_flat":
        return (dict(search_params=jfl.SearchParams(n_probes=4)),
                dict(search_params=ivf_flat.SearchParams(n_probes=4)))
    if kind.startswith("ivf_pq"):
        # "ivf_pq_fused": the port's chunk select on the topk kernel's route,
        # so each chunk runs pq_scan_topk with the packed tombstone bitset
        sel = "pallas" if kind == "ivf_pq_fused" else "auto"
        return (dict(search_params=jpq.SearchParams(n_probes=4)),
                dict(search_params=ivf_pq.SearchParams(n_probes=4, select_impl=sel)))
    if kind == "cagra":
        return (dict(search_params=jc.SearchParams(itopk_size=32)),
                dict(search_params=cagra.SearchParams(itopk_size=32)))
    return {}, {}


def _pair(data, sealed, kind, **kw):
    x, _, _ = data
    j, path, load = sealed[kind.replace("_fused", "")]
    jkw, tkw = _params(kind)
    if kind in ("ivf_flat", "ivf_pq", "ivf_pq_fused"):
        jkw["dataset"] = tkw["dataset"] = x
    jm = js.MutableIndex(j, delta_capacity=CAP, **jkw, **kw)
    tm = stream.MutableIndex(load(path, res=CPU), delta_capacity=CAP, **tkw, **kw)
    return jm, tm


def _script(pool):
    """The seeded write script: (op, rows or ids, ids)."""
    rows = iter(range(pool.shape[0]))

    def take(r):
        return pool[[next(rows) for _ in range(r)]]

    return [("upsert", take(5), None),              # fresh ids, bucket 8
            ("upsert", take(2), [3, N]),            # replace a sealed and a delta id
            ("delete", [5, 7, N + 1, 10 ** 6], None),   # sealed, delta, unknown
            ("upsert", take(12), None),             # bucket 8 -> 32
            ("delete", [N + 5, 11, 10 ** 6 + 1], None),
            ("upsert", take(13), None),             # the delta is full: 32 rows
            ("upsert", take(1), None)]              # DeltaFullError


def _apply(m, op):
    try:
        if op[0] == "upsert":
            return np.asarray(m.upsert(op[1], ids=op[2]))
        return m.delete(op[1])
    except stream.DeltaFullError:
        return "full"
    except js.DeltaFullError:
        return "full"


def _stats(m):
    s = dict(m.stats())
    s.pop("delta_oldest_at")
    return s


def _assert_same(td, ti, jd, ji, rtol, q):
    """Ids equal; distances within ``rtol`` of the expanded-L2 scale
    ``|d| + |q|^2`` (a distance near 0 is a difference of terms of size
    |q|^2, rounded at that size on both sides)."""
    ti, td = ti.numpy(), td.numpy()
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert ti.dtype == np.int32 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    scale = np.abs(jd) + (q.astype(np.float64) ** 2).sum(1, keepdims=True)
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td)) and np.array_equal(td[~fin], jd[~fin])
    err = np.abs(td.astype(np.float64) - jd)[fin] / scale[fin]
    assert err.max(initial=0.0) <= rtol, err.max()


def _live(m):
    """(rows, global ids) of every live row of a port MutableIndex."""
    st = m._state
    s = np.nonzero(st.sealed_alive)[0]
    dl = np.nonzero(st.delta_alive[:st.delta_n])[0]
    return (np.concatenate([st.store[s], st.delta[dl]]),
            np.concatenate([st.id_map[s], st.delta_ids[dl].astype(np.int64)]))


def _truth(rows, gids, q, k=10):
    d2 = ((q.astype(np.float64)[:, None] - rows[None]) ** 2).sum(-1)
    return gids[np.argsort(d2, axis=1, kind="stable")[:, :k]]


def _recall(ids, truth):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(truth[r].tolist())) / truth.shape[1]
                    for r in range(truth.shape[0])])


# -- the write script ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq", "ivf_pq_fused"])
def test_write_script_matches_jax(data, sealed, kind):
    _, pool, q = data
    jm, tm = _pair(data, sealed, kind)
    for step, op in enumerate(_script(pool)):
        got, want = _apply(tm, op), _apply(jm, op)
        if isinstance(want, str) or np.ndim(want) == 0:
            assert got == want, step
        else:
            assert got.dtype == np.int64 and np.array_equal(got, want), step
        assert _stats(tm) == _stats(jm), step
        _assert_same(*tm.search(q, 10), *jm.search(q, 10), RTOL[kind], q)
    assert tm.stats()["delta_bucket"] == CAP and tm.size == jm.size


def test_cagra_write_script_recall_matches_jax(data, sealed):
    x, pool, q = data
    jm, tm = _pair(data, sealed, "cagra")
    for op in _script(pool):
        assert str(_apply(tm, op)) == str(_apply(jm, op))
        rows, gids = _live(tm)
        truth = _truth(rows, gids, q)
        rt, rj = _recall(tm.search(q, 10)[1], truth), _recall(jm.search(q, 10)[1], truth)
        assert rt >= rj - 0.05, (rt, rj)
    assert _stats(tm) == _stats(jm)
    # the tombstoned ids never surface
    ids = set(tm.search(q, 10)[1].flatten().tolist())
    assert not ids & {5, 7, N + 1, N + 5, 11}


# -- the folds -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_extend_fold_matches_jax(data, sealed, kind):
    _, pool, q = data
    jm, tm = _pair(data, sealed, kind)
    for op in _script(pool)[:5]:
        _apply(jm, op), _apply(tm, op)
    rj, rt = jm.compact("extend"), tm.compact("extend")
    for key in ("mode", "epoch", "folded", "reclaimed", "sealed_rows", "delta_remaining"):
        assert rt[key] == rj[key], key
    js_, ts_ = jm._state.sealed, tm._state.sealed
    np.testing.assert_array_equal(ts_.list_ids.numpy(), np.asarray(js_.list_ids))
    np.testing.assert_array_equal(ts_.list_sizes.numpy(), np.asarray(js_.list_sizes))
    if kind == "ivf_flat":
        np.testing.assert_array_equal(ts_.list_data.numpy(), np.asarray(js_.list_data))
    else:
        np.testing.assert_array_equal(ts_.list_codes.numpy(), np.asarray(js_.list_codes))
    np.testing.assert_array_equal(tm._state.id_map, jm._state.id_map)
    np.testing.assert_array_equal(tm._state.sealed_alive, jm._state.sealed_alive)
    assert _stats(tm) == _stats(jm)
    _assert_same(*tm.search(q, 10), *jm.search(q, 10), RTOL[kind], q)
    # writes after the fold land in the fresh delta of the new epoch
    for op in _script(pool)[5:6]:
        _apply(jm, op), _apply(tm, op)
    _assert_same(*tm.search(q, 10), *jm.search(q, 10), RTOL[kind], q)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_filter_coverage_follows_the_fold(data, sealed, kind):
    """An extend fold makes a new sealed index whose largest stored id is
    read when it is made: a keep mask that covers only the ids before the
    fold is refused on it, one that covers the folded ids is taken."""
    _, pool, q = data
    _, tm = _pair(data, sealed, kind)
    old = tm._state.sealed
    for op in _script(pool)[:5]:
        _apply(tm, op)
    tm.compact("extend")
    new = tm._state.sealed
    assert old.max_stored_id == N - 1
    assert new.max_stored_id == int(new.list_ids.max()) == len(tm._state.id_map) - 1 > N - 1
    mod = ivf_flat if kind == "ivf_flat" else ivf_pq
    sp = _params(kind)[1]["search_params"]
    with pytest.raises(RaftError, match="must cover max stored id"):
        mod.search(sp, new, torch.from_numpy(q), 5, sample_filter=torch.ones(N, dtype=torch.bool),
                   res=CPU)
    keep = torch.ones(new.max_stored_id + 1, dtype=torch.bool)
    d, _ = mod.search(sp, new, torch.from_numpy(q), 5, sample_filter=keep, res=CPU)
    assert d.shape == (q.shape[0], 5)


def test_brute_force_rebuild_is_exact(data, sealed):
    _, pool, q = data
    jm, tm = _pair(data, sealed, "brute_force")
    for op in _script(pool)[:5]:
        _apply(jm, op), _apply(tm, op)
    rows, gids = _live(tm)
    rep = tm.compact("rebuild")
    assert rep["mode"] == "rebuild" and rep["reclaimed"] == 4 and rep["epoch"] == 1
    assert tm.stats()["sealed_dead"] == 0 and tm.stats()["delta_rows"] == 0
    d, i = tm.search(q, 10)
    np.testing.assert_array_equal(i.numpy(), _truth(rows, gids, q))
    jm.compact("rebuild")
    _assert_same(d, i, *jm.search(q, 10), 1e-5, q)
    np.testing.assert_array_equal(tm._state.id_map, jm._state.id_map)


@pytest.mark.parametrize("kind,params", [
    ("ivf_flat", ivf_flat.IndexParams(n_lists=8, seed=0)),
    ("ivf_pq", ivf_pq.IndexParams(n_lists=8, pq_dim=16, pq_bits=4, seed=0)),
    ("cagra", None)])
def test_rebuild_fold_of_trained_kinds_holds_recall(data, sealed, kind, params):
    _, pool, q = data
    jm, tm = _pair(data, sealed, kind)
    if params is not None:
        tm._index_params = params
    for op in _script(pool)[:5]:
        _apply(tm, op)
    rows, gids = _live(tm)
    truth = _truth(rows, gids, q)
    before = _recall(tm.search(q, 10)[1], truth)
    rep = tm.compact("rebuild")
    assert rep["reclaimed"] == 4 and tm.stats()["sealed_dead"] == 0
    after = _recall(tm.search(q, 10)[1], truth)
    assert after >= before - 0.05, (before, after)
    assert after >= {"ivf_flat": 0.9, "ivf_pq": 0.5, "cagra": 0.9}[kind], after


def test_writes_during_a_fold_carry_over(data, sealed):
    """A write that lands between the fold's snapshot and the swap survives
    the swap (the fold consumes a snapshot prefix of the delta)."""
    _, pool, q = data
    _, tm = _pair(data, sealed, "ivf_flat")
    tm.upsert(pool[:5])
    real_extend = ivf_flat.extend
    late = {}

    def extend_then_write(*a, **kw):
        out = real_extend(*a, **kw)
        late["ids"] = tm.upsert(pool[50:52])          # mid-fold
        late["del"] = tm.delete([N])                  # a folded row dies mid-fold
        return out

    tm._cfg.module.extend = extend_then_write
    try:
        rep = tm.compact("extend")
    finally:
        tm._cfg.module.extend = real_extend
    assert rep["folded"] == 5 and rep["delta_remaining"] == 2
    assert late["del"] == 1
    _, i = tm.search(pool[50:52] + 1e-3, 5)
    assert i[:, 0].tolist() == late["ids"].tolist()
    assert N not in tm.search(pool[:1] + 1e-3, 5)[1].flatten().tolist()


def test_rebuild_takes_an_injected_builder(data):
    """``builder=`` replaces ``module.build`` in a rebuild (and stands in
    for index_params); a builder of another kind is refused at the fold."""
    x, pool, q = data
    calls = []

    def builder(rows, res=None):
        calls.append(rows.shape[0])
        return ivf_flat.build(ivf_flat.IndexParams(n_lists=4, seed=0), rows, res=res)

    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, seed=0), x, res=CPU)
    m = stream.MutableIndex(idx, search_params=ivf_flat.SearchParams(n_probes=4),
                            delta_capacity=32, dataset=x, builder=builder)
    assert m.can_rebuild
    g = m.upsert(q[:1] + 1e-3)
    m.delete([0, 1])
    assert m.compact("rebuild")["reclaimed"] == 2 and calls == [N - 1]
    live = np.concatenate([x[2:], q[:1] + 1e-3])
    gids = np.concatenate([np.arange(2, N), g])
    np.testing.assert_array_equal(m.search(q, 5)[1].numpy(), _truth(live, gids, q, 5))
    wrong = stream.MutableIndex(idx, dataset=x, builder=lambda rows, res=None:
                                brute_force.BruteForce().build(rows, res=CPU))
    with pytest.raises(RaftError, match="builder returned a brute_force index"):
        wrong.compact("rebuild")


# -- device state: replace, never mutate -------------------------------------------

def test_published_tensors_are_never_written(data, sealed):
    _, pool, _ = data
    _, tm = _pair(data, sealed, "brute_force")
    tm.upsert(pool[:6])
    st = tm._state
    view, keep = st.delta_view, st.sealed_keep_dev
    snap = [t.clone() for t in view[:3]] + [keep.mask.clone(), keep.words.clone()]
    tm.upsert(pool[6:9], ids=[0, 1, N])
    tm.delete([2, N + 1])
    assert st.delta_view is not view and st.sealed_keep_dev is not keep
    for old, new in zip(snap, list(view[:3]) + [keep.mask, keep.words]):
        assert torch.equal(old, new)
    # the new handles hold the writes
    assert not bool(st.sealed_keep_dev.mask[0]) and bool(keep.mask[0])


def test_readers_never_see_both_copies_of_an_upserted_id(data):
    """The publish order under threads: a writer replaces sealed rows with
    near copies under the same ids while four readers search (switch
    interval 1 us); no result row may hold an id twice, which a reader that
    saw the new delta copy before the old copy's tombstone would return."""
    import sys

    x, _, q = data
    m = _bf(data, delta_capacity=512)
    near = np.argsort(((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1), 1)[:, :4]
    stop, bad, searches = threading.Event(), [], [0]

    def reader():
        while not stop.is_set():
            ids = m.search(q, 20)[1].tolist()
            searches[0] += 1
            bad.extend(r for r in ids if len([i for i in r if i >= 0])
                       != len({i for i in r if i >= 0}))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=reader) for _ in range(4)]
        for t in readers:
            t.start()
        for step in range(100):
            ids = near[step % q.shape[0]]
            m.upsert(x[ids] + 1e-4 * (step + 1), ids=ids)
        stop.set()
        for t in readers:
            t.join(30)
            assert not t.is_alive(), "a reader wedged"
    finally:
        sys.setswitchinterval(old)
    assert searches[0] > 0 and not bad, bad[:3]
    assert m.size == N


def test_packed_tombstone_words_equal_the_kernel_packing(rng):
    for n in (1, 31, 32, 33, 1000):
        alive = rng.random(n) < 0.7
        words = torch.from_numpy(_pack_words(alive))
        assert torch.equal(words, pack_keep_words(torch.from_numpy(alive)))


def test_map_ids_passes_sentinels():
    id_map = torch.tensor([7, 9, 11], dtype=torch.int32)
    ids = torch.tensor([[2, -1, 0], [1, 1, -1]], dtype=torch.int32)
    out = _map_ids(ids, id_map)
    assert out.dtype == torch.int32
    assert out.tolist() == [[11, -1, 7], [9, 9, -1]]


def test_delta_route_switch_at_4096_keeps_ids(rng):
    """From the 4,096-row bucket on the delta scan is ``fused_knn`` (its
    plain version on the CPU), below it the GEMM + top-k route: the ids of
    the live rows' exact neighbours are the same on both sides of it."""
    d = 64
    x = rng.standard_normal((300, d)).astype(np.float32)
    m = stream.MutableIndex(brute_force.BruteForce().build(x, res=CPU),
                            delta_capacity=8192)
    new = rng.standard_normal((2100, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    m.upsert(new[:2000])
    assert m.stats()["delta_bucket"] == 2048
    rows, gids = _live(m)
    np.testing.assert_array_equal(m.search(q, 10)[1].numpy(), _truth(rows, gids, q))
    m.upsert(new[2000:])
    m.delete([0, 301, 2350])
    assert m.stats()["delta_bucket"] == 4096
    rows, gids = _live(m)
    np.testing.assert_array_equal(m.search(q, 10)[1].numpy(), _truth(rows, gids, q))


# -- files -------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq", "cagra"])
def test_jax_saved_mutable_loads_and_saves_byte_identical(data, sealed, kind, tmp_path):
    _, pool, q = data
    jm, _ = _pair(data, sealed, kind)
    for op in _script(pool)[:5]:
        _apply(jm, op)
    jpath, tpath = str(tmp_path / "jax.stream"), str(tmp_path / "port.stream")
    js.save(jm, jpath)
    tm = stream.load(jpath, res=CPU, search_params=_params(kind)[1].get("search_params"))
    assert tm.device.type == "cpu" and tm.name == jm.name
    assert _stats(tm) == _stats(jm)
    if kind == "cagra":
        rows, gids = _live(tm)
        truth = _truth(rows, gids, q)
        assert _recall(tm.search(q, 10)[1], truth) >= _recall(jm.search(q, 10)[1], truth) - 0.05
    else:
        _assert_same(*tm.search(q, 10), *jm.search(q, 10), RTOL[kind], q)
    stream.save(tm, tpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    # the port's file of further writes loads in JAX with the same state
    tm.upsert(pool[40:43])
    tm.delete([N + 2])
    stream.save(tm, tpath)
    back = js.load(tpath, search_params=_params(kind)[0].get("search_params"))
    assert _stats(back) == _stats(tm)


def test_load_rearms_age_watermark(data, sealed, tmp_path):
    _, pool, _ = data
    clock = FakeClock()
    _, tm = _pair(data, sealed, "brute_force", clock=clock)
    tm.upsert(pool[:2])
    p = str(tmp_path / "m.stream")
    stream.save(tm, p)
    clock2 = FakeClock()
    m2 = stream.load(p, res=CPU, clock=clock2)
    comp = stream.Compactor(m2, policy=stream.CompactionPolicy(
        delta_fill=None, tombstone_ratio=None, max_age_s=5.0), clock=clock2)
    assert comp.due() is None
    clock2.advance(5.1)
    assert comp.due() == "age" and comp.run_once()["folded"] == 2


# -- the compactor -----------------------------------------------------------------

def _bf(data, **kw):
    x, _, _ = data
    return stream.MutableIndex(brute_force.BruteForce().build(x, res=CPU), **kw)


def test_compactor_watermarks(data):
    x, pool, _ = data
    clock = FakeClock()
    m = _bf(data, delta_capacity=16, clock=clock)
    comp = stream.Compactor(m, policy=stream.CompactionPolicy(
        delta_fill=0.5, tombstone_ratio=None, max_age_s=5.0), clock=clock)
    assert comp.due() is None and comp.run_once() is None
    m.upsert(pool[:1])
    clock.advance(4.9)
    assert comp.due() is None
    clock.advance(0.2)
    assert comp.due() == "age"
    m.upsert(pool[1:8])
    assert comp.due() == "delta_fill"             # fill beats age
    rep = comp.run_once()
    assert rep["trigger"] == "delta_fill" and rep["folded"] == 8
    assert comp.due() is None and comp.last_report is rep
    dead = (N + 8) // 4 + 1                        # the fold left N + 8 sealed rows
    m.delete(np.arange(dead))
    comp.policy = stream.CompactionPolicy(delta_fill=0.5, tombstone_ratio=0.25)
    assert comp.due() == "tombstone_ratio"
    rep = comp.run_once()
    assert rep["mode"] == "rebuild" and rep["reclaimed"] == dead
    assert m.stats()["sealed_dead"] == 0 and comp.due() is None
    assert comp.run_once(force=True)["trigger"] == "forced"
    assert comp.last_advice is None               # a plain index cannot reshard
    # not even with the reshard watermarks armed (the mesh's advisory is
    # held against JAX's in tests/test_torch_resharded.py)
    comp.policy = stream.CompactionPolicy(reshard_rows_per_shard=1,
                                          reshard_min_rows_per_shard=10 ** 9)
    assert comp.run_once(force=True)["trigger"] == "forced"
    assert comp.last_advice is None and "reshard_advised" not in comp.last_report


def test_compactor_pacing_defers_and_force_overrides(data):
    _, pool, _ = data
    m = _bf(data, delta_capacity=16)
    defer = [True]
    comp = stream.Compactor(m, policy=stream.CompactionPolicy(delta_fill=0.5),
                            pacing=lambda: defer[0])
    m.upsert(pool[:8])
    assert comp.run_once() is None and comp.last_deferred == "delta_fill"
    defer[0] = False
    assert comp.run_once()["trigger"] == "delta_fill"
    comp.set_pacing(lambda: 1 / 0)                # a broken hint never stalls
    m.upsert(pool[8:16])
    assert comp.run_once()["folded"] == 8
    with pytest.raises(RaftError):
        comp.set_pacing(5)


def test_compactor_thread_joined_by_deadline(data):
    """The background poll loop folds a due watermark with no run_once()
    call: the test waits on the publish (an Event, 30 s deadline), never a
    timed sleep, then joins the worker."""
    _, pool, _ = data
    m = _bf(data, delta_capacity=16)
    published = threading.Event()

    class Publisher:
        def publish(self, name, searcher, **kw):
            published.set()
            return {"version": 2}

    comp = stream.Compactor(m, publisher=Publisher(), name="bg",
                            policy=stream.CompactionPolicy(delta_fill=0.5),
                            poll_interval_s=0.005).start()
    try:
        m.upsert(pool[:8])
        assert published.wait(30.0), "the background compactor never fired"
    finally:
        comp.close(timeout_s=30.0)
    assert comp._worker is None
    assert m.stats()["epoch"] >= 1 and comp.last_report["publish"] == {"version": 2}


# -- the service's write path ------------------------------------------------------

def test_service_read_your_writes_and_deletes(data):
    x, pool, q = data
    clock = FakeClock()
    m = _bf(data, delta_capacity=16, clock=clock)
    svc = SearchService(max_batch=4, clock=clock, start_workers=False)
    svc.publish("m", m, k=5)
    g = svc.upsert("m", q[0:1] + 1e-3)
    fut = svc.submit("m", q[:1], 5)
    clock.advance(1.0)
    assert svc.pump() == 1
    assert int(fut.result(timeout=0)[1][0, 0]) == int(g[0])
    assert svc.delete("m", g) == 1
    fut = svc.submit("m", q[:1], 5)
    clock.advance(1.0)
    svc.pump()
    assert int(g[0]) not in fut.result(timeout=0)[1][0]
    svc.publish("frozen", brute_force.BruteForce().build(x, res=CPU), k=5, warm=False)
    with pytest.raises(RaftError, match="not a mutable"):
        svc.upsert("frozen", q[:1])
    svc.upsert("m", pool[:15])
    with pytest.raises(OverloadedError):            # DeltaFullError
        svc.upsert("m", pool[:2])
    with pytest.raises(RaftError, match="wrap time"):
        svc.publish("m", m, search_params=object(), warm=False)
    svc.shutdown()
    with pytest.raises(ServiceClosedError):
        svc.upsert("m", q[:1])


def test_republish_keeps_or_closes_the_write_path(data):
    x, pool, _ = data
    m = _bf(data, delta_capacity=16)
    svc = SearchService(max_batch=4, start_workers=False)
    svc.publish("m", m, k=5)
    svc.publish("m", m.searcher(), k=5)           # the compactor's republish
    svc.upsert("m", pool[:1])
    bf2 = brute_force.BruteForce().build(x, res=CPU)
    svc.publish("m", brute_force.batched_searcher(bf2), k=5, warm=False)
    with pytest.raises(RaftError, match="not a mutable"):
        svc.upsert("m", pool[:1])
    svc.publish("m", m, k=5, warm=False)
    svc.upsert("m", pool[1:2])
    svc.publish("m", bf2, k=5, warm=False)
    with pytest.raises(RaftError, match="not a mutable"):
        svc.upsert("m", pool[:1])
    svc.shutdown()


def test_registry_lease_pins_pre_compaction_epoch(data):
    _, _, q = data
    m = _bf(data, delta_capacity=16)
    reg = IndexRegistry(buckets=(4,))
    reg.publish("m", m, k=5)
    g = m.upsert(q[0:1] + 1e-3)
    with reg.lease("m") as v_old:
        m.compact()
        m.delete(g)                                 # lands in the new epoch only
        reg.publish("m", m.searcher(), k=5)
        _, ids = v_old.searcher(q[:4], 5)
        assert int(ids[0, 0]) == int(g[0])          # the frozen epoch-0 view
    assert reg.live_versions("m") == (2,)
    with reg.lease("m") as v_new:
        _, ids = v_new.searcher(q[:4], 5)
        assert int(g[0]) not in ids[0].tolist()


def test_swap_under_load_loses_nothing(data):
    """Reader threads through a running service while a writer upserts and
    the compactor folds and republishes twice: no request fails, every read
    is answered, and every acknowledged upsert is searchable at the end."""
    x, pool, _ = data
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, seed=0), x, res=CPU)
    m = stream.MutableIndex(idx, search_params=ivf_flat.SearchParams(n_probes=8),
                            delta_capacity=64, retain_vectors=False, name="load")
    svc = SearchService(max_batch=8, max_wait_us=200.0, max_queue_rows=512)
    svc.publish("load", m, k=5)
    m.warm(svc.buckets, ks=(5,))
    comp = stream.Compactor(m, publisher=svc, name="load", ks=(5,),
                            policy=stream.CompactionPolicy(delta_fill=0.25,
                                                           tombstone_ratio=None))
    errors, done = [], []
    lock = threading.Lock()

    def reader(tid):
        for j in range(30):
            r = (tid * 31 + j) % 200
            try:
                _, ids = svc.search("load", x[r:r + 1], 5)
                with lock:
                    done.append(int(ids[0, 0]))
            except Exception as e:      # any loss fails the test
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    swaps, acked = 0, []
    for step in range(40):
        acked.append(svc.upsert("load", pool[2 * step:2 * step + 2] + 0.01))
        if comp.due():
            comp.run_once()
            swaps += 1
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "a reader wedged"
    assert errors == [] and len(done) == 120
    assert swaps >= 2 and m.stats()["epoch"] == swaps
    got = np.concatenate([svc.search("load", pool[r:r + 8] + 0.01, 5)[1][:, 0]
                          for r in range(0, 80, 8)])
    assert got.tolist() == np.concatenate(acked).tolist()
    svc.shutdown()


def test_warm_runs_the_delta_ladder(data):
    m = _bf(data, delta_capacity=32)
    rep = m.warm((1, 2, 4), ks=(5, 10))
    assert sorted(rep) == [5, 10] and sorted(rep[5]) == [1, 2, 4]
    assert {"wall_s", "programs", "cache_hits"} <= set(rep[5][1])


def test_exact_and_refined_search(data, sealed):
    x, pool, q = data
    _, tm = _pair(data, sealed, "ivf_pq")
    for op in _script(pool)[:5]:
        _apply(tm, op)
    rows, gids = _live(tm)
    truth = _truth(rows, gids, q)
    np.testing.assert_array_equal(tm.exact_search(q, 10)[1].numpy(), truth)
    approx = _recall(tm.search(q, 10)[1], truth)
    refined = _recall(tm.search_refined(q, 10, refine_ratio=4)[1], truth)
    assert refined >= approx and refined >= 0.9, (approx, refined)
    hook = tm.refined_searcher()
    assert hook.mutable is tm and hook.kind == "stream/ivf_pq+refine"
    assert torch.equal(hook(q, 10)[1], tm.search_refined(q, 10)[1])
    assert tm.uploaded_bytes > 0


# -- refusals and guards -----------------------------------------------------------

def test_left_out_pieces_raise_not_yet_ported(data, sealed, tmp_path):
    """The pieces this file once pinned as "not yet ported" (tiered storage,
    ``Compactor(drift=)``, ``load(tier=)``) now answer as the JAX package:
    a tiered wrap works, misuse is refused with the JAX texts."""
    from raft_tpu.core.chunked import ChunkedReader

    x, _, q = data
    bf = brute_force.BruteForce().build(x, res=CPU)
    jbf_ = jbf.BruteForce().build(jnp.asarray(x))
    tiered = stream.MutableIndex(bf, storage="tiered", name="lp_tiered")
    assert tiered.tiered_store is not None and tiered.tiered_store.residency == "host"
    _assert_same(*tiered.search(q, 5), *js.MutableIndex(jbf_).search(jnp.asarray(q), 5),
                 1e-5, q)
    for kw in (dict(tier=stream.TierPolicy()), dict(tier_residency="host")):
        with pytest.raises(RaftError) as e:
            stream.MutableIndex(bf, **kw)
        with pytest.raises(Exception) as je:
            js.MutableIndex(jbf_, **kw)
        assert str(e.value) == str(je.value)
    _, _, load = sealed["ivf_flat"]
    ix = load(sealed["ivf_flat"][1], res=CPU)
    # a reader duck-typed as the chunked readers are (the JAX one here)
    # gives its backing array as the row store, and the out-of-core rebuild
    # fold answers as the in-core one
    reader = ChunkedReader(x, chunk_rows=100)
    params = ivf_flat.IndexParams(n_lists=8, seed=1)
    m = stream.MutableIndex(ix, dataset=reader, index_params=params, name="ooc_ported")
    assert m._state.store is reader.host_view()
    twin = stream.MutableIndex(ix, dataset=x, index_params=params, name="ooc_twin")
    m.compact("rebuild", ooc_chunk_rows=100)
    twin.compact("rebuild")
    for f in ivf_flat._STATE_ARRAYS:
        assert torch.equal(getattr(m._state.sealed, f), getattr(twin._state.sealed, f)), f
    with pytest.raises(RaftError, match="drift must be an obs.quality.DriftDetector"):
        stream.Compactor(m, drift=object())
    p = str(tmp_path / "m.stream")
    stream.save(m, p)
    with pytest.raises(RaftError, match="applies to storage='tiered' only"):
        stream.load(p, res=CPU, tier=stream.TierPolicy())
    # the sharded and replicated mesh complete the JAX package's names
    assert set(stream.__all__) == set(js.__all__)


def test_wrap_guards(data, sealed):
    x, _, q = data
    with pytest.raises(RaftError, match="cannot wrap"):
        stream.MutableIndex(object())
    _, path, load = sealed["ivf_pq"]
    pq = load(path, res=CPU)
    with pytest.raises(RaftError, match="retain_vectors"):
        stream.MutableIndex(pq, retain_vectors=True)
    with pytest.raises(RaftError, match="sealed rows"):
        stream.MutableIndex(pq, dataset=x[:10])
    m = _bf(data)
    # a handle naming another device than the index's raises, as the indexes do
    with pytest.raises(RaftError, match="lives on cpu"):
        m.search(q, 5, res=Resources(device="cuda"))
    with pytest.raises(RaftError, match="unique"):
        m.upsert(x[:2], ids=[4, 4])
    with pytest.raises(RaftError, match="int32"):
        m.upsert(x[:1], ids=[2 ** 31])
    assert stream.delta_buckets(64) == js.delta_buckets(64) == (8, 16, 32, 64)
    with pytest.raises(RaftError):
        stream.delta_buckets(48)
