"""raft_tpu_torch.testing.faults against raft_tpu.testing.faults, and the
crash windows the fault points open (tier-1 ``faults`` marker).

The registry is driven through the same call sequences in both packages and
must trigger, count and clear alike. Then the port's crash windows: a crash
injected at ``serialize/atomic-write`` (between the complete temporary file
and the rename) leaves the previous snapshot readable, for a plain index and
for a ``stream.MutableIndex``, and the WAL is truncated only after the
rename; a crash at ``stream/post-wal`` (after the WAL append, before the
memtable) recovers through ``stream.load(wal=)``. Everything runs on the
CPU with exact comparisons (ids equal, distances bit for bit: the recovered
index and its uncrashed twin run the same float32 operations).
"""

import inspect
import os

import numpy as np
import pytest

from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import stream
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.faults

CPU = Resources(device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    """A fault leaked out of a test fails that test's teardown instead of
    reaching a sibling."""
    yield
    leaked = faults.armed()
    faults.clear()
    assert not leaked, "test left faults armed"


@pytest.fixture
def data(rng):
    return rng.standard_normal((256, 16)).astype(np.float32)


@pytest.fixture
def queries(rng):
    return rng.standard_normal((6, 16)).astype(np.float32)


def bf_build(rows):
    return brute_force.BruteForce().build(rows, res=CPU)


# -- the fault registry --------------------------------------------------------

@pytest.mark.parametrize("name", ["inject", "clear", "fire", "fired", "armed",
                                  "scope"])
def test_signatures_match_jax(name):
    assert (inspect.signature(getattr(faults, name))
            == inspect.signature(getattr(jfaults, name)))
    assert faults.__all__ == jfaults.__all__


def test_error_types():
    assert issubclass(faults.SimulatedCrash, faults.FaultError)
    assert issubclass(faults.FaultError, RaftError)
    with pytest.raises(RaftError, match="needs exc= or callback="):
        faults.inject("p")
    assert not faults.armed()


def _drive(mod):
    """One call sequence through a registry module; returns what it saw."""
    seen, raised = [], []
    with mod.scope():
        mod.inject("p", callback=lambda c: seen.append(("cb", c["who"])),
                   after=1, match=lambda c: c["who"] != "c")
        mod.inject("p", exc=mod.FaultError("boom"), times=2)
        mod.inject("q", exc=mod.SimulatedCrash("kill"), after=2, times=1)
        for who in ("a", "b", "c", "a", "b"):
            for point in ("p", "q"):
                try:
                    mod.fire(point, who=who)
                except mod.FaultError as e:
                    raised.append((point, who, type(e).__name__))
        counts = (mod.fired("p"), mod.fired("q"), mod.armed("p"),
                  mod.armed("zzz"), mod.armed())
    return seen, raised, counts, mod.armed(), mod.fired("p")


def test_registry_behaves_as_jax():
    got = _drive(faults)
    assert got == _drive(jfaults)
    seen, raised, counts, armed_after, fired_after = got
    # the callback skips its first match; the raise fires on the first two
    assert seen == [("cb", "b"), ("cb", "a"), ("cb", "b")]
    assert raised[:2] == [("p", "a", "FaultError"), ("p", "b", "FaultError")]
    assert ("q", "c", "SimulatedCrash") in raised
    assert counts == (5, 1, True, False, True)
    assert not armed_after and fired_after == 0


def test_fire_disarmed_is_noop_and_counts_reset():
    faults.fire("nothing/armed", foo=1)
    with faults.scope():
        faults.inject("p", exc=faults.FaultError("x"), times=1)
        with pytest.raises(faults.FaultError):
            faults.fire("p")
        faults.fire("p")                     # times=1 spent
        assert faults.fired("p") == 1
        faults.clear("p")
        assert faults.fired("p") == 0 and not faults.armed("p")
    assert not faults.armed()


def test_scope_disarms_on_raise():
    with pytest.raises(ZeroDivisionError):
        with faults.scope():
            faults.inject("p", exc=faults.FaultError("x"))
            1 / 0
    assert not faults.armed()
    faults.fire("p")


# -- serialize/atomic-write: a crashed save keeps the previous file ----------------

def test_plain_index_save_is_atomic(tmp_path, data, queries):
    p = str(tmp_path / "bf.bin")
    brute_force.save(bf_build(data), p)
    before = open(p, "rb").read()
    with faults.scope():
        faults.inject("serialize/atomic-write", faults.SimulatedCrash("kill -9"))
        with pytest.raises(faults.SimulatedCrash):
            brute_force.save(bf_build(data[:32]), p)
        assert faults.fired("serialize/atomic-write") == 1
    assert open(p, "rb").read() == before
    assert os.listdir(tmp_path) == ["bf.bin"]          # temporary file removed
    back = brute_force.load(p, res=CPU)
    assert tuple(back.dataset.shape) == data.shape


def test_ivf_index_save_is_atomic(tmp_path, data):
    p = str(tmp_path / "ivf.bin")
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, seed=0), data, res=CPU)
    ivf_flat.save(index, p)
    before = open(p, "rb").read()
    with faults.scope():
        faults.inject("serialize/atomic-write", faults.SimulatedCrash("kill -9"))
        with pytest.raises(faults.SimulatedCrash):
            ivf_flat.save(ivf_flat.build(ivf_flat.IndexParams(n_lists=2, seed=0),
                                         data[:64], res=CPU), p)
    assert open(p, "rb").read() == before
    assert ivf_flat.load(p, res=CPU).size == data.shape[0]


def test_crashed_mutable_save_keeps_previous_snapshot_and_log(tmp_path, data,
                                                               queries, rng):
    """A crash after the temporary write, before the rename: the previous
    snapshot still loads, the WAL is not truncated (truncation follows the
    rename), and load + replay gives the uncrashed answers."""
    snap = str(tmp_path / "snap.bin")
    wpath = str(tmp_path / "wal.log")
    m = stream.MutableIndex(bf_build(data), delta_capacity=64, wal=wpath)
    stream.save(m, snap)
    first = open(snap, "rb").read()
    m.upsert(rng.standard_normal((4, 16)).astype(np.float32))
    m.delete([3, 9])
    before = m.search(queries, 10)
    log_bytes = m._wal.size_bytes
    with faults.scope():
        faults.inject("serialize/atomic-write", faults.SimulatedCrash("kill -9"))
        with pytest.raises(faults.SimulatedCrash):
            stream.save(m, snap)
    assert open(snap, "rb").read() == first
    assert m._wal.size_bytes == log_bytes > 0
    assert sorted(os.listdir(tmp_path)) == ["snap.bin", "wal.log"]
    rec = stream.load(snap, wal=wpath, res=CPU)
    assert rec.last_recovery == {"replayed": 2, "skipped": 0, "torn": False,
                                 "wal_seq": 2}
    got = rec.search(queries, 10)
    assert np.array_equal(got[1].numpy(), before[1].numpy())
    assert np.array_equal(got[0].numpy(), before[0].numpy())
    # a clean save afterwards truncates the log, after the rename
    stream.save(rec, snap)
    assert rec._wal.size_bytes == 0 and open(snap, "rb").read() != first


def test_wal_truncated_only_after_the_rename(tmp_path, data, rng):
    """The reset runs after os.replace: at the fault point (rename not yet
    done) the log still holds every record."""
    snap = str(tmp_path / "snap.bin")
    m = stream.MutableIndex(bf_build(data), delta_capacity=64,
                            wal=str(tmp_path / "wal.log"))
    m.upsert(rng.standard_normal((2, 16)).astype(np.float32))
    sizes = []
    with faults.scope():
        faults.inject("serialize/atomic-write",
                      callback=lambda ctx: sizes.append(
                          (m._wal.size_bytes, os.path.exists(ctx["tmp"]),
                           os.path.exists(ctx["path"]))))
        stream.save(m, snap)
    (log_bytes, tmp_exists, snap_exists), = sizes
    assert log_bytes > 0 and tmp_exists and not snap_exists
    assert m._wal.size_bytes == 0 and os.path.exists(snap)


# -- stream/post-wal: the crash between the log and the memtable -------------------

def test_crash_between_wal_and_memtable_recovers(tmp_path, data, queries, rng):
    snap = str(tmp_path / "snap.bin")
    wpath = str(tmp_path / "wal.log")
    m = stream.MutableIndex(bf_build(data), delta_capacity=64, wal=wpath,
                            snapshot_path=snap)
    stream.save(m, snap)
    rows1 = rng.standard_normal((8, 16)).astype(np.float32)
    rows2 = rng.standard_normal((4, 16)).astype(np.float32)
    m.upsert(rows1)
    m.delete([3, 5, 250])
    with faults.scope():
        faults.inject("stream/post-wal", faults.SimulatedCrash("kill -9"))
        with pytest.raises(faults.SimulatedCrash):
            m.upsert(rows2)
    del m                                   # only snap + wal.log survive

    twin = stream.MutableIndex(bf_build(data), delta_capacity=64)
    twin.upsert(rows1)
    twin.delete([3, 5, 250])
    twin.upsert(rows2)                      # the logged write replays

    rec = stream.load(snap, wal=wpath, res=CPU)
    assert rec.last_recovery == {"replayed": 3, "skipped": 0, "torn": False,
                                 "wal_seq": 3}
    dr, ir = rec.search(queries, 10)
    dt, it = twin.search(queries, 10)
    assert np.array_equal(ir.numpy(), it.numpy())
    assert np.array_equal(dr.numpy(), dt.numpy())
    assert rec.size == twin.size
    rec.upsert(rng.standard_normal((2, 16)).astype(np.float32))
    assert rec._wal.seq == 4                # the log re-attached


def test_delete_crash_window_recovers(tmp_path, data, queries):
    snap = str(tmp_path / "snap.bin")
    wpath = str(tmp_path / "wal.log")
    m = stream.MutableIndex(bf_build(data), delta_capacity=64, wal=wpath)
    stream.save(m, snap)
    _, ids = m.search(queries, 1)
    nn = ids[:, 0].tolist()
    with faults.scope():
        faults.inject("stream/post-wal", faults.SimulatedCrash("kill -9"),
                      match=lambda ctx: ctx["op"] == "delete")
        with pytest.raises(faults.SimulatedCrash):
            m.delete(nn)
    rec = stream.load(snap, wal=wpath, res=CPU)
    _, ids2 = rec.search(queries, 10)
    assert not set(nn) & set(ids2.flatten().tolist())


def test_wal_append_failure_leaves_memtable_untouched(tmp_path, data, rng):
    m = stream.MutableIndex(bf_build(data), delta_capacity=64,
                            wal=str(tmp_path / "wal.log"))
    with faults.scope():
        faults.inject("wal/append", exc=faults.FaultError("disk full"), times=1)
        with pytest.raises(faults.FaultError):
            m.upsert(rng.standard_normal((3, 16)).astype(np.float32))
    assert m.stats()["delta_rows"] == 0 and m.size == data.shape[0]
    assert m._wal.seq == 0
