"""raft_tpu_torch.stream.wal against raft_tpu.stream.wal (tier-1 ``faults``
marker).

The log format is the JAX package's: the same record sequence (float32,
int8 and uint8 upserts, deletes) appended by either package gives
byte-identical files, and a file written by either replays in the other to
the same records (rows and ids compared exactly). Then the log's own
contract, as tests/test_faults.py holds the JAX log to it: torn tails
truncated at reopen, strict replay on damage, batched fsyncs, a failed
append mid-batch, ``rollback_last``, ``reset`` with the sequence continuing,
and the counters.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from raft_tpu.stream import wal as jwal
from raft_tpu_torch import obs
from raft_tpu_torch.core import RaftError
from raft_tpu_torch.stream import wal as twal
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    leaked = faults.armed()
    faults.clear()
    assert not leaked, "test left faults armed"


def _records(rng):
    return [
        ("upsert", rng.standard_normal((5, 8)).astype(np.float32),
         np.arange(100, 105, dtype=np.int64)),
        ("delete", None, np.array([101, 103, 7], np.int64)),
        ("upsert", rng.integers(-128, 128, (3, 8)).astype(np.int8),
         np.array([7, 8, 9], np.int64)),
        ("upsert", rng.integers(0, 256, (2, 8)).astype(np.uint8),
         np.array([2 ** 31 - 2, 0], np.int64)),
        ("delete", None, np.array([], np.int64)),
        ("upsert", rng.standard_normal((1, 8)).astype(np.float32),
         np.array([5], np.int64)),
    ]


def _write(mod, path, records, as_tensors=False):
    wal = mod.WriteAheadLog(path, fsync_every=3, name="parity")
    seqs = []
    for op, rows, ids in records:
        if as_tensors:
            ids = torch.from_numpy(ids)
            rows = None if rows is None else torch.from_numpy(rows)
        seqs.append(wal.append_upsert(rows, ids) if op == "upsert"
                    else wal.append_delete(ids))
    wal.close()
    return seqs


def _assert_replays(recs, records):
    assert [s for s, *_ in recs] == list(range(1, len(records) + 1))
    for (_, op, rows, ids), (op0, rows0, ids0) in zip(recs, records):
        assert op == op0
        assert ids.dtype == np.int64 and np.array_equal(ids, ids0)
        if rows0 is None:
            assert rows is None
        else:
            assert rows.dtype == rows0.dtype and np.array_equal(rows, rows0)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_same_records_give_byte_identical_logs(tmp_path, rng, as_tensors):
    records = _records(rng)
    sj = _write(jwal, tmp_path / "jax.log", records)
    st = _write(twal, tmp_path / "port.log", records, as_tensors=as_tensors)
    assert sj == st == list(range(1, len(records) + 1))
    assert (tmp_path / "jax.log").read_bytes() == (tmp_path / "port.log").read_bytes()


@pytest.mark.parametrize("writer,reader", [(jwal, twal), (twal, jwal)])
def test_logs_replay_in_the_other_package(tmp_path, rng, writer, reader):
    records = _records(rng)
    _write(writer, tmp_path / "w.log", records)
    log = reader.WriteAheadLog(tmp_path / "w.log")
    assert log.seq == len(records)
    _assert_replays(list(log.replay()), records)
    assert [s for s, *_ in log.replay(after_seq=4)] == [5, 6]
    # appends continue the other package's numbering
    assert log.append_delete([1]) == len(records) + 1
    log.close()


def test_torn_tail_written_by_jax_is_truncated_by_the_port(tmp_path, rng):
    p = tmp_path / "w.log"
    records = _records(rng)[:2]
    _write(jwal, p, records)
    good = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(b"\x01garbage-half-record")
    log = twal.WriteAheadLog(p)
    assert log.seq == 2 and os.path.getsize(p) == good
    _assert_replays(list(log.replay()), records)
    assert not log.last_scan["torn"]
    assert log.append_delete([1]) == 3


def test_public_surface_matches_jax():
    assert twal.__all__ == jwal.__all__
    for name in ("__init__", "append_upsert", "append_delete", "flush",
                 "rollback_last", "reset", "close", "replay"):
        assert (inspect.signature(getattr(twal.WriteAheadLog, name))
                == inspect.signature(getattr(jwal.WriteAheadLog, name))), name
    assert issubclass(twal.WalCorruptError, RaftError)


def test_strict_replay_raises_on_corruption(tmp_path):
    p = tmp_path / "w.log"
    wal = twal.WriteAheadLog(p)
    wal.append_delete([1])
    wal.append_delete([2])
    wal.close()
    raw = bytearray(p.read_bytes())
    raw[-3] ^= 0xFF                        # a payload byte of the last record
    p.write_bytes(bytes(raw))
    wal2 = twal.WriteAheadLog(p)
    assert [s for s, *_ in wal2.replay()] == [1]
    with pytest.raises(twal.WalCorruptError):
        list(wal2.replay(strict=True))
    with pytest.raises(twal.WalCorruptError):
        wal2.append_delete([3])            # unreachable past the damage
    wal2.reset()
    assert wal2.append_delete([3]) == 2
    # the JAX log reads the damaged file the same way
    jw = jwal.WriteAheadLog(tmp_path / "j.log")
    jw.close()
    (tmp_path / "j.log").write_bytes(bytes(raw))
    assert [s for s, *_ in jwal.WriteAheadLog(tmp_path / "j.log").replay()] == [1]


def test_fsync_batching(tmp_path):
    wal = twal.WriteAheadLog(tmp_path / "w.log", fsync_every=4)
    with faults.scope():
        faults.inject("wal/fsync", callback=lambda c: None)
        for i in range(8):
            wal.append_delete([i])
        assert faults.fired("wal/fsync") == 2
        wal.append_delete([9])
        wal.flush()
        assert faults.fired("wal/fsync") == 3
    with pytest.raises(RaftError, match="fsync_every"):
        twal.WriteAheadLog(tmp_path / "x.log", fsync_every=0)


def test_append_fault_mid_batch(tmp_path):
    wal = twal.WriteAheadLog(tmp_path / "w.log")
    with faults.scope():
        faults.inject("wal/append", exc=faults.FaultError("disk full"),
                      after=2, times=1)
        wal.append_delete([1])
        wal.append_delete([2])
        with pytest.raises(faults.FaultError):
            wal.append_delete([3])
        wal.append_delete([4])
    assert [s for s, *_ in wal.replay()] == [1, 2, 3]
    assert [list(i) for *_, i in wal.replay()] == [[1], [2], [4]]


def test_rollback_last(tmp_path):
    wal = twal.WriteAheadLog(tmp_path / "w.log")
    wal.append_delete([1])
    prev = wal.size_bytes
    seq = wal.append_upsert(np.ones((2, 4), np.float32), [5, 6])
    wal.rollback_last(seq, prev)
    assert wal.seq == 1 and wal.size_bytes == prev
    assert os.path.getsize(tmp_path / "w.log") == prev
    with pytest.raises(RaftError, match="immediately follow"):
        wal.rollback_last(5, prev)
    assert wal.append_delete([2]) == 2
    assert [list(i) for *_, i in wal.replay()] == [[1], [2]]


def test_reset_truncates_but_seq_continues(tmp_path):
    obs.enable()
    before = obs.to_json()
    wal = twal.WriteAheadLog(tmp_path / "w.log", name="wal-metrics")
    wal.append_delete([1])
    wal.append_upsert(np.zeros((1, 4), np.float32), [3])
    size = wal.size_bytes
    assert size == os.path.getsize(tmp_path / "w.log") > 0
    wal.reset()
    assert wal.size_bytes == 0 and wal.seq == 2
    assert wal.append_delete([2]) == 3
    assert [s for s, *_ in wal.replay()] == [3]
    d = obs.metrics.delta(before, obs.to_json())
    assert d['raft_tpu_wal_appends_total{name="wal-metrics"}'] == 3
    assert d['raft_tpu_wal_bytes_total{name="wal-metrics"}'] == (
        size + wal.size_bytes)
    assert d['raft_tpu_wal_truncations_total{name="wal-metrics"}'] == 1
    wal.close()
    recs = list(twal.WriteAheadLog(tmp_path / "w.log", name="wal-metrics").replay())
    assert len(recs) == 1
    d = obs.metrics.delta(before, obs.to_json())
    # one record replayed above, one here
    assert d['raft_tpu_wal_replayed_total{name="wal-metrics"}'] == 2
