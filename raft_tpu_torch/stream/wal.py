"""Write-ahead log for the delta memtable: acknowledged writes survive a crash.

The port's own copy of raft_tpu/stream/wal.py; the log files are the JAX
package's byte for byte, so a log written by either package replays in the
other. The recovery contract:

    durable state = snapshot (``stream.save``, atomic)
                  + WAL records with ``seq`` > the snapshot's ``wal_seq``

- **Append-only, checksummed records.** One record per ``upsert`` /
  ``delete`` call, written at admission BEFORE the rows land in the
  memtable. Each record is ``[type u8 | seq u64 | payload_len u32 | crc32
  u32 | payload]``; a torn tail record (a crash mid-write) fails its length
  or checksum and replay stops there: a record that never finished was
  never acknowledged.
- **Batched fsync.** Every append reaches the OS (a crashed process loses
  nothing); ``fsync_every`` bounds how many records a crashed machine can
  lose (``fsync_every=1`` is synchronous durability).
- **Truncation rides snapshots.** ``stream.save()`` writes the full state
  atomically, records the last applied ``wal_seq`` and then
  :meth:`WriteAheadLog.reset`\\ s the log; a compaction with a
  ``snapshot_path`` does the same after its fold.
- **Replay** (:meth:`replay` / ``stream.load(wal=)``) applies the records
  past the snapshot's ``wal_seq`` in order through the ordinary write path,
  then re-attaches the log for new writes.

Rows travel as host numpy arrays (a tensor is copied to the host first):
the log is host state and never touches the device.

Fault points (:mod:`raft_tpu_torch.testing.faults`): ``wal/append`` (per
record, before the write), ``wal/fsync`` (before each batched fsync).
Metrics: ``raft_tpu_wal_*``, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
import struct
import threading
import zlib

import numpy as np
import torch

from ..core import serialize
from ..core.errors import RaftError, expects
from ..obs import events as obs_events
from ..obs import metrics
from ..testing import faults

__all__ = ["WriteAheadLog", "WalCorruptError"]

# record header: type (u8), seq (u64), payload length (u32), crc32 (u32)
_HDR = struct.Struct("<BQII")
_T_UPSERT, _T_DELETE = 1, 2
_DTYPES = {"float32": 0, "int8": 1, "uint8": 2}
_DTYPES_INV = {v: np.dtype(k) for k, v in _DTYPES.items()}


class WalCorruptError(RaftError):
    """A WAL record failed its checksum somewhere other than the torn
    tail — the log itself is damaged (bit rot, concurrent writer), not
    merely interrupted. Raised by :meth:`WriteAheadLog.replay` with
    ``strict=True``; the default replay stops at the first bad record
    (everything before it was acknowledged and is recovered)."""


@functools.lru_cache(maxsize=None)
def _c_appends():
    return metrics.counter("raft_tpu_wal_appends_total",
                           "WAL records appended (one per upsert/delete "
                           "call, written before the memtable)")


@functools.lru_cache(maxsize=None)
def _c_bytes():
    return metrics.counter("raft_tpu_wal_bytes_total",
                           "WAL bytes appended", unit="bytes")


@functools.lru_cache(maxsize=None)
def _c_fsyncs():
    return metrics.counter("raft_tpu_wal_fsyncs_total",
                           "batched WAL fsyncs (appends/fsyncs is the "
                           "group-commit amortization)")


@functools.lru_cache(maxsize=None)
def _g_size():
    return metrics.gauge("raft_tpu_wal_size_bytes",
                         "current WAL file size (drops to ~0 at each "
                         "snapshot-coupled truncation)", unit="bytes")


@functools.lru_cache(maxsize=None)
def _c_truncations():
    return metrics.counter("raft_tpu_wal_truncations_total",
                           "WAL truncations (snapshot save / compaction "
                           "swap with a snapshot_path)")


@functools.lru_cache(maxsize=None)
def _c_replayed():
    return metrics.counter("raft_tpu_wal_replayed_total",
                           "WAL records applied by crash-recovery replay")


def _host(a) -> np.ndarray:
    """A tensor or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _encode_upsert(seq: int, rows: np.ndarray, ids: np.ndarray) -> bytes:
    r, d = rows.shape
    payload = (struct.pack("<IIB", r, d, _DTYPES[str(rows.dtype)])
               + np.ascontiguousarray(ids, np.int64).tobytes()
               + np.ascontiguousarray(rows).tobytes())
    return _pack(_T_UPSERT, seq, payload)


def _encode_delete(seq: int, ids: np.ndarray) -> bytes:
    payload = (struct.pack("<I", len(ids))
               + np.ascontiguousarray(ids, np.int64).tobytes())
    return _pack(_T_DELETE, seq, payload)


def _pack(rtype: int, seq: int, payload: bytes) -> bytes:
    return _HDR.pack(rtype, seq, len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _decode(rtype: int, payload: bytes):
    if rtype == _T_UPSERT:
        r, d, dt = struct.unpack_from("<IIB", payload)
        off = struct.calcsize("<IIB")
        ids = np.frombuffer(payload, np.int64, count=r, offset=off)
        dtype = _DTYPES_INV[dt]
        rows = np.frombuffer(payload, dtype, count=r * d,
                             offset=off + 8 * r).reshape(r, d)
        return ("upsert", rows, ids)
    if rtype == _T_DELETE:
        (n,) = struct.unpack_from("<I", payload)
        ids = np.frombuffer(payload, np.int64, count=n, offset=4)
        return ("delete", None, ids)
    raise WalCorruptError(f"unknown WAL record type {rtype}")


class WriteAheadLog:
    """One shard's (or one unsharded index's) write-ahead log (see module
    doc). ``fsync_every`` batches fsyncs across that many appends
    (``flush()``/``reset()`` always sync); ``name`` labels the metrics.
    Opening an existing file scans it to recover the last sequence number,
    so appends continue a prior process's numbering — sequence numbers are
    the snapshot/replay coordination and must never restart."""

    def __init__(self, path, *, fsync_every: int = 8,
                 name: str = "default"):
        self.path = os.fspath(path)
        self.name = name
        self.fsync_every = int(fsync_every)
        expects(self.fsync_every >= 1, "fsync_every must be >= 1, got %d",
                self.fsync_every)
        self._lock = threading.Lock()
        self._pending = 0
        self._seq = 0
        self._size = 0
        for seq, _rtype, _payload in self._scan():
            self._seq = seq
        if self.last_scan["torn"]:
            # drop the torn tail BEFORE appending: new records written
            # after garbage bytes would be unreachable to replay (which
            # stops at the first bad record)
            with open(self.path, "r+b") as f:
                f.truncate(self.last_scan["good_bytes"])
        # a CORRUPT record (complete bytes, bad checksum) is evidence of
        # damage, not interruption — it is preserved, replay surfaces it
        # (strict=True raises), and APPENDS refuse: a record written past
        # it would be unreachable to replay, silently un-acknowledging it.
        # reset() (an explicit truncation) clears the condition.
        self._corrupt = self.last_scan["corrupt"]
        fresh = not os.path.exists(self.path)
        self._f = open(self.path, "ab")
        if fresh:
            # make the file's DIRECTORY entry crash-durable — fsyncing
            # record bytes into a file whose creation a machine crash can
            # drop would lose the whole log
            serialize.fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        self._size = self._f.tell()
        self._set_size_gauge()

    # -- append side --------------------------------------------------------
    def append_upsert(self, rows, ids) -> int:
        """Log one upsert (rows + their global ids); returns the record's
        ``seq``. Called BEFORE the memtable insert — the write-ahead
        contract."""
        rows = _host(rows)
        ids = np.asarray(_host(ids), np.int64)
        with self._lock:
            seq = self._seq + 1
            self._append_locked(_encode_upsert(seq, rows, ids))
            self._seq = seq
        return seq

    def append_delete(self, ids) -> int:
        """Log one delete (global ids); returns the record's ``seq``."""
        ids = np.asarray(_host(ids), np.int64).reshape(-1)
        with self._lock:
            seq = self._seq + 1
            self._append_locked(_encode_delete(seq, ids))
            self._seq = seq
        return seq

    def _append_locked(self, rec: bytes) -> None:
        if self._corrupt:
            raise WalCorruptError(
                f"WAL {self.path!r} holds a corrupt record — appending "
                "past it would make this write unreachable to replay; "
                "recover (stream.load(wal=)), snapshot, and reset() first")
        faults.fire("wal/append", name=self.name, seq=self._seq + 1)
        self._f.write(rec)
        # always reach the OS (a dead *process* loses nothing); fsync in
        # batches (a dead *machine* can lose at most fsync_every-1 records)
        self._f.flush()
        self._size += len(rec)
        self._pending += 1
        if self._pending >= self.fsync_every:
            self._fsync_locked()
        if metrics._enabled:
            _c_appends().inc(1, name=self.name)
            _c_bytes().inc(len(rec), name=self.name)
            self._set_size_gauge()

    def _fsync_locked(self) -> None:
        faults.fire("wal/fsync", name=self.name)
        os.fsync(self._f.fileno())
        self._pending = 0
        if metrics._enabled:
            _c_fsyncs().inc(1, name=self.name)

    def flush(self) -> None:
        """Force the batched fsync now (close of a write burst)."""
        with self._lock:
            self._f.flush()
            if self._pending:
                self._fsync_locked()

    def _set_size_gauge(self) -> None:
        if metrics._enabled:
            _g_size().set(self._size, name=self.name)

    @property
    def seq(self) -> int:
        """The last appended sequence number (0 = empty log)."""
        with self._lock:
            return self._seq

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return self._size

    def rollback_last(self, seq: int, prev_size: int) -> None:
        """Remove the record just appended as ``seq`` — the write it
        logged failed on EVERY twin, so the caller is about to raise and
        replaying the record at recovery would resurrect a write the
        application was told did not land. Only valid immediately after
        the matching append with no append in between (the group write
        lock guarantees that)."""
        with self._lock:
            expects(self._seq == seq and prev_size <= self._size,
                    "rollback_last(%d) must immediately follow the "
                    "matching append (log at seq %d)", seq, self._seq)
            self._f.flush()
            self._f.truncate(prev_size)
            os.fsync(self._f.fileno())
            self._seq = seq - 1
            self._size = prev_size
            self._pending = 0  # nothing un-synced survives the truncate
            self._set_size_gauge()

    # -- truncation ---------------------------------------------------------
    def reset(self) -> None:
        """Truncate the log: everything it covered is now in a durable
        snapshot (``stream.save`` calls this AFTER its atomic rename — the
        crash-ordering that can lose nothing: crash before the rename keeps
        old snapshot + full log, crash between rename and reset keeps new
        snapshot + a log whose records are all <= its ``wal_seq`` and
        replay skips them). Sequence numbering continues — it coordinates
        with snapshots and must never restart."""
        with self._lock:
            self._f.close()
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            dropped = self._size
            self._f = open(self.path, "ab")
            self._pending = 0
            self._size = 0
            self._corrupt = False  # explicit truncation clears the damage
            if metrics._enabled:
                _c_truncations().inc(1, name=self.name)
                self._set_size_gauge()
        obs_events.emit("wal_truncated",
                        subject=("wal", self.name, None, None),
                        evidence={"dropped_bytes": dropped,
                                  "path": self.path})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                if self._pending:
                    self._fsync_locked()
                self._f.close()

    # -- replay side --------------------------------------------------------
    def _scan(self):
        """Yield ``(seq, rtype, payload)`` for every intact record; stops
        at the first bad one. ``self.last_scan`` distinguishes a **torn**
        tail (incomplete bytes at EOF — a crash mid-append; tolerated,
        truncated at reopen) from a **corrupt** record (complete bytes
        failing their checksum — bit rot or a foreign writer; preserved
        as evidence, surfaced by ``replay(strict=True)``), and records the
        byte offset of the last intact record."""
        self.last_scan = {"records": 0, "torn": False, "corrupt": False,
                          "good_bytes": 0}
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if not hdr:
                    return
                if len(hdr) < _HDR.size:
                    self.last_scan["torn"] = True
                    return
                rtype, seq, plen, crc = _HDR.unpack(hdr)
                payload = f.read(plen)
                if len(payload) < plen:
                    self.last_scan["torn"] = True
                    return
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    self.last_scan["corrupt"] = True
                    return
                self.last_scan["records"] += 1
                self.last_scan["good_bytes"] = f.tell()
                yield seq, rtype, payload

    def replay(self, after_seq: int = 0, *, strict: bool = False):
        """Yield ``(seq, kind, rows, ids)`` for every intact record with
        ``seq > after_seq`` (the snapshot's ``wal_seq``), in append order.
        A torn tail (crash mid-append: the record was never acknowledged)
        is always tolerated; a CORRUPT record — complete bytes failing
        their checksum — stops replay there by default, and with
        ``strict=True`` raises :class:`WalCorruptError` instead, so
        operators can tell interruption from damage."""
        n = 0
        for seq, rtype, payload in self._scan():
            if seq <= after_seq:
                continue
            kind, rows, ids = _decode(rtype, payload)
            n += 1
            yield seq, kind, rows, ids
        if strict and self.last_scan["corrupt"]:
            raise WalCorruptError(
                f"WAL {self.path!r} has a corrupt record after "
                f"{self.last_scan['records']} intact ones")
        if n and metrics._enabled:
            _c_replayed().inc(n, name=self.name)
        if n:
            obs_events.emit(
                "wal_recovered",
                severity="warning" if self.last_scan["corrupt"] else "info",
                subject=("wal", self.name, None, None),
                evidence={"replayed": n,
                          "torn_tail": self.last_scan["torn"],
                          "corrupt": self.last_scan["corrupt"]})
