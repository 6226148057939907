"""Reusable staging buffers for the serve flush path.

Counterpart of raft_tpu/serve/staging.py. Without staging, every flush
allocates: the batcher concatenates the drained rows into a fresh host
array, pads it with another, and the searcher's own ``.to(device)`` starts
the upload late. :class:`StagingBuffers` replaces that with:

- **Per-bucket reusable host buffers.** Each bucket owns ``depth + 2``
  preallocated host tensors, pinned (page-locked) when the stream serves a
  CUDA index, used round-robin: assembly writes rows in place and zeroes
  the pad tail. The window is depth + 2, not depth + 1: the completion
  worker pops an entry from the bounded stage before materializing it, so
  when the flush worker unblocks and stages the next batch, the popped
  flush's buffer is still pending its canary tap beside the ``depth``
  queued ones and the one being staged.
- **Early upload.** :meth:`stage` starts the host-to-device copy at drain
  time (``copy_(non_blocking=True)`` from the pinned buffer) before the
  searcher is called.
- **A persistent device slot per bucket.** The upload lands in the same
  device tensor every flush, so device bytes stay constant (the
  ``serve/staging`` ledger entry proves it). The slot is rewritten in
  stream order: the flush worker stages and dispatches on one stream, so
  the copy into a slot is queued behind every kernel of the previous flush
  that reads it.

An asynchronous copy reads the pinned buffer after ``copy_`` has
returned. A CUDA event is recorded after each upload, and :meth:`stage`
waits on the event of the buffer it is about to rewrite, so the card never
reads rows of a later flush.

Without a CUDA device (``device`` None or the CPU) the buffers are plain
host memory and :meth:`stage` hands the searcher a CPU tensor over the
buffer itself: there is no upload.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.errors import expects
from ..obs import dispatch as obs_dispatch
from ..obs import mem as obs_mem

__all__ = ["StagingBuffers", "warm_staging"]

_TORCH_DTYPES = {"float32": torch.float32, "int8": torch.int8, "uint8": torch.uint8}


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class StagingBuffers:
    """Per-bucket staging for one serve stream (see module docstring).
    ``buckets`` is the stream's batch ladder, ``dim``/``dtype`` the stream
    row contract, ``depth`` the pipeline depth the buffer rotation must
    cover, ``device`` where the searcher's index lives (a CUDA device
    enables pinned buffers, device slots and early uploads)."""

    def __init__(self, buckets, dim: int, dtype: str, *, depth: int = 2,
                 device=None, stream: str = "default"):
        expects(int(dim) >= 1, "staging dim must be >= 1")
        expects(str(dtype) in _TORCH_DTYPES, "staging dtype must be one of %s, got %r",
                sorted(_TORCH_DTYPES), dtype)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.device = None if device is None else torch.device(device)
        self.stream = stream
        self._pinned = _cuda(self.device)
        self._n_host = max(2, int(depth) + 2)
        self._lock = threading.Lock()
        tdt = _TORCH_DTYPES[str(dtype)]
        self._host = {b: [torch.zeros((b, self.dim), dtype=tdt, pin_memory=self._pinned)
                          for _ in range(self._n_host)]
                      for b in self.buckets}
        # the upload event of each host buffer: set when its copy was queued,
        # waited on before the buffer is written again
        self._events = {b: [None] * self._n_host for b in self.buckets}
        self._turn = {b: 0 for b in self.buckets}
        self._slots: dict[int, torch.Tensor] = {}
        self._uploads = 0
        self._slot_reuses = 0
        self._mem = obs_mem.account("serve/staging", name=stream,
                                    host=self._host_buffers(), owner=self)

    def _host_buffers(self) -> list:
        return [buf for bufs in self._host.values() for buf in bufs]

    def stage(self, blocks, n_valid: int, bucket: int):
        """Assemble ``blocks`` (a list of (r, dim) host arrays totalling
        ``n_valid`` rows) into the bucket's next staging buffer, zero the
        pad tail, and start the device upload. Returns ``(host_view,
        queries)`` — the host view (NumPy) stays valid until this flush's
        completion (the rotation contract); ``queries`` is the tensor the
        flush function dispatches on (the device slot, or on the CPU the
        buffer itself)."""
        expects(bucket in self._host,
                "bucket %d is not on the staging ladder %s", bucket,
                self.buckets)
        with self._lock:
            turn = self._turn[bucket]
            self._turn[bucket] = (turn + 1) % self._n_host
            ev = self._events[bucket][turn]
        if ev is not None:
            ev.synchronize()   # the copy that last read this buffer has landed
        host = self._host[bucket][turn]
        buf = host.numpy()
        off = 0
        for r in blocks:
            nr = len(r)
            buf[off:off + nr] = r
            off += nr
        if n_valid < bucket:
            buf[n_valid:] = 0
        dev = self._upload(bucket, turn, host)
        obs_dispatch.note(1)
        return buf, dev

    def _upload(self, bucket: int, turn: int, host: torch.Tensor):
        self._uploads += 1
        if not self._pinned:
            return host
        with self._lock:
            slot = self._slots.get(bucket)
        grew = slot is None
        if grew:
            slot = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            with self._lock:
                self._slots[bucket] = slot
        else:
            self._slot_reuses += 1
        slot.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._events[bucket][turn] = ev
        if grew:
            with self._lock:
                device = list(self._slots.values())
            obs_mem.reaccount(self._mem, host=self._host_buffers(), device=device)
        return slot

    def stats(self) -> dict:
        """Staging counters: uploads, uploads into an existing slot, and the
        accounted byte levels that must stay flat across flushes."""
        host = sum(int(buf.nbytes) for buf in self._host_buffers())
        with self._lock:  # the flush worker inserts slots concurrently
            slots = list(self._slots.values())
        return {"uploads": self._uploads,
                "slot_reuses": self._slot_reuses,
                "host_bytes": host,
                "device_bytes": sum(int(s.nbytes) for s in slots),
                "buckets_resident": len(slots),
                "pinned": self._pinned}

    def release(self) -> None:
        """Drop the ledger entry and slots (stream close)."""
        if self._mem is not None:
            obs_mem.release(self._mem)
            self._mem = None
        with self._lock:
            self._slots.clear()


def warm_staging(buckets, dim: int, dtype: str, device=None,
                 searcher=None, ks=()) -> int:
    """Run the staging path once per bucket ahead of the hot path — the
    staging leg of the publish warm ladder: on a CUDA ``device``, a pinned
    host buffer and a device tensor of each bucket's shape (the caching
    allocators keep their blocks). ``searcher``/``ks``: run the published
    searcher once per (bucket, k) on the device-resident queries, the form
    the pipelined flush dispatches. Returns the number of buckets warmed."""
    n = 0
    tdt = _TORCH_DTYPES[str(dtype)]
    cuda = _cuda(device)
    for b in sorted(set(int(b) for b in buckets)):
        staged = torch.zeros((b, int(dim)), dtype=tdt, pin_memory=cuda)
        if cuda:
            staged = staged.to(device, non_blocking=True)
        if searcher is not None:
            for k in ks:
                out = searcher(staged, int(k))
                if cuda:
                    torch.cuda.current_stream(torch.device(device)).synchronize()
                del out
        n += 1
    return n
