"""Out-of-core corpus access: the chunked reader and the chunk stager.

Counterpart of raft_tpu/core/chunked.py. A build that opens with one device
tensor the size of the corpus is capped by its build peak, not by what the
index needs; this module is the seam that removes that ceiling:

- :class:`ChunkedReader` wraps a 2-D row-sliceable source (an ``np.memmap``
  over a corpus file, or a plain ``np.ndarray``, which is how compaction
  folds reuse the path) and hands it out in fixed-size row chunks. All four
  builds of ``neighbors/`` take it duck-typed (:func:`is_reader`): the list
  fill and the PQ encode run per tile over the staged chunks and scatter
  into the sealed list layout, so the device holds the index plus two
  staged chunks, never the corpus.
- :class:`ChunkStager` moves chunks host → device: two pinned host buffers
  and two device slots, each upload a ``copy_(non_blocking=True)`` on a side
  ``torch.cuda.Stream``, so chunk N+1's upload overlaps chunk N's assign and
  encode on the consuming stream. Staging bytes stay constant (two chunks a
  side) whatever the corpus size.
- :func:`take_rows` is the trainset seam: the coarse trainer draws the same
  indices in both modes (one ``torch.Generator`` on the handle's device) and
  gathers them through it, by a device gather in-core and a host gather off
  the reader streamed. Rows are bit-equal either way, since gathering
  commutes with the elementwise ingest conversions.
- :func:`row_tiles` feeds per-row passes fixed-size tiles at the same global
  row offsets in both modes, so every product and reduction a row goes
  through has the same shape, and the same reduction order, whether the rows
  came from one tensor or from chunks.

The contract (``tests/test_torch_ooc_build.py``): a streamed build equals
the in-core build of the same rows bit for bit, in every tensor field.

The JAX module's ``stage_fns`` / ``_place_fns`` (jitted programs that donate
the old device buffer to the new upload) have no counterpart: a device slot
written again in stream order, after the consumer's work on it, is how the
same constant staging footprint comes about under PyTorch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .errors import expects

__all__ = ["DEFAULT_CHUNK_ROWS", "STREAM_EXTEND_BYTES", "ChunkedReader", "ChunkStager",
           "is_reader", "take_rows", "materialize", "converted", "device_materialize",
           "row_tiles", "device_dtype", "torch_dtype", "maybe_reader"]

# the streaming granule: 64k rows x 128 d x f32 = 32 MiB a chunk, so two
# staged chunks stay well inside the default 2 GiB workspace
DEFAULT_CHUNK_ROWS = 65536

_TORCH_OF = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
             np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
             np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32}


# an IVF extend streams a host ndarray past this size through its chunked
# path in place of one whole-batch upload, as the JAX package does
STREAM_EXTEND_BYTES = 256 << 20


def device_dtype(dtype) -> np.dtype:
    """The dtype host rows of ``dtype`` take on the device: float64 lands as
    float32 and int64 as int32 (4 bytes an element at most, as in the JAX
    package); every other dtype as itself."""
    dt = np.dtype(dtype)
    return {np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.int64): np.dtype(np.int32)}.get(dt, dt)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of :func:`device_dtype`."""
    dt = device_dtype(dtype)
    expects(dt in _TORCH_OF, "unsupported corpus dtype %s", np.dtype(dtype))
    return _TORCH_OF[dt]


def is_reader(x) -> bool:
    """Whether ``x`` is a chunked reader (anything with ``chunks()``,
    ``take()`` and ``chunk_rows``); arrays and tensors take the in-core
    path."""
    return hasattr(x, "chunks") and hasattr(x, "take") and hasattr(x, "chunk_rows")


def maybe_reader(x):
    """``x`` wrapped in a :class:`ChunkedReader` when it is a 2-D host
    ndarray past :data:`STREAM_EXTEND_BYTES` (an extend then streams it),
    else ``x`` itself."""
    if (not is_reader(x) and isinstance(x, np.ndarray) and x.ndim == 2
            and x.nbytes > STREAM_EXTEND_BYTES):
        return ChunkedReader(x)
    return x


class ChunkedReader:
    """Fixed-size row chunks over a 2-D corpus that need not fit in memory
    (an ``np.memmap``: its slices are lazy views whose pages fault in per
    chunk)."""

    def __init__(self, source, *, chunk_rows: int = DEFAULT_CHUNK_ROWS):
        expects(hasattr(source, "ndim") and hasattr(source, "shape")
                and hasattr(source, "dtype"),
                "ChunkedReader needs an array-like source (np.memmap, np.ndarray, ...)")
        expects(source.ndim == 2, "corpus must be (n, d)")
        expects(source.shape[0] > 0 and source.shape[1] > 0, "corpus must be non-empty")
        expects(int(chunk_rows) >= 1, "chunk_rows must be >= 1")
        self._src = source
        self.chunk_rows = min(int(chunk_rows), int(source.shape[0]))

    @classmethod
    def from_file(cls, path, *, dtype=None, shape=None,
                  chunk_rows: int = DEFAULT_CHUNK_ROWS, mode: str = "r") -> "ChunkedReader":
        """Open an on-disk corpus without reading it: ``.npy`` files map
        through ``np.load(mmap_mode=)``; raw binary needs ``dtype`` and
        ``shape``."""
        p = str(path)
        if p.endswith(".npy"):
            src = np.load(p, mmap_mode=mode)
        else:
            expects(dtype is not None and shape is not None,
                    "raw corpus files need dtype= and shape=")
            src = np.memmap(p, dtype=np.dtype(dtype), mode=mode,
                            shape=tuple(int(s) for s in shape))
        return cls(src, chunk_rows=chunk_rows)

    @property
    def shape(self):
        return tuple(int(s) for s in self._src.shape)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self._src.dtype

    @property
    def nbytes(self) -> int:
        n, d = self.shape
        return n * d * self._src.dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def n_chunks(self) -> int:
        return -(-self.shape[0] // self.chunk_rows)

    def chunks(self):
        """Yield ``(start, block)`` in row order; ``block`` is a lazy host
        slice of ``chunk_rows`` rows (the last may be short)."""
        n, cr = self.shape[0], self.chunk_rows
        for start in range(0, n, cr):
            yield start, self._src[start:start + cr]

    def take(self, idx):
        """Host gather of the given rows (the trainset seam): touches only
        the selected pages and returns a fresh host array."""
        return np.asarray(self._src[np.asarray(idx)])

    def host_view(self):
        """The backing array (memmap or ndarray), zero-copy: what a
        ``MutableIndex(dataset=reader)`` keeps as its row store."""
        return self._src


class _ConvertedReader:
    """A reader whose ``take`` / ``materialize`` return device tensors in a
    build's working domain (byte shift, float32 upcast): how the coarse
    trainer sees a raw corpus."""

    def __init__(self, reader, convert, device):
        self._reader = reader
        self._convert = convert
        self.device = torch.device(device)
        self.chunk_rows = reader.chunk_rows

    @property
    def shape(self):
        return self._reader.shape

    ndim = 2

    @property
    def dtype(self):
        return self._reader.dtype

    def chunks(self):
        return self._reader.chunks()

    def take(self, idx):
        rows = self._reader.take(np.asarray(idx))
        return self._convert(torch.from_numpy(np.ascontiguousarray(rows)).to(self.device))

    def materialize(self):
        return self._convert(device_materialize(self._reader, device=self.device))


def converted(reader, convert, device) -> _ConvertedReader:
    """Wrap ``reader`` so gathered rows come back on ``device`` through
    ``convert`` (raw rows -> the build's working domain, elementwise)."""
    return _ConvertedReader(reader, convert, device)


def _host_index(idx):
    return idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)


def take_rows(x, idx):
    """Rows ``idx`` of ``x`` with one meaning in both modes: a device gather
    for a tensor, a host gather (one copy of ``idx`` to the host) for a
    reader, whose converted form uploads them."""
    if is_reader(x):
        return x.take(_host_index(idx))
    return x[idx]


def materialize(x, device=None):
    """The whole corpus: a converted reader's device image, a raw reader
    streamed onto ``device``, a tensor as it is."""
    if hasattr(x, "materialize"):
        return x.materialize()
    if is_reader(x):
        return device_materialize(x, device=device)
    return x


class ChunkStager:
    """Double-buffered host → device chunk staging.

    On a CUDA device: two pinned host buffers and two device slots; chunk N
    goes through buffer and slot N % 2. Its upload is a non-blocking copy
    on a side stream, which first waits for the consumer's work on the
    chunk that last used the slot (N - 2: all of it was queued before chunk
    N - 1 was staged, where an event marks the consuming stream). The host
    buffer is rewritten only after its last upload's event has completed —
    rewriting it under a copy in flight is the use-after-rewrite race the
    JAX stager avoids with an immutable staged copy a chunk. The consuming
    stream waits on the upload's event before the caller's kernels read the
    slot. On the CPU the slot is filled in place.

    :meth:`stage` returns the padded ``(chunk_rows, dim)`` slot (a short
    tail chunk zero-padded); it stays valid until the stage call two after
    it, so a caller finishes with a chunk before staging the one after
    next. The ledger carries both sides under ``build/staging``."""

    def __init__(self, chunk_rows: int, dim: int, dtype, *, kind: str = "build",
                 device=None):
        from ..obs import build as build_metrics
        from ..obs import mem as obs_mem
        from ..obs import metrics
        from .resources import default_resources

        expects(int(chunk_rows) >= 1 and int(dim) >= 1,
                "stager needs chunk_rows >= 1 and dim >= 1")
        self.chunk_rows = int(chunk_rows)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.kind = str(kind)
        self.device = (default_resources().torch_device if device is None
                       else torch.device(device))
        dev_dt = device_dtype(self.dtype)
        tdt = torch_dtype(self.dtype)
        shape = (self.chunk_rows, self.dim)
        self._cuda = self.device.type == "cuda"
        self._slots = [torch.empty(shape, dtype=tdt, device=self.device) for _ in range(2)]
        if self._cuda:
            self._host = [torch.empty(shape, dtype=tdt, pin_memory=True) for _ in range(2)]
            self._stream = torch.cuda.Stream(device=self.device)
            self._uploaded = [None, None]   # each host buffer's last upload event
            self._consumed = None           # consumer mark at the previous stage call
            self._timing = []               # (start, end) events of each upload
        else:
            self._host = self._slots
        self._host_np = [h.numpy() for h in self._host]
        self._uploads = 0
        self._staged_bytes = 0
        self._host_s = 0.0
        chunk_bytes = self.chunk_rows * self.dim * dev_dt.itemsize
        self._mem = obs_mem.account("build/staging", name=self.kind,
                                    host_bytes=2 * chunk_bytes,
                                    device_bytes=2 * chunk_bytes, owner=self)
        self._chunk_bytes = chunk_bytes
        if metrics.enabled():
            build_metrics.ooc_chunk_rows().set(self.chunk_rows, kind=self.kind)

    @property
    def host_bytes(self) -> int:
        return 2 * self._chunk_bytes

    def stage(self, block):
        """Copy ``block`` (<= chunk_rows host rows) into the next host
        buffer, zero-padding a short chunk, and start its upload. Returns
        the device slot (see the class docstring for its lifetime)."""
        from ..obs import build as build_metrics
        from ..obs import metrics

        n = int(block.shape[0])
        expects(n <= self.chunk_rows and tuple(block.shape[1:]) == (self.dim,),
                "stage: block of shape %s does not fit (%d, %d)", tuple(block.shape),
                self.chunk_rows, self.dim)
        i = self._uploads % 2
        if self._cuda and self._uploaded[i] is not None:
            self._uploaded[i].synchronize()
        t0 = time.perf_counter()
        buf = self._host_np[i]
        np.copyto(buf[:n], block, casting="unsafe")
        if n < self.chunk_rows:
            buf[n:] = 0
        self._host_s += time.perf_counter() - t0
        slot = self._slots[i]
        if self._cuda:
            consumer = torch.cuda.current_stream(self.device)
            if self._consumed is not None:
                self._stream.wait_event(self._consumed)
            self._consumed = consumer.record_event()
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self._stream):
                start.record(self._stream)
                slot.copy_(self._host[i], non_blocking=True)
                done.record(self._stream)
            self._uploaded[i] = done
            self._timing.append((start, done))
            consumer.wait_event(done)
        self._uploads += 1
        self._staged_bytes += self._chunk_bytes
        if metrics.enabled():
            build_metrics.ooc_staged_bytes().inc(self._chunk_bytes, kind=self.kind)
        return slot

    def stats(self) -> dict:
        """Uploads, bytes staged and the two sides' staging bytes; on a card
        also the uploads' device seconds (waits for them to finish)."""
        out = {"uploads": self._uploads, "staged_bytes": self._staged_bytes,
               "host_bytes": self.host_bytes, "device_bytes": 2 * self._chunk_bytes,
               "pinned": self._cuda, "host_copy_seconds": self._host_s}
        if self._cuda:
            self._stream.synchronize()
            out["upload_seconds"] = sum(a.elapsed_time(b) for a, b in self._timing) / 1e3
        return out

    def release(self) -> None:
        """Drop the ledger entry and the buffers (after the uploads end)."""
        from ..obs import mem as obs_mem

        if self._mem is not None:
            obs_mem.release(self._mem)
            self._mem = None
        if self._cuda:
            self._stream.synchronize()


def device_materialize(reader, *, stager: ChunkStager | None = None,
                       kind: str = "build", device=None):
    """Stream a reader into one device tensor of its device dtype, by slice
    assignment of each staged chunk: for the kinds whose index stores the
    dataset itself (brute force, CAGRA). The corpus still ends up on the
    device whole, but arrives through the staged pipeline, without a second
    full-size host copy."""
    from ..obs import build as build_metrics
    from ..obs import metrics

    n, d = reader.shape
    own = stager is None
    if own:
        stager = ChunkStager(reader.chunk_rows, d, reader.dtype, kind=kind, device=device)
    dst = torch.empty((n, d), dtype=stager._slots[0].dtype, device=stager.device)
    try:
        for start, block in reader.chunks():
            nv = int(block.shape[0])
            dst[start:start + nv].copy_(stager.stage(block)[:nv])
            if metrics.enabled():
                build_metrics.ooc_chunks().inc(1, kind=kind, stage="materialize")
    finally:
        if own:
            stager.release()
    return dst


def row_tiles(src, tile: int, *, stager: ChunkStager | None = None, ingest=None,
              kind: str = "build", stage: str = "fill"):
    """Yield ``(start, rows)``: the rows of ``src`` in tiles of ``tile``
    rows at global offsets 0, tile, 2·tile, ... (the last tile short), for
    a tensor or a reader alike.

    A tensor's tiles are its row slices. A reader's chunks are staged
    through ``stager`` and converted by ``ingest``; a tile that straddles
    two chunks is assembled in a carry buffer. Either way a per-row pass
    over the tiles issues every product and reduction at the same shapes
    on the same rows, so its results do not depend on where the rows came
    from. A yielded tile is valid until the next one is asked for."""
    from ..obs import build as build_metrics
    from ..obs import metrics

    tile = int(tile)
    expects(tile >= 1, "row_tiles: tile must be >= 1")
    if not is_reader(src):
        for i in range(0, int(src.shape[0]), tile):
            yield i, src[i:i + tile]
        return
    expects(stager is not None, "row_tiles: a reader needs a stager")
    carry, fill, g0 = None, 0, 0
    emit = metrics.enabled()
    for _, block in src.chunks():
        nv = int(block.shape[0])
        v = stager.stage(block)[:nv]
        if ingest is not None:
            v = ingest(v)
        pos = 0
        if fill:
            take = min(tile - fill, nv)
            carry[fill:fill + take] = v[:take]
            fill += take
            pos = take
            if fill == tile:
                yield g0, carry
                g0 += tile
                fill = 0
        while nv - pos >= tile:
            if pos % 8 == 0:
                yield g0, v[pos:pos + tile]
            else:
                # an unaligned view could take another GEMM kernel than the
                # in-core tile at the same shape: copy it to the carry
                if carry is None:
                    carry = torch.empty((tile,) + tuple(v.shape[1:]), dtype=v.dtype,
                                        device=v.device)
                carry.copy_(v[pos:pos + tile])
                yield g0, carry
            g0 += tile
            pos += tile
        if pos < nv:
            if carry is None:
                carry = torch.empty((tile,) + tuple(v.shape[1:]), dtype=v.dtype,
                                    device=v.device)
            carry[:nv - pos] = v[pos:nv]
            fill = nv - pos
        if emit:
            build_metrics.ooc_chunks().inc(1, kind=kind, stage=stage)
    if fill:
        yield g0, carry[:fill]
