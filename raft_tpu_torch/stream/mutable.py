"""MutableIndex: an LSM-style mutable lifecycle over any sealed ANN index.

Counterpart of raft_tpu/stream/mutable.py, the fresh/sealed split of
FreshDiskANN (Singh et al. 2021), which is the memtable / compaction shape of
LSM-trees applied to ANN:

- **Delta memtable** — recent writes land in a fixed-capacity row buffer
  scanned by exact brute force at serve time. The buffer is exposed to the
  device at power-of-two *bucket* sizes (8, 16, ..., ``delta_capacity``), so
  the scan runs at a few fixed shapes; from the 4,096-row bucket on, that
  scan is the ``fused_knn`` kernel (``brute_force.knn``'s shape gate), below
  it the GEMM + plain top-k route.
- **Tombstones** — deletes flip per-slot alive bits: the sealed index is
  filtered through its module's ``sample_filter=`` (for IVF-PQ a packed
  bitset that ``pq_scan_topk`` reads; packed once per write, never per
  search), the delta through the keep-mask of its exact scan. ``upsert`` =
  tombstone the old slot + insert the new row, so an id is live in exactly
  one slot at a time.
- **Unified search** — sealed (filtered) and delta candidates merge through
  the plain top-k (``select_k_impl(impl="torch")``: k + kd columns); slot
  ids translate to global ids through a device id map, with the shared
  ``-1`` / ``±inf`` sentinel in slots the live rows cannot fill. No host
  sync is added on the search path.
- **Compaction** — :meth:`MutableIndex.compact` folds delta and tombstones
  into a new sealed index off the write lock (``extend`` for the IVF kinds,
  a rebuild otherwise or to reclaim tombstones) and swaps it in; writes
  that land during a fold carry over.

**Replace, never mutate.** A torch tensor can be written in place, a JAX
array cannot; the JAX design leans on the latter. Here every device handle a
reader can snapshot — ``delta_view``, ``sealed_keep_dev``, ``id_map_dev`` —
is a fresh tensor built before it is published by one attribute assignment,
and no published tensor is written again. Writers publish the sealed mask
first and the delta second; readers read the delta first and the sealed
mask second, so one result row never holds both copies of an upserted id.
All device work runs on the device's current stream, and host rows reach
the device by blocking copies, so no host buffer is rewritten under an
upload in flight; a tiered store's side-stream uploads keep the same rule
with an event a pinned buffer and a fresh device tensor an upload
(``stream/tiered.py``).

Entry points run on the sealed index's device (``device=`` moves it); a
``res`` that names another device raises, as the indexes do.

Files: :func:`save` / :func:`load` write and read the JAX package's
``stream`` section byte for byte, so a JAX-saved mutable index loads here
and the port's file of the same state is the JAX file.

A ``ChunkedReader`` ``dataset=`` keeps the reader's backing array (an
``np.memmap`` stays disk-backed) as the row store, and
``compact("rebuild", ooc_chunk_rows=)`` streams the rebuild through the
out-of-core build.

``storage="tiered"`` keeps the retained rows cold behind a
:class:`~raft_tpu_torch.stream.tiered.TieredStore` (host RAM, an mmap file
per ``tier.disk_path``, or an adopted memmap): ``search_refined`` gathers
its candidates through :meth:`TieredStore.fetch` instead of a full device
copy, ``exact_search`` scans the cold rows in fixed-shape chunks
(:meth:`MutableIndex._chunked_store_scan`), folds carry the residency over
and files save it. The answers are the all-HBM twin's: ``search`` and
``search_refined`` bit for bit; the chunked oracle's ids, and its distances
where a chunk takes the fused route (on the GEMM route a float32 sum can
depend on how many rows one product holds).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core import chunked
from ..core.errors import RaftError, expects
from ..core.resources import Resources, default_resources
from ..distance.types import DistanceType, resolve_metric
from ..neighbors.sample_filter import BitsetFilter
from ..obs import dispatch as obs_dispatch
from ..obs import mem as obs_mem
from ..obs import metrics
from ..serve.errors import OverloadedError
from ..testing import faults
from .tiered import TieredStore, TierPolicy, mirror_gather, shift_slots

__all__ = ["MutableIndex", "DeltaFullError", "DELTA_MIN_BUCKET",
           "delta_buckets", "check_upsert_ids", "save", "load"]

# floor of the delta bucket ladder: an empty delta still scans one fully
# masked bucket of this size, so "delta empty" and "delta tiny" share a path
DELTA_MIN_BUCKET = 8


class DeltaFullError(OverloadedError):
    """The delta memtable is at capacity. Writes shed load exactly like the
    serve queue bound (this IS an ``OverloadedError``): compact, or attach a
    :class:`raft_tpu_torch.stream.Compactor` whose delta-fill watermark
    folds the memtable before it fills."""


def delta_buckets(capacity: int) -> tuple[int, ...]:
    """The delta memtable's power-of-two device-shape ladder
    ``(8, 16, ..., capacity)``."""
    expects(capacity >= DELTA_MIN_BUCKET
            and (capacity & (capacity - 1)) == 0,
            "delta_capacity must be a power of two >= %d, got %d",
            DELTA_MIN_BUCKET, capacity)
    out, b = [], DELTA_MIN_BUCKET
    while b <= capacity:
        out.append(b)
        b *= 2
    return tuple(out)


def _bucket_for(n: int, capacity: int) -> int:
    b = DELTA_MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, capacity)


def check_upsert_ids(ids, r: int) -> np.ndarray:
    """Validate caller-chosen upsert ids: shape ``(r,)``, unique within the
    call, ``>= 0`` and int32-representable (the device id maps are int32).
    Returns them as int64."""
    gids = np.asarray(_host(ids), np.int64).reshape(-1)
    expects(gids.shape == (r,), "ids must match rows (%d)", r)
    expects(np.unique(gids).size == r,
            "upsert ids must be unique within one call")
    expects(int(gids.min()) >= 0, "ids must be >= 0")
    expects(int(gids.max()) < 2 ** 31 - 1,
            "ids must fit int32 (device id maps are int32)")
    return gids


def _host(a):
    """A tensor or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# -- metrics (the JAX package's names) ---------------------------------------

@functools.lru_cache(maxsize=None)
def _g_delta_fill():
    return metrics.gauge("raft_tpu_stream_delta_fill",
                         "delta memtable fill fraction (rows / capacity)")


@functools.lru_cache(maxsize=None)
def _g_delta_rows():
    return metrics.gauge("raft_tpu_stream_delta_rows",
                         "rows currently in the delta memtable")


@functools.lru_cache(maxsize=None)
def _g_tombstone():
    return metrics.gauge(
        "raft_tpu_stream_tombstone_ratio",
        "dead sealed slots / sealed slots (reclaimable by rebuild compaction)")


@functools.lru_cache(maxsize=None)
def _c_upserts():
    return metrics.counter("raft_tpu_stream_upserts_total",
                           "rows upserted into the delta memtable")


@functools.lru_cache(maxsize=None)
def _c_deletes():
    return metrics.counter("raft_tpu_stream_deletes_total",
                           "live rows tombstoned by delete/upsert")


@functools.lru_cache(maxsize=None)
def _c_delta_full():
    return metrics.counter("raft_tpu_stream_delta_full_total",
                           "writes refused because the delta memtable is full")


# -- per-kind dispatch -------------------------------------------------------

def _modules():
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq

    return {"brute_force": brute_force, "ivf_flat": ivf_flat,
            "ivf_pq": ivf_pq, "cagra": cagra}


def _resolve_kind(sealed):
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq

    for kind, mod, cls in (("brute_force", brute_force, brute_force.BruteForce),
                           ("ivf_flat", ivf_flat, ivf_flat.IvfFlatIndex),
                           ("ivf_pq", ivf_pq, ivf_pq.IvfPqIndex),
                           ("cagra", cagra, cagra.CagraIndex)):
        if isinstance(sealed, cls):
            return kind, mod
    raise RaftError(
        f"MutableIndex cannot wrap {type(sealed).__name__!r} (expected "
        "BruteForce, IvfFlatIndex, IvfPqIndex or CagraIndex)")


def _sealed_device(kind, sealed) -> torch.device:
    return sealed.dataset.device if kind == "brute_force" else sealed.device


def _to_device(kind, sealed, device: torch.device):
    """The sealed index with every tensor on ``device`` (the same object
    when it is there already)."""
    if _sealed_device(kind, sealed) == device:
        return sealed
    if kind == "brute_force":
        # BruteForce holds one tensor: move it in place (the wrap takes
        # ownership of the sealed index)
        sealed.dataset = sealed.dataset.to(device)
        sealed.res = Resources(device=device)
        return sealed
    return dataclasses.replace(sealed, **{
        f.name: getattr(sealed, f.name).to(device)
        for f in dataclasses.fields(sealed)
        if isinstance(getattr(sealed, f.name), torch.Tensor)})


def _sealed_meta(kind, sealed):
    """(n_rows, dim, metric, metric_arg, data_kind) of a sealed index."""
    if kind == "brute_force":
        expects(sealed.dataset is not None, "sealed brute_force index is not built")
        n, d = sealed.dataset.shape
        dk = str(sealed.dataset.dtype).split(".")[-1]
        if dk not in ("int8", "uint8"):
            dk = "float32"
        return n, d, resolve_metric(sealed.metric), float(sealed.metric_arg), dk
    return (sealed.size, sealed.dim, sealed.metric, 2.0, sealed.data_kind)


def _store_rows(store) -> np.ndarray | None:
    """The raw rows of a retained store as a host array: an ``hbm`` store is
    the array, a :class:`TieredStore` gives its cold copy (folds, drift
    sampling and files read rows through this one seam)."""
    if store is None:
        return None
    return store.host_view() if isinstance(store, TieredStore) else store


def _recover_store(kind, sealed, data_kind):
    """The raw live rows in the serving dtype, where the sealed kind stores
    them (brute force and CAGRA keep the dataset; a uint8 CAGRA index holds
    it shifted into the s8 domain and is unshifted here). The IVF kinds
    store lists and codes, not rows: their store comes through
    ``dataset=``."""
    if kind == "brute_force":
        return _host(sealed.dataset)
    if kind == "cagra":
        ds = _host(sealed.dataset)
        if data_kind == "uint8":
            return (ds.astype(np.int16) + 128).astype(np.uint8)
        return ds
    return None


def _sealed_search(cfg, sealed, queries, k, keep, res):
    from ..neighbors import brute_force

    if cfg.kind == "brute_force":
        return brute_force.knn.native(sealed.dataset, queries, k, cfg.metric,
                               cfg.metric_arg, sample_filter=keep, res=res)
    return cfg.module.search.native(cfg.search_params, sealed, queries, k,
                             sample_filter=keep, res=res)


# -- merge pieces --------------------------------------------------------------

def _map_ids(ids, id_map):
    """Translate slot ids to global ids on the device; -1 passes through.
    No host sync."""
    g = id_map[ids.clamp_min(0).to(torch.int64)]
    return torch.where(ids >= 0, g, torch.full_like(g, -1))


def _merge(sealed_d, sealed_i, delta_d, delta_i, k, select_min):
    """Merge sealed and delta candidates (k + kd columns) on the plain top-k
    route, ties to the lowest column; underfilled slots keep the shared
    sentinel, id -1 at ±inf."""
    from ..matrix.select_k import select_k_impl

    obs_dispatch.note(1)
    d = torch.cat([sealed_d, delta_d], dim=1)
    i = torch.cat([sealed_i, delta_i.to(sealed_i.dtype)], dim=1)
    dv, iv = select_k_impl(d, i, int(k), bool(select_min), impl="torch")
    return dv, torch.where(torch.isinf(dv), torch.full_like(iv, -1), iv)


# -- state ---------------------------------------------------------------------

@dataclass(frozen=True)
class _Config:
    """Wrap-time configuration shared by every state epoch."""

    kind: str
    module: object
    search_params: object
    metric: DistanceType
    metric_arg: float
    select_min: bool
    dim: int
    data_kind: str
    query_dtype: str
    name: str
    device: torch.device
    res: Resources
    # host-to-device bytes this index's writes and swaps uploaded
    uploads: list = dataclasses.field(default_factory=lambda: [0])


def _dev_put(cfg: _Config, x) -> torch.Tensor:
    """A blocking copy of a host array onto the index's device (a fresh
    tensor; the host buffer may be rewritten as soon as this returns)."""
    a = np.ascontiguousarray(x)
    cfg.uploads[0] += a.nbytes
    return torch.from_numpy(a).to(cfg.device)


def _pack_words(alive: np.ndarray) -> np.ndarray:
    """A bool mask (n,) as ``pq_scan_topk``'s bitset, (ceil(n / 32),) int32:
    bit ``i & 31`` of word ``i >> 5`` set when slot ``i`` is kept, as
    ``ops.pq_scan.pack_keep_words`` packs it on the device."""
    n = alive.shape[0]
    raw = np.packbits(alive, bitorder="little")
    words = np.zeros(-(-n // 32) * 4, np.uint8)
    words[:raw.shape[0]] = raw
    return words.view("<i4")


class _StreamState:
    """One epoch of mutable-index state. The sealed index and the id map
    are frozen per epoch (compaction builds a successor and swaps); the
    tombstone and delta device handles are REPLACED on every write, never
    written in place, so a search that snapshots the handles is always
    consistent without the write lock."""

    __slots__ = ("cfg", "sealed", "id_map", "sealed_alive", "sealed_dead_n",
                 "store", "delta", "delta_ids", "delta_alive", "delta_n",
                 "delta_oldest_at", "epoch", "id_map_dev", "sealed_keep_dev",
                 "delta_view", "store_dev", "mem", "__weakref__")

    def __init__(self, cfg: _Config):
        self.cfg = cfg
        self.delta_n = 0
        self.delta_oldest_at = None
        self.epoch = 0
        # dead sealed slots, kept by the writes (stats() and the gauges must
        # not scan the bitset on every write)
        self.sealed_dead_n = 0
        # the device copy of the retained row store, made on the first
        # exact_search / search_refined of an epoch, never on the serving path
        self.store_dev = None
        self.delta_view = None
        # obs.mem ledger token for this epoch's stream-owned arrays
        self.mem = None


def _np_dtype(query_dtype: str):
    return {"float32": np.float32, "int8": np.int8,
            "uint8": np.uint8}[query_dtype]


def _refresh_sealed_keep(st: _StreamState) -> None:
    """Publish a new sealed keep filter: the alive bits packed once on the
    host (n / 8 bytes cross), unpacked on the device into the bool mask the
    brute-force, IVF-Flat and CAGRA filters read; IVF-PQ's ``pq_scan_topk``
    reads the packed words themselves."""
    cfg = st.cfg
    n = st.sealed_alive.shape[0]
    words = _dev_put(cfg, _pack_words(st.sealed_alive))
    shifts = torch.arange(32, dtype=torch.int32, device=cfg.device)
    mask = (((words[:, None] >> shifts) & 1) == 1).reshape(-1)[:n]
    st.sealed_keep_dev = BitsetFilter(mask, words=words)


def _grown(old: torch.Tensor, b: int) -> torch.Tensor:
    """A fresh (b, ...) tensor holding ``old``'s rows first, zeros after."""
    new = old.new_zeros((b,) + tuple(old.shape[1:]))
    new[:old.shape[0]] = old
    return new


def _refresh_delta(st: _StreamState, capacity: int, *, mask_only: bool = False,
                   appended: tuple[int, int] | None = None) -> None:
    """Publish a new delta view ``(rows, keep, ids, bucket)`` as ONE
    attribute assignment, so a reader's rows, mask and ids always belong to
    one bucket shape. ``mask_only`` (a delete): rows and ids are reused and
    only the bucket's keep mask crosses. ``appended=(p, r)`` (an upsert):
    only the r new rows and ids cross, spliced into copies of the published
    tensors on the device. Otherwise the whole bucket uploads."""
    cfg = st.cfg
    b = _bucket_for(st.delta_n, capacity)
    keep = st.delta_alive[:b] & (np.arange(b) < st.delta_n)
    view = st.delta_view
    if mask_only and view is not None and view[3] == b:
        rows_dev, ids_dev = view[0], view[2]
    elif appended is not None and view is not None and view[3] <= b:
        p, r = appended
        rows_dev, ids_dev = _grown(view[0], b), _grown(view[2], b)
        rows_dev[p:p + r] = _dev_put(cfg, st.delta[p:p + r])
        ids_dev[p:p + r] = _dev_put(cfg, st.delta_ids[p:p + r])
    else:
        rows_dev = _dev_put(cfg, st.delta[:b])
        ids_dev = _dev_put(cfg, st.delta_ids[:b])
    st.delta_view = (rows_dev, _dev_put(cfg, keep), ids_dev, b)


def _build_loc(st: _StreamState) -> dict:
    """id -> live-slot map, from vectorized numpy passes."""
    s_slots = np.nonzero(st.sealed_alive)[0]
    loc = dict(zip(st.id_map[s_slots].tolist(),
                   zip(("s",) * len(s_slots), s_slots.tolist())))
    d_slots = np.nonzero(st.delta_alive[:st.delta_n])[0]
    loc.update(zip(st.delta_ids[d_slots].tolist(),
                   zip(("d",) * len(d_slots), d_slots.tolist())))
    return loc


def _resolve_res(cfg: _Config, res):
    """The handle a search or fold runs with: the index's own, or the
    caller's when it names the index's device (else raises)."""
    if res is None:
        return cfg.res
    res.check_holds(cfg.device, f"mutable index {cfg.name!r}")
    return res


def _queries(cfg: _Config, queries) -> torch.Tensor:
    q = torch.as_tensor(queries)
    expects(q.ndim == 2 and q.shape[1] == cfg.dim,
            "queries must be (rows, %d)", cfg.dim)
    q = q.to(cfg.device)
    if cfg.query_dtype == "float32":
        q = q.to(torch.float32)
    return q


def _scan_state(st: _StreamState, queries, k: int, res=None,
                k_sealed: int | None = None):
    """The scatter half of a one-epoch search: the sealed (filtered) scan
    and the delta scan, slot ids mapped to global ids, BEFORE the merge.
    Every device handle is snapshotted up front, so a concurrent write
    (which replaces handles, never writes them) cannot tear this call.
    ORDER MATTERS: the delta view is read BEFORE the sealed keep filter,
    pairing with upsert's publish order (sealed mask first, delta second):
    a reader that sees an upserted id's new delta copy also sees the old
    sealed copy's tombstone. Stage walls land as ``stream/sealed`` /
    ``stream/delta`` request-log spans (host dispatch walls).

    Returns ``(sealed_d (m, k), sealed_i, delta_d (m, kd), delta_i)``.
    ``k_sealed`` (the sharded tier only) narrows the sealed width: a shard
    with fewer sealed rows than k gives what it has and the mesh merge pads
    the rest; without it the sealed width is k."""
    from ..neighbors import brute_force
    from ..obs import requestlog

    cfg = st.cfg
    res = _resolve_res(cfg, res)
    requestlog.annotate("stream_epoch", st.epoch)
    delta, dkeep, dids, _ = st.delta_view
    sealed, skeep, imap = st.sealed, st.sealed_keep_dev, st.id_map_dev
    queries = _queries(cfg, queries)
    k = int(k)
    ks = k if k_sealed is None else int(k_sealed)
    t0 = time.perf_counter()
    sd, si = _sealed_search(cfg, sealed, queries, ks, skeep, res)
    si = _map_ids(si, imap)
    t1 = time.perf_counter()
    kd = min(k, delta.shape[0])
    dd, di = brute_force.knn.native(delta, queries, kd, cfg.metric, cfg.metric_arg,
                             sample_filter=dkeep, res=res)
    di = _map_ids(di, dids)
    t2 = time.perf_counter()
    # sealed search + delta scan + the two id maps
    obs_dispatch.note(4)
    requestlog.add_span("stream/sealed", t1 - t0)
    requestlog.add_span("stream/delta", t2 - t1)
    return sd, si, dd, di


def _search_state(st: _StreamState, queries, k: int, res=None):
    """Unified search over one state epoch: :func:`_scan_state` merged on
    the plain top-k (``stream/merge`` span)."""
    from ..obs import requestlog

    sd, si, dd, di = _scan_state(st, queries, k, res=res)
    t0 = time.perf_counter()
    out = _merge(sd, si, dd, di, int(k), st.cfg.select_min)
    requestlog.add_span("stream/merge", time.perf_counter() - t0)
    return out


def _warm_queries(gen, rows, cfg, sample):
    from .._warmup import _random_queries

    if sample is not None:
        sample = torch.as_tensor(_host(sample))
    return _random_queries(gen, rows, cfg.dim, cfg.query_dtype, sample=sample)


def _wait(cfg: _Config) -> None:
    if cfg.device.type == "cuda":
        torch.cuda.current_stream(cfg.device).synchronize()


# -- the mutable index ---------------------------------------------------------

class MutableIndex:
    """Mutable lifecycle wrapper over a sealed index (see module docstring).

    ``sealed`` must be a freshly built (or loaded) index whose stored ids
    are the dense row range ``0..n-1``, as ``build()`` makes them.
    ``search_params`` are baked in at wrap time (the serving-hook
    discipline); ``index_params`` are needed only for a rebuild compaction
    of an IVF kind. ``delta_capacity`` (a power of two) bounds the
    memtable; ``retain_vectors`` keeps a host copy of the raw rows (needed
    by rebuild compaction; recovered from brute-force / CAGRA datasets,
    given through ``dataset=`` for the IVF kinds). ``builder`` (optional,
    ``fn(rows, res=None) -> sealed index of the same kind``) replaces
    ``module.build(index_params, rows)`` in a rebuild. The sealed rows'
    global ids are the row range. ``device`` (a ``torch.device`` or
    its name) moves the sealed index there; every search and fold runs on
    the sealed index's device. ``wal`` (a path or a
    :class:`~raft_tpu_torch.stream.wal.WriteAheadLog`) logs every write
    before the memtable sees it; ``snapshot_path`` makes each compaction
    save the state there and truncate the log. ``storage`` picks where the
    retained rows live: ``"hbm"`` (a host array with a lazy device copy for
    the oracle and the refine gather) or ``"tiered"`` (a
    :class:`~raft_tpu_torch.stream.tiered.TieredStore` configured by
    ``tier``, a :class:`~raft_tpu_torch.stream.tiered.TierPolicy`;
    ``tier_residency`` restores a saved placement without deciding again).
    ``ids`` (length n, unique, >= 0, int32-representable) gives the sealed
    rows' global ids in place of the row range: the sharded tier's id map,
    where each shard's sealed index is a dense local build and fresh ids
    continue past ``max(ids)``. ``shard`` is the shard ordinal the
    ``obs.mem`` ledger attributes this index's bytes to (None: unsharded).
    ``clock`` is injected for deterministic tests (the age watermark's time
    base).
    """

    def __init__(self, sealed, *, search_params=None, index_params=None,
                 delta_capacity: int = 1024, retain_vectors: bool | None = None,
                 dataset=None, builder: Callable | None = None,
                 ids=None, device=None, name: str = "default",
                 shard: int | None = None, wal=None,
                 snapshot_path: str | None = None,
                 storage: str = "hbm", tier: TierPolicy | None = None,
                 tier_residency: str | None = None,
                 clock: Callable[[], float] = time.monotonic):
        kind, module = _resolve_kind(sealed)
        dev = (_sealed_device(kind, sealed) if device is None
               else torch.device(device))
        sealed = _to_device(kind, sealed, dev)
        n, d, metric, metric_arg, data_kind = _sealed_meta(kind, sealed)
        expects(n > 0, "cannot wrap an empty sealed index")
        if kind in ("ivf_flat", "ivf_pq"):
            # the id-map contract: internal ids are the dense row range
            expects(sealed.max_stored_id == n - 1,
                    "sealed %s ids must be the dense row range 0..n-1 "
                    "(a fresh build); wrap before extending with custom ids",
                    kind)
        query_dtype = data_kind if data_kind in ("int8", "uint8") else "float32"
        if search_params is None and kind != "brute_force":
            # default params at wrap time, not an error at first search
            search_params = module.SearchParams()
        if kind == "ivf_pq" and getattr(search_params, "funnel_widen", 1) > 1:
            expects(sealed.has_fast_scan,
                    "search_params pins funnel_widen=%d but the sealed "
                    "index carries no fast-scan tier — build with "
                    "IndexParams.fast_scan='1bit'|'4bit'",
                    int(search_params.funnel_widen))
        cfg = _Config(kind=kind, module=module, search_params=search_params,
                      metric=metric, metric_arg=metric_arg,
                      select_min=metric != DistanceType.InnerProduct,
                      dim=d, data_kind=data_kind, query_dtype=query_dtype,
                      name=name, device=dev, res=Resources(device=dev))
        self._cfg = cfg
        self._shard = None if shard is None else int(shard)
        self._index_params = index_params
        expects(builder is None or callable(builder),
                "builder must be a callable fn(rows, res=None) -> sealed index")
        self._builder = builder
        self.delta_capacity = int(delta_capacity)
        self._buckets = delta_buckets(self.delta_capacity)
        self._clock = clock
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        # durability: a WAL logs every upsert / delete at admission, BEFORE
        # the memtable sees it. A fresh wrap refuses a log that already
        # holds records: they belong to an earlier life of this index and
        # are recovered through stream.load(wal=)
        if wal is not None and not hasattr(wal, "append_upsert"):
            from .wal import WriteAheadLog

            wal = WriteAheadLog(wal, name=name)
        self._wal = wal
        self._wal_seq = 0
        self._snapshot_path = snapshot_path
        if wal is not None:
            expects(wal.seq == 0,
                    "WAL %r already holds records (seq=%d) — a fresh wrap "
                    "would shadow them; recover with stream.load(wal=) or "
                    "point at a fresh log", getattr(wal, "path", "?"),
                    wal.seq)
        if ids is None:
            id_map = np.arange(n, dtype=np.int64)
        else:
            id_map = np.asarray(_host(ids), np.int64).reshape(-1)
            expects(id_map.shape == (n,),
                    "ids= must assign one global id per sealed row (%d), "
                    "got %d", n, id_map.shape[0])
            expects(np.unique(id_map).size == n, "ids= must be unique")
            expects(int(id_map.min()) >= 0, "ids= must be >= 0")
            expects(int(id_map.max()) < 2 ** 31 - 1,
                    "ids= must fit int32 (device id maps are int32)")
        self._next_id = int(id_map.max()) + 1
        self._loc: dict[int, tuple[str, int]] = {}

        store = None
        if dataset is not None:
            # a chunked reader (the streamed build's corpus) gives its backing
            # array: an np.memmap keeps the retained rows disk-backed, never
            # copied into memory
            store = (dataset.host_view() if chunked.is_reader(dataset)
                     else _host(dataset))
            expects(store.shape == (n, d),
                    "dataset= must be the sealed rows (%d, %d), got %s",
                    n, d, tuple(store.shape))
            if query_dtype == "float32":
                if store.dtype != np.float32:
                    store = np.asarray(store, np.float32)
            else:
                expects(str(store.dtype) == query_dtype,
                        "dataset= dtype %s must match the serving dtype %s",
                        store.dtype, query_dtype)
        elif retain_vectors is not False:
            store = _recover_store(kind, sealed, data_kind)
        if retain_vectors is True:
            expects(store is not None,
                    "retain_vectors=True needs dataset= for %s (stored codes "
                    "cannot reconstruct raw rows)", kind)
        # "tiered" keeps the full-precision rows cold (host RAM / an mmap):
        # the refine gather and the exact oracle cross to the device a batch
        # at a time instead of holding a second full copy there
        expects(storage in ("hbm", "tiered"),
                "storage must be 'hbm' or 'tiered', got %r", storage)
        expects(tier is None or storage == "tiered",
                "tier= (a TierPolicy) applies to storage='tiered' only")
        expects(tier_residency is None or storage == "tiered",
                "tier_residency= applies to storage='tiered' only")
        if storage == "tiered":
            expects(store is not None,
                    "storage='tiered' stores the raw refine rows cold — "
                    "pass dataset= (IVF kinds) or retain_vectors=True")
        self._storage = storage
        self._tier = tier

        st = _StreamState(cfg)
        st.sealed = sealed
        st.id_map = id_map
        st.sealed_alive = np.ones(n, bool)
        # tier_residency (load's layout restore) skips the placement
        # decision: deciding again would upload a cold-saved store for nothing
        st.store = self._make_store(store, epoch=0, residency=tier_residency)
        dt = _np_dtype(query_dtype)
        st.delta = np.zeros((self.delta_capacity, d), dt)
        st.delta_ids = np.zeros(self.delta_capacity, np.int32)
        st.delta_alive = np.zeros(self.delta_capacity, bool)
        st.id_map_dev = _dev_put(cfg, st.id_map.astype(np.int32))
        _refresh_sealed_keep(st)
        _refresh_delta(st, self.delta_capacity)
        self._state = st
        self._loc = _build_loc(st)
        # ledger: the sealed index re-attributes under the serving name; the
        # stream-owned arrays get their own per-epoch entry
        self._sealed_mem = obs_mem.account_index(
            sealed, name=cfg.name, shard=self._shard, epoch=0)
        self._update_gauges(st)

    # -- introspection ---------------------------------------------------------
    @property
    def kind(self) -> str:
        return self._cfg.kind

    @property
    def dim(self) -> int:
        return self._cfg.dim

    @property
    def name(self) -> str:
        return self._cfg.name

    @property
    def query_dtype(self) -> str:
        return self._cfg.query_dtype

    @property
    def device(self) -> torch.device:
        """The device the sealed index, the delta view and every search
        live on."""
        return self._cfg.device

    @property
    def uploaded_bytes(self) -> int:
        """Host-to-device bytes this index's writes, swaps and lazy store
        copies have uploaded so far."""
        return self._cfg.uploads[0]

    @property
    def can_rebuild(self) -> bool:
        """Whether rebuild compaction (the tombstone-reclaiming mode) is
        available: a raw row store, plus build params for IVF kinds."""
        if self._state.store is None:
            return False
        return (self._cfg.kind in ("brute_force", "cagra")
                or self._index_params is not None
                or self._builder is not None)

    @property
    def size(self) -> int:
        """Live (searchable) rows."""
        with self._lock:
            st = self._state
            return int(len(st.sealed_alive) - st.sealed_dead_n
                       + st.delta_alive[:st.delta_n].sum())

    def _make_store(self, rows, epoch: int, residency: str | None = None):
        """The retained row store of one state epoch: the raw array under
        ``storage="hbm"``, a :class:`TieredStore` under ``"tiered"`` (a
        compaction successor's store is placed with the predecessor's
        residency, which is how residency carries through a fold)."""
        if rows is None or self._storage == "hbm":
            return rows
        # rows pass raw: the store adopts an np.memmap in place
        return TieredStore(rows, name=self._cfg.name, shard=self._shard,
                           epoch=epoch,
                           policy=self._tier, device=self._cfg.device,
                           residency=residency, clock=self._clock)

    @property
    def storage(self) -> str:
        """The storage policy ("hbm" or "tiered")."""
        return self._storage

    @property
    def tiered_store(self) -> TieredStore | None:
        """The live epoch's :class:`TieredStore` (None under "hbm")."""
        st = self._state.store
        return st if isinstance(st, TieredStore) else None

    def _drift_store(self):
        """The retained raw-row store (or None): what a
        :class:`~raft_tpu_torch.stream.Compactor` feeds its drift detector."""
        return _store_rows(self._state.store)

    def stats(self) -> dict:
        with self._lock:
            st = self._state
            n_sealed = len(st.sealed_alive)
            dead = int(st.sealed_dead_n)
            return {
                "live": int(n_sealed - dead
                            + st.delta_alive[:st.delta_n].sum()),
                "sealed_rows": n_sealed,
                "sealed_dead": dead,
                "tombstone_ratio": dead / max(n_sealed, 1),
                "delta_rows": int(st.delta_n),
                "delta_fill": st.delta_n / self.delta_capacity,
                "delta_bucket": st.delta_view[3],
                "delta_oldest_at": st.delta_oldest_at,
                "epoch": st.epoch,
            }

    def _update_gauges(self, st: _StreamState) -> None:
        if not metrics._enabled:
            return
        name = self._cfg.name
        n_sealed = len(st.sealed_alive)
        _g_delta_fill().set(st.delta_n / self.delta_capacity, name=name)
        _g_delta_rows().set(st.delta_n, name=name)
        _g_tombstone().set(int(st.sealed_dead_n) / max(n_sealed, 1), name=name)
        self._account_state(st)

    def _account_state(self, st: _StreamState) -> None:
        """(Re)account this epoch's stream-owned arrays in the obs.mem
        ledger: device = the published delta view, filter, id map (and the
        lazy store copy); host = the memtable, bitsets and retained store.
        Keyed on the state object, so a compaction swap leaves the old
        epoch's entry to release when its last reader drops it."""
        if not metrics._enabled:
            return
        keep = st.sealed_keep_dev
        dev = [st.id_map_dev, keep.mask, keep.words, *st.delta_view[:3]]
        if st.store_dev is not None:
            dev.append(st.store_dev)
        host = [st.delta, st.delta_ids, st.delta_alive, st.sealed_alive,
                st.id_map]
        # a TieredStore carries its own "tier" entry (rows, mirror, slots):
        # one attribution, not a second copy here
        if st.store is not None and not isinstance(st.store, TieredStore):
            host.append(st.store)
        if st.mem is None:
            st.mem = obs_mem.account(
                "stream", name=self._cfg.name, shard=self._shard,
                epoch=st.epoch, device=dev, host=host, owner=st)
        else:
            obs_mem.reaccount(st.mem, device=dev, host=host)

    def _growth_bytes(self, r: int) -> int:
        """Device bytes a write of ``r`` rows would newly allocate: what the
        sharded and replicated tiers sum for their hoisted admission."""
        return self._delta_growth_bytes(self._state, r)

    def _delta_rows_now(self) -> int:
        """The delta's occupancy for a hoisted admission check (read without
        the lock: a concurrent fold only shrinks the delta, so a stale read
        can over-refuse, never admit past capacity)."""
        return int(self._state.delta_n)

    def _delta_growth_bytes(self, st: _StreamState, r: int) -> int:
        """Device bytes a write of ``r`` rows would newly allocate: the
        bucket grows in power-of-two steps, and a grown bucket holds rows,
        ids and mask."""
        b0 = st.delta_view[3]
        b1 = _bucket_for(st.delta_n + r, self.delta_capacity)
        if b1 <= b0:
            return 0
        return (b1 - b0) * (self._cfg.dim * st.delta.dtype.itemsize + 4 + 1)

    # -- writes ----------------------------------------------------------------
    def _coerce_rows(self, rows):
        rows = _host(rows)
        expects(rows.ndim == 2 and rows.shape[1] == self._cfg.dim,
                "rows must be (r, %d)", self._cfg.dim)
        if self._cfg.query_dtype == "float32":
            return np.asarray(rows, np.float32)
        expects(str(rows.dtype) == self._cfg.query_dtype,
                "byte index %r takes %s rows, got %s", self._cfg.name,
                self._cfg.query_dtype, rows.dtype)
        return rows

    def upsert(self, rows, ids=None, res=None):
        """Insert rows (fresh ids assigned and returned) or upsert under
        caller-chosen ids: the previous live occurrence of each id is
        tombstoned and the new row is visible to the very next search
        (read-your-writes). Raises :class:`DeltaFullError` (an
        ``OverloadedError``) at capacity, and
        :class:`~raft_tpu_torch.serve.errors.MemoryBudgetError` when
        growing the delta's bucket would exceed ``res.memory_budget_bytes``
        — both before any row lands. Returns the global ids (int64)."""
        rows = self._coerce_rows(rows)
        r = rows.shape[0]
        expects(r >= 1, "upsert needs at least one row")
        with self._lock:
            st = self._state
            obs_mem.gate(res or default_resources(),
                         lambda: self._delta_growth_bytes(st, r),
                         site="upsert", detail=f"stream {self._cfg.name!r}")
            if st.delta_n + r > self.delta_capacity:
                if metrics._enabled:
                    _c_delta_full().inc(1, name=self._cfg.name)
                raise DeltaFullError(
                    f"delta memtable at {st.delta_n}/{self.delta_capacity} "
                    f"rows; upsert of {r} refused — compact() (or attach a "
                    "stream.Compactor) to fold the delta into the sealed "
                    "index")
            if ids is None:
                gids = np.arange(self._next_id, self._next_id + r,
                                 dtype=np.int64)
            else:
                gids = check_upsert_ids(ids, r)
            expects(int(gids.max()) < 2 ** 31 - 1,
                    "ids must fit int32 (device id maps are int32)")
            self._next_id = max(self._next_id, int(gids.max()) + 1)
            if self._wal is not None:
                # write-ahead: the record is durable BEFORE the memtable
                # changes; a crash in the window below replays it at load
                self._wal_seq = self._wal.append_upsert(rows, gids)
                faults.fire("stream/post-wal", name=self._cfg.name,
                            op="upsert")
            sealed_dirty = self._tombstone_locked(st, gids.tolist())
            p = st.delta_n
            st.delta[p:p + r] = rows
            st.delta_ids[p:p + r] = gids.astype(np.int32)
            st.delta_alive[p:p + r] = True
            for j, g in enumerate(gids.tolist()):
                self._loc[g] = ("d", p + j)
            if st.delta_n == 0:
                st.delta_oldest_at = self._clock()
            st.delta_n += r
            # tombstone before reveal: the old copy's mask lands first, so
            # a lock-free reader never sees both copies of an upserted id
            if sealed_dirty:
                _refresh_sealed_keep(st)
            _refresh_delta(st, self.delta_capacity, appended=(p, r))
            if metrics._enabled:
                _c_upserts().inc(r, name=self._cfg.name)
            self._update_gauges(st)
        return gids

    def _tombstone_locked(self, st, gids) -> bool:
        """Mark the live occurrence of each id dead; returns whether a
        SEALED slot changed (the caller republishes that filter)."""
        sealed_dirty = False
        killed = 0
        for g in gids:
            loc = self._loc.pop(int(g), None)
            if loc is None:
                continue
            killed += 1
            if loc[0] == "s":
                st.sealed_alive[loc[1]] = False
                st.sealed_dead_n += 1
                sealed_dirty = True
            else:
                st.delta_alive[loc[1]] = False
        if killed and metrics._enabled:
            _c_deletes().inc(killed, name=self._cfg.name)
        return sealed_dirty

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many were live. Deletes are visible to
        the very next search; unknown or already-dead ids are a counted
        no-op, not an error."""
        arr = np.asarray(_host(ids)).reshape(-1)
        with self._lock:
            st = self._state
            if self._wal is not None and arr.size:
                self._wal_seq = self._wal.append_delete(arr)
                faults.fire("stream/post-wal", name=self._cfg.name,
                            op="delete")
            before = len(self._loc)
            sealed_dirty = self._tombstone_locked(st, arr.tolist())
            n = before - len(self._loc)
            if sealed_dirty:
                _refresh_sealed_keep(st)
            # delta tombstones ride the keep mask; rows and ids are untouched
            _refresh_delta(st, self.delta_capacity, mask_only=True)
            self._update_gauges(st)
        return n

    # -- reads -----------------------------------------------------------------
    def search(self, queries, k: int, res=None):
        """Unified search over (sealed − tombstones) + delta; returns
        ``(distances (m, k), global ids (m, k))`` on the index's device,
        with the shared ``-1 / ±inf`` sentinel in slots the live rows
        cannot fill."""
        return _search_state(self._state, queries, k, res=res)

    def exact_search(self, queries, k: int, res=None):
        """Exact kNN over the live corpus (the recall canary's oracle): the
        retained row store scanned through the same tombstone filter the
        serving path uses, plus the delta scan, merged and mapped to global
        ids. Needs the retained store; its device copy is made once per
        epoch, off the serving path."""
        sd, si, dd, di = self._exact_scan(queries, k, res=res)
        return _merge(sd, si, dd, di, int(k), self._cfg.select_min)

    def _exact_scan(self, queries, k: int, res=None):
        """The scatter half of :meth:`exact_search`, snapshot order as in
        :func:`_scan_state`. Returns ``(sd (m, ks), si, dd (m, kd), di)``."""
        from ..neighbors import brute_force

        st = self._state
        cfg = self._cfg
        res = _resolve_res(cfg, res)
        delta, dkeep, dids, _ = st.delta_view
        skeep, imap = st.sealed_keep_dev, st.id_map_dev
        queries = _queries(cfg, queries)
        k = int(k)
        ts = st.store if isinstance(st.store, TieredStore) else None
        # one read of the mirror decides the branch and supplies the tensor,
        # so a concurrent pressure spill cannot tear this call
        mirror = ts.mirror if ts is not None else None
        if ts is not None and mirror is None:
            # a cold store: the chunked scan through the store's upload ring
            # (no device copy of the rows). The alive bits are copied once,
            # after the delta view, which keeps the kill-then-reveal pairing
            # as the resident path's frozen device mask does
            alive = st.sealed_alive.copy()
            sd, si = self._chunked_store_scan(st, ts, queries, k,
                                              alive=alive, res=res)
        else:
            store_dev = mirror if mirror is not None else self._store_device(st)
            ks = min(k, store_dev.shape[0])
            sd, si = brute_force.knn.native(store_dev, queries, ks, cfg.metric,
                                     cfg.metric_arg, sample_filter=skeep.mask,
                                     res=res)
        si = _map_ids(si, imap)
        kd = min(k, delta.shape[0])
        dd, di = brute_force.knn.native(delta, queries, kd, cfg.metric,
                                 cfg.metric_arg, sample_filter=dkeep, res=res)
        di = _map_ids(di, dids)
        obs_dispatch.note(4)
        return sd, si, dd, di

    def _chunked_store_scan(self, st: _StreamState, ts: TieredStore,
                            queries, k: int, *, alive=None, res=None,
                            max_chunks: int | None = None):
        """Exact scan of a cold tiered store: fixed-shape chunks come through
        the store's upload ring (chunk N+1's upload overlaps chunk N's
        search) and fold into a running top-k through :func:`_merge`. The
        tombstone mask crosses once, padded to whole chunks, and each chunk
        reads its slice of it. Returns ``(sd, si)`` in store-slot ids (the
        caller maps them to global ids). ``max_chunks`` bounds the walk (the
        warm path runs two chunks, not the whole store)."""
        from ..neighbors import brute_force

        cfg = st.cfg
        res = _resolve_res(cfg, res)
        chunk = ts.oracle_chunk
        kc = min(int(k), chunk)
        total = ts.n_oracle_chunks()
        n_chunks = total if max_chunks is None else min(total, int(max_chunks))
        if alive is None:   # the warm path; real scans pass the caller's copy
            alive = st.sealed_alive.copy()
        keep = np.zeros(total * chunk, bool)
        keep[:alive.shape[0]] = alive
        keep_dev = _dev_put(cfg, keep)
        acc_d = acc_i = None
        for ci in range(n_chunks):
            rows_dev, base, _ = ts.oracle_chunk_dev(ci)
            cd, cidx = brute_force.knn.native(
                rows_dev, queries, kc, cfg.metric, cfg.metric_arg,
                sample_filter=keep_dev[base:base + chunk], res=res)
            cidx = shift_slots(cidx, base)
            if acc_d is None:
                acc_d, acc_i = cd, cidx
            else:
                acc_d, acc_i = _merge(acc_d, acc_i, cd, cidx, kc,
                                      cfg.select_min)
        return acc_d, acc_i

    def _store_device(self, st: _StreamState):
        """The epoch-frozen device copy of the retained row store (made on
        first use; a race uploads at most twice, and the store itself never
        changes within an epoch)."""
        expects(st.store is not None,
                "exact_search needs the retained row store "
                "(retain_vectors=True / dataset= at wrap time)")
        expects(not isinstance(st.store, TieredStore),
                "tiered stores never materialize a second full device "
                "copy — use the mirror or the chunked scan")
        dev = st.store_dev
        if dev is None:
            dev = _dev_put(st.cfg, st.store)
            st.store_dev = dev
            self._account_state(st)
        return dev

    # -- the refine epilogue -----------------------------------------------------
    def search_refined(self, queries, k: int, refine_ratio: int = 4,
                       res=None):
        """IVF-PQ search with an exact re-rank: the sealed scan widens to
        ``k * refine_ratio`` PQ candidates, their rows are gathered from
        the device copy of the retained store and re-ranked exactly
        (:func:`raft_tpu_torch.neighbors.refine.refine_gathered`); the
        delta (already exact) merges at serving width. Returns
        ``(distances (m, k), global ids (m, k))``."""
        return self._search_refined_state(self._state, queries, k,
                                          refine_ratio, res=res)

    def _search_refined_state(self, st: _StreamState, queries, k: int,
                              refine_ratio: int, res=None):
        from ..obs import requestlog

        rd, ri, dd, di = self._refined_scan(queries, k, refine_ratio,
                                            res=res, st=st)
        t0 = time.perf_counter()
        out = _merge(rd, ri, dd, di, int(k), self._cfg.select_min)
        requestlog.add_span("stream/merge", time.perf_counter() - t0)
        return out

    def _refined_scan(self, queries, k: int, refine_ratio: int, res=None,
                      st: _StreamState | None = None):
        """The scatter half of :meth:`search_refined` (refined sealed part +
        exact delta part, global ids, before the merge). ``st`` pins a
        state epoch (the :meth:`refined_searcher` hook's lease contract)."""
        from ..neighbors import brute_force
        from ..neighbors.refine import refine_gathered
        from ..obs import requestlog

        if st is None:
            st = self._state
        cfg = self._cfg
        expects(cfg.kind == "ivf_pq",
                "search_refined is the IVF-PQ refine epilogue (kind=%r "
                "scores candidates exactly already — use search())",
                cfg.kind)
        expects(st.store is not None,
                "search_refined needs the retained raw rows (dataset= / "
                "retain_vectors=True at wrap time)")
        r = int(refine_ratio)
        expects(r >= 1, "refine_ratio must be >= 1, got %d", r)
        # the caller's handle (or the default one) prices a hit-rate promote
        budget_res = res
        res = _resolve_res(cfg, res)
        requestlog.annotate("stream_epoch", st.epoch)
        delta, dkeep, dids, _ = st.delta_view
        skeep, imap = st.sealed_keep_dev, st.id_map_dev
        queries = _queries(cfg, queries)
        k = int(k)
        kr = min(k * r, st.id_map.shape[0])
        t0 = time.perf_counter()
        # PQ candidates at the widened width; only their slot ids are used
        _, slots = cfg.module.search.native(cfg.search_params, st.sealed, queries,
                                     kr, sample_filter=skeep, res=res)
        t1 = time.perf_counter()
        ts = st.store if isinstance(st.store, TieredStore) else None
        if ts is not None:
            cand = ts.fetch(slots, res=budget_res)
        else:
            cand = mirror_gather(self._store_device(st), slots)
        ks = min(k, kr)
        rd, rslots = refine_gathered(cand, queries, slots, ks,
                                     metric=cfg.metric, res=res)
        ri = _map_ids(rslots, imap)
        t2 = time.perf_counter()
        kd = min(k, delta.shape[0])
        dd, di = brute_force.knn.native(delta, queries, kd, cfg.metric,
                                 cfg.metric_arg, sample_filter=dkeep,
                                 res=res)
        di = _map_ids(di, dids)
        obs_dispatch.note(5)
        requestlog.add_span("stream/sealed", t1 - t0)
        requestlog.add_span("tier/refine", t2 - t1)
        requestlog.add_span("stream/delta", time.perf_counter() - t2)
        return rd, ri, dd, di

    def refined_searcher(self, refine_ratio: int = 4):
        """Serving hook over :meth:`search_refined`, pinned to the current
        state epoch exactly like :meth:`searcher`."""
        from ..neighbors._hooks import make_hook

        st = self._state
        fn = make_hook(
            lambda queries, k: self._search_refined_state(st, queries, k,
                                                          refine_ratio),
            f"stream/{self._cfg.kind}+refine", self._cfg.dim,
            self._cfg.data_kind, self._cfg.device)
        fn.mutable = self
        return fn

    def warm_refined(self, buckets, ks=(10,), refine_ratio: int = 4,
                     sample=None) -> dict:
        """Run the refined serving path once per (query bucket, k), which
        builds its kernels and makes the store's device copy (a tiered
        store's upload ring instead). Under tiered storage two chunks of the
        chunked oracle run too, whatever the residency: a promoted store can
        be spilled later. Returns per-(k, bucket) build attribution like
        :meth:`warm`."""
        from ..obs import compile as obs_compile

        cfg = self._cfg
        out: dict = {}
        gen = torch.Generator().manual_seed(0)
        for kk in sorted(set(int(x) for x in ks)):
            out[kk] = {}
            for b in sorted(set(int(x) for x in buckets)):
                q = _warm_queries(gen, b, cfg, sample)
                t0 = time.perf_counter()
                with obs_compile.attribution() as rec:
                    self.search_refined(q, kk, refine_ratio)
                    ts = self.tiered_store
                    if ts is not None:
                        self._chunked_store_scan(self._state, ts,
                                                 _queries(cfg, q), kk,
                                                 max_chunks=2)
                    _wait(cfg)
                out[kk][b] = {"wall_s": round(time.perf_counter() - t0, 3),
                              **rec.summary()}
        return out

    def searcher(self):
        """Serving hook pinned to the CURRENT state epoch (the
        ``batched_searcher`` contract: ``fn(queries, k)`` with ``kind`` /
        ``dim`` / ``query_dtype`` / ``device``). Writes stay visible through
        a pinned hook until a compaction swap freezes its epoch; from then
        on it serves the pre-compaction view, which is the lease-drain
        contract ``serve.IndexRegistry`` wants."""
        from ..neighbors._hooks import make_hook

        st = self._state
        fn = make_hook(lambda queries, k: _search_state(st, queries, k),
                       f"stream/{st.cfg.kind}", st.cfg.dim,
                       st.cfg.data_kind, st.cfg.device)
        # marker for the serve write path: SearchService.publish tells a
        # mutable's own hook (keep the write handle) from any other hook
        # (close the write path)
        fn.mutable = self
        return fn

    # -- warmup ----------------------------------------------------------------
    def warm(self, buckets, ks=(10,), sample=None) -> dict:
        """Run the delta scan at EVERY memtable bucket x every serving
        (query bucket, k), plus the id map and the merge: the ``fused_knn``
        kernel of the 4,096-row bucket is built here, and the allocator's
        blocks and cuBLAS handles of every shape exist, before a write
        grows the delta onto them. The sealed side is warmed per epoch by
        ``registry.publish``. Returns per-(k, bucket) build attribution
        like :func:`raft_tpu_torch._warmup.warm_buckets`."""
        from ..neighbors import brute_force
        from ..obs import compile as obs_compile

        cfg = self._cfg
        out: dict = {}
        gen = torch.Generator().manual_seed(0)
        dt = _np_dtype(cfg.query_dtype)
        for kk in sorted(set(int(x) for x in ks)):
            out[kk] = {}
            for b in sorted(set(int(x) for x in buckets)):
                q = _queries(cfg, _warm_queries(gen, b, cfg, sample))
                t0 = time.perf_counter()
                with obs_compile.attribution() as rec:
                    for db in self._buckets:
                        dummy = torch.from_numpy(
                            np.zeros((db, cfg.dim), dt)).to(cfg.device)
                        keep = torch.zeros(db, dtype=torch.bool,
                                           device=cfg.device)
                        kd = min(kk, db)
                        dd, di = brute_force.knn.native(
                            dummy, q, kd, cfg.metric, cfg.metric_arg,
                            sample_filter=keep, res=cfg.res)
                        di = _map_ids(di, torch.zeros(
                            db, dtype=torch.int32, device=cfg.device))
                        sd = torch.zeros((b, kk), dtype=torch.float32,
                                         device=cfg.device)
                        si = torch.full((b, kk), -1, dtype=torch.int32,
                                        device=cfg.device)
                        _merge(sd, si, dd, di, kk, cfg.select_min)
                    _wait(cfg)
                out[kk][b] = {"wall_s": round(time.perf_counter() - t0, 3),
                              **rec.summary()}
        return out

    # -- compaction --------------------------------------------------------------
    def compact(self, mode: str = "auto", res=None, *,
                ooc_chunk_rows: int | None = None) -> dict:
        """Fold the delta memtable (and, in rebuild mode, the tombstones)
        into a new sealed index and swap it in.

        ``mode``: "extend" appends the live delta rows to the sealed lists
        (IVF kinds only; tombstoned sealed slots stay masked), "rebuild"
        builds the sealed index anew from the live rows (drops tombstones;
        needs the retained row store), "auto" picks extend for the IVF
        kinds and rebuild otherwise. The fold runs OFF the write lock:
        searches keep serving the old state, and writes landing mid-fold
        carry over (the fold consumes a snapshot prefix of the delta, and
        every alive bit is re-read from the live state at the swap).
        Returns a report (mode, rows folded / reclaimed, wall seconds).

        ``ooc_chunk_rows`` (rebuild mode only) routes the fold through the
        out-of-core build: the live rows reach the builder as a
        :class:`~raft_tpu_torch.core.chunked.ChunkedReader` of that many
        rows a chunk in place of one device tensor, so the rebuild's device
        peak is the index plus two staged chunks. The result equals the
        in-core fold's bit for bit."""
        expects(mode in ("auto", "extend", "rebuild"),
                "mode must be 'auto', 'extend' or 'rebuild', got %r", mode)
        cfg = self._cfg
        res = _resolve_res(cfg, res)
        with self._compact_lock:
            if mode == "auto":
                mode = ("extend" if cfg.kind in ("ivf_flat", "ivf_pq")
                        else "rebuild")
            expects(mode == "rebuild" or cfg.kind in ("ivf_flat", "ivf_pq"),
                    "%s has no extend(); use mode='rebuild'", cfg.kind)
            expects(ooc_chunk_rows is None or mode == "rebuild",
                    "ooc_chunk_rows= streams the REBUILD fold; extend "
                    "folds only the (small) delta — pass mode='rebuild'")
            t0 = time.perf_counter()
            with self._lock:
                st = self._state
                snap_n = st.delta_n
                d_src = np.nonzero(st.delta_alive[:snap_n])[0]
                fold_rows = st.delta[d_src].copy()
                fold_gids = st.delta_ids[d_src].astype(np.int64)
                if mode == "rebuild":
                    expects(st.store is not None,
                            "rebuild compaction needs the retained row store "
                            "(retain_vectors=True / dataset=)")
                    s_src = np.nonzero(st.sealed_alive)[0]

            # ---- the fold, off the write lock ---------------------------------
            if mode == "extend":
                n_old = len(st.id_map)
                if len(d_src):
                    new_sealed = cfg.module.extend(
                        st.sealed, fold_rows,
                        new_ids=torch.arange(n_old, n_old + len(d_src),
                                             dtype=torch.int32),
                        res=res)
                else:
                    new_sealed = st.sealed
                new_id_map = np.concatenate([st.id_map, fold_gids])
                new_store = (np.concatenate([_store_rows(st.store), fold_rows])
                             if st.store is not None else None)
                reclaimed = 0
            else:
                live_rows = np.concatenate([_store_rows(st.store)[s_src],
                                            fold_rows])
                expects(live_rows.shape[0] > 0,
                        "compaction would leave an empty index")
                new_id_map = np.concatenate([st.id_map[s_src], fold_gids])
                new_store = live_rows
                reclaimed = len(st.id_map) - len(s_src)
                if ooc_chunk_rows is not None:
                    # the out-of-core fold: the builder streams the live
                    # rows chunk by chunk (all four kinds take readers)
                    x = chunked.ChunkedReader(live_rows, chunk_rows=int(ooc_chunk_rows))
                else:
                    x = torch.from_numpy(np.ascontiguousarray(live_rows)).to(cfg.device)
                if self._builder is not None:
                    new_sealed = self._builder(x, res=res)
                    got_kind, _ = _resolve_kind(new_sealed)
                    expects(got_kind == cfg.kind,
                            "builder returned a %s index for a %s mutable "
                            "index", got_kind, cfg.kind)
                    new_sealed = _to_device(cfg.kind, new_sealed, cfg.device)
                elif cfg.kind == "brute_force":
                    from ..neighbors import brute_force

                    new_sealed = brute_force.BruteForce(
                        cfg.metric, cfg.metric_arg).build(x, res=res)
                else:
                    ip = self._index_params
                    if cfg.kind == "cagra" and ip is None:
                        ip = cfg.module.IndexParams()
                    expects(ip is not None,
                            "rebuild compaction of %s needs index_params "
                            "(build configuration)", cfg.kind)
                    new_sealed = cfg.module.build(ip, x, res=res)
            # the successor is complete on the device before the swap
            _wait(cfg)
            id_map_dev = _dev_put(cfg, new_id_map.astype(np.int32))

            # ---- the swap ---------------------------------------------------------
            with self._lock:
                st = self._state
                nd = _StreamState(cfg)
                nd.sealed = new_sealed
                nd.id_map = new_id_map
                # residency carries through the fold: the successor's store
                # is placed with the predecessor's (its promote still honours
                # the budget: a squeezed successor comes up cold)
                nd.store = self._make_store(
                    new_store, epoch=st.epoch + 1,
                    residency=(st.store.residency
                               if isinstance(st.store, TieredStore) else None))
                # alive bits re-read from the LIVE state: deletes that
                # landed mid-fold are kept across the swap
                if mode == "extend":
                    nd.sealed_alive = np.concatenate(
                        [st.sealed_alive, st.delta_alive[d_src]])
                else:
                    nd.sealed_alive = np.concatenate(
                        [st.sealed_alive[s_src], st.delta_alive[d_src]])
                nd.sealed_dead_n = int(len(nd.sealed_alive)
                                       - nd.sealed_alive.sum())
                dt = _np_dtype(cfg.query_dtype)
                nd.delta = np.zeros((self.delta_capacity, cfg.dim), dt)
                nd.delta_ids = np.zeros(self.delta_capacity, np.int32)
                nd.delta_alive = np.zeros(self.delta_capacity, bool)
                rem = st.delta_n - snap_n
                if rem:
                    nd.delta[:rem] = st.delta[snap_n:st.delta_n]
                    nd.delta_ids[:rem] = st.delta_ids[snap_n:st.delta_n]
                    nd.delta_alive[:rem] = st.delta_alive[snap_n:st.delta_n]
                nd.delta_n = rem
                nd.delta_oldest_at = self._clock() if rem else None
                nd.epoch = st.epoch + 1
                nd.id_map_dev = id_map_dev
                _refresh_sealed_keep(nd)
                _refresh_delta(nd, self.delta_capacity)
                self._loc = _build_loc(nd)
                old_state, self._state = st, nd
                # retirement audit: the pre-compaction epoch (and a replaced
                # sealed index) should free once draining leases drop it
                obs_mem.retire(old_state.mem)
                if isinstance(old_state.store, TieredStore):
                    old_state.store.retire()
                if nd.sealed is not old_state.sealed:
                    old_sealed_mem = self._sealed_mem
                    self._sealed_mem = obs_mem.account_index(
                        nd.sealed, name=cfg.name, shard=self._shard,
                        epoch=nd.epoch)
                    obs_mem.retire(old_sealed_mem)
                self._update_gauges(nd)
            report = {"mode": mode, "epoch": nd.epoch,
                      "folded": int(len(d_src)), "reclaimed": int(reclaimed),
                      "sealed_rows": int(len(nd.id_map)),
                      "delta_remaining": int(rem),
                      "wall_s": round(time.perf_counter() - t0, 3)}
            if self._wal is not None and self._snapshot_path is not None:
                # WAL truncation rides the swap: the post-fold state lands
                # atomically at snapshot_path, and save() resets the log
                # once the rename is durable
                save(self, self._snapshot_path)
                report["snapshot"] = self._snapshot_path
            return report


# -- files (the JAX package's "stream" section) ------------------------------------

def save(mutable: MutableIndex, path: str) -> None:
    """Serialize the full mutable state (sealed index, delta memtable,
    tombstone bitsets, id map, the WAL sequence it covers) as one
    ``stream`` section, byte for byte the JAX package's file of the same
    state. The sealed index rides embedded through its module's
    ``write_index``.

    ATOMIC (:func:`raft_tpu_torch.core.serialize.atomic_write`): a crash
    mid-save leaves the previous snapshot readable. With a WAL, the log is
    truncated only AFTER the rename is durable: a crash before it keeps the
    old snapshot and the full log, a crash after it the new snapshot and a
    log whose records are all covered (replay skips them)."""
    from ..core import serialize
    from ..core.serialize import (atomic_write, serialize_header,
                                  serialize_mdspan, serialize_scalar)

    with mutable._lock:
        st = mutable._state
        cfg = mutable._cfg
        with atomic_write(path) as f:
            serialize_header(f, "stream")
            serialize_scalar(f, cfg.kind)
            serialize_scalar(f, cfg.name)
            serialize_scalar(f, mutable.delta_capacity)
            serialize_scalar(f, int(mutable._next_id))
            if serialize.version_number(serialize.SERIALIZATION_VERSION) >= 10:
                serialize_scalar(f, int(mutable._wal_seq))
            serialize_scalar(f, int(st.delta_n))
            serialize_scalar(f, st.store is not None)
            if serialize.version_number(serialize.SERIALIZATION_VERSION) >= 12:
                # the tier layout (raft_tpu/12): storage policy and the
                # store's residency ("device" for the untiered store), so
                # load restores the placement without deciding again
                serialize_scalar(f, mutable._storage)
                serialize_scalar(f, (st.store.residency
                                     if isinstance(st.store, TieredStore)
                                     else "device"))
            serialize_mdspan(f, st.id_map)
            serialize_mdspan(f, st.sealed_alive)
            serialize_mdspan(f, st.delta[:st.delta_n])
            serialize_mdspan(f, st.delta_ids[:st.delta_n])
            serialize_mdspan(f, st.delta_alive[:st.delta_n])
            if st.store is not None:
                serialize_mdspan(f, _store_rows(st.store))
            cfg.module.write_index(f, st.sealed)
        if mutable._wal is not None:
            mutable._wal.reset()


def load(path: str, *, search_params=None, index_params=None,
         builder: Callable | None = None, name: str | None = None,
         device=None, res=None, wal=None, snapshot_path: str | None = None,
         shard: int | None = None, tier: TierPolicy | None = None,
         clock: Callable[[], float] = time.monotonic) -> MutableIndex:
    """Load a :func:`save`\\ d mutable index (the port's or the JAX
    package's) onto ``device`` (or ``res``'s device; ``cuda`` by default).
    ``search_params`` / ``index_params`` / ``builder`` are runtime
    configuration, supplied fresh as for every other index loader.

    ``wal`` (a path or a :class:`~raft_tpu_torch.stream.wal.WriteAheadLog`)
    is the crash-recovery entry: every intact record past the snapshot's
    ``wal_seq`` replays through the ordinary write path (no re-append),
    then the log re-attaches for new writes; ``m.last_recovery`` reports
    ``{replayed, skipped, torn, wal_seq}``. ``snapshot_path`` re-arms the
    compaction-coupled snapshot (defaults to ``path`` whenever a WAL is
    given). A file saved with ``storage="tiered"`` comes back tiered (``tier``
    is its fresh :class:`TierPolicy`) with its saved residency, restored
    without deciding again; a saved device residency that no longer fits the
    budget comes up cold. Files of ``raft_tpu/11`` and before load as
    ``storage="hbm"``."""
    from ..core.serialize import (check_header, deserialize_mdspan,
                                  deserialize_scalar, version_number)

    if device is None:
        device = (res or default_resources()).torch_device
    device = torch.device(device)
    mods = _modules()
    with open(path, "rb") as f:
        ver = check_header(f, "stream")
        kind = deserialize_scalar(f)
        saved_name = deserialize_scalar(f)
        capacity = int(deserialize_scalar(f))
        next_id = int(deserialize_scalar(f))
        wal_seq = (int(deserialize_scalar(f))
                   if version_number(ver) >= 10 else 0)
        delta_n = int(deserialize_scalar(f))
        has_store = bool(deserialize_scalar(f))
        storage, residency = "hbm", None
        if version_number(ver) >= 12:
            storage = deserialize_scalar(f)
            residency = deserialize_scalar(f)
        id_map = deserialize_mdspan(f).numpy()
        sealed_alive = deserialize_mdspan(f).numpy().astype(bool)
        delta = deserialize_mdspan(f).numpy()
        delta_ids = deserialize_mdspan(f).numpy()
        delta_alive = deserialize_mdspan(f).numpy().astype(bool)
        store = deserialize_mdspan(f).numpy() if has_store else None
        sealed = mods[kind].read_index(f, device)

    if snapshot_path is None and wal is not None:
        snapshot_path = path
    m = MutableIndex(sealed, search_params=search_params,
                     index_params=index_params, delta_capacity=capacity,
                     retain_vectors=has_store, dataset=store, builder=builder,
                     device=device, snapshot_path=snapshot_path, shard=shard,
                     storage=storage, tier=tier,
                     tier_residency=residency if storage == "tiered" else None,
                     name=saved_name if name is None else name, clock=clock)
    with m._lock:
        st = m._state
        st.id_map = id_map.astype(np.int64)
        st.sealed_alive = sealed_alive
        st.sealed_dead_n = int(sealed_alive.size - sealed_alive.sum())
        st.delta[:delta_n] = delta
        st.delta_ids[:delta_n] = delta_ids
        st.delta_alive[:delta_n] = delta_alive
        st.delta_n = delta_n
        # the restored delta's write times are gone: age it from load time,
        # so the Compactor's max_age_s stays armed for it
        st.delta_oldest_at = clock() if delta_n else None
        m._next_id = next_id
        st.id_map_dev = _dev_put(st.cfg, st.id_map.astype(np.int32))
        _refresh_sealed_keep(st)
        st.delta_view = None
        _refresh_delta(st, capacity)
        m._loc = _build_loc(st)
        m._update_gauges(st)
        m._wal_seq = wal_seq
    if wal is not None:
        if not hasattr(wal, "replay"):
            from .wal import WriteAheadLog

            wal = WriteAheadLog(wal, name=m.name)
        # replay through the ORDINARY write path (m._wal is still None, so
        # nothing re-appends)
        replayed, last = 0, wal_seq
        for seq, op, rows, ids in wal.replay(after_seq=wal_seq):
            if op == "upsert":
                m.upsert(rows, ids=ids)
            else:
                m.delete(ids)
            replayed, last = replayed + 1, seq
        m.last_recovery = {
            "replayed": replayed,
            "skipped": wal.last_scan["records"] - replayed,
            "torn": wal.last_scan["torn"], "wal_seq": last}
        with m._lock:
            m._wal = wal
            m._wal_seq = last
    return m
