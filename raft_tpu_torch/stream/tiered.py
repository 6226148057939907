"""TieredStore: beyond-HBM storage for the refine epilogue's full-precision rows.

Counterpart of raft_tpu/stream/tiered.py (the DiskANN / FreshDiskANN storage
split, Subramanya et al. 2019, Singh et al. 2021): the PQ codes and coarse
structures stay on the card, where every query scans them, while the raw
rows the exact re-rank reads live in host RAM or in an on-disk file, and
cross to the card only as per-batch candidate gathers.

- **The row store** (:class:`TieredStore`): one (n, d) row array on one
  cold tier (``host`` RAM, or ``disk``: an ``np.memmap`` file per store
  epoch when :attr:`TierPolicy.disk_path` is set, or the caller's own memmap,
  adopted in place), plus an optional **device mirror**, the promoted state,
  byte for byte the all-HBM store. :func:`decide_placement` prices the
  mirror against ``Resources.memory_budget_bytes`` through the obs.mem
  ledger (no budget: stay cold). Residency moves at run time: the ledger's
  gate consults :func:`_relieve_pressure` before it refuses an admission (a
  mirror is a cache; dropping it beats shedding a write), and
  ``promote_min_hits`` cold fetches under an armed budget with headroom
  lift the mirror back. Every move is a counted journal event.
- **The fetch** (:meth:`TieredStore.fetch`), the refine hop. A cold store
  reads the candidate slot ids back to the host (the batch's one host
  sync, counted in ``stats()["host_syncs"]``), gathers the rows with
  ``torch.index_select`` into a pinned host buffer and uploads it with a
  non-blocking copy on the store's side stream; the consuming stream waits
  on the upload's event. The design, for a card:

  * **Pinned buffers**: a ring of ``fetch_slots`` buffers per shape, each
    with the event of the last copy that read it and a lock; a buffer is
    rewritten only after that event has completed (the use-after-rewrite
    race of ``core.chunked.ChunkStager``).
  * **Device slots**: a fresh tensor per upload, allocated on the side
    stream and marked with ``record_stream`` for the consuming stream. A
    tensor a concurrent search still holds is never written again (the
    port's "replace, never mutate" rule, ``stream/mutable.py``): the caching
    allocator reuses its block only after the consumer's work on it, and
    only once the last reference is gone. A ring slot with an event per
    slot would have to be rewritten while a lock-free search on another
    thread may not yet have queued its reads of it.
  * **The ledger**: the ring keeps the last ``fetch_slots`` uploads of each
    shape and accounts their bytes once per shape, so the accounted slot
    bytes stay constant in steady state; a displaced upload frees by
    reference drop, as in the JAX module.

  On the CPU the store gathers into plain tensors, with no pinned memory
  and no stream, as ``ChunkStager(device="cpu")`` does.
- **The chunked oracle** (:meth:`TieredStore.oracle_chunk_dev`): fixed-shape
  chunks of the cold rows through the same ring, so ``exact_search`` and the
  recall canary score the whole corpus with zero net device row bytes.
- **Observability**: ``raft_tpu_tier_*`` metrics, the ``tiers`` section of
  :func:`raft_tpu_torch.obs.mem.debug_payload`, and the host side gated by
  ``Resources.host_budget_bytes`` (:func:`raft_tpu_torch.obs.mem.gate_host`).

:class:`raft_tpu_torch.stream.MutableIndex` composes this behind
``storage="tiered"``: the retained row store becomes a TieredStore, the
refine epilogue gathers through :meth:`TieredStore.fetch`, compaction folds
carry residency over, and ``save`` / ``load`` persist the layout.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import threading
import time
import warnings
import weakref
from typing import Callable

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import default_resources
from ..obs import dispatch as obs_dispatch
from ..obs import events as obs_events
from ..obs import mem as obs_mem
from ..obs import metrics
from ..testing import faults

__all__ = ["TierPolicy", "TieredStore", "TIERS", "decide_placement",
           "tier_totals", "debug_tiers", "spillable_bytes", "mirror_gather",
           "shift_slots", "tier_peak", "reset_tier_peak"]

# residency tiers, hottest first: the vocabulary of the metrics, the
# ``tiers`` debug section, obs.mem.plan(storage="tiered") and the saved layout
TIERS = ("device", "host", "disk")


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Run-time configuration of a :class:`TieredStore` (supplied fresh at
    ``load`` like ``search_params``; only the decided layout is saved).

    ``disk_path``: path prefix of the cold mmap file (``<prefix>.<name>.e<N>``
    per store epoch, so a compaction successor never clobbers pages a
    draining reader still maps); ``None`` keeps rows in host RAM.
    ``oracle_chunk``: rows of one chunk of the chunked exact scan (a power of
    two). ``fetch_slots``: depth of the per-shape upload ring (2 = double
    buffering). ``promote_min_hits``: cold fetches before the store promotes
    its mirror, under an armed ``memory_budget_bytes`` with headroom only
    (``auto_promote=False`` leaves residency to explicit
    :meth:`TieredStore.promote` / ``spill`` calls)."""

    disk_path: str | None = None
    oracle_chunk: int = 8192
    fetch_slots: int = 2
    promote_min_hits: int = 3
    auto_promote: bool = True

    def __post_init__(self):
        expects(self.oracle_chunk >= 8
                and (self.oracle_chunk & (self.oracle_chunk - 1)) == 0,
                "oracle_chunk must be a power of two >= 8, got %d",
                self.oracle_chunk)
        expects(self.fetch_slots >= 2,
                "fetch_slots must be >= 2 (double buffering), got %d",
                self.fetch_slots)


# -- metrics (the JAX package's names) ----------------------------------------

@functools.lru_cache(maxsize=None)
def _g_tier_bytes():
    return metrics.gauge(
        "raft_tpu_tier_bytes",
        "live bytes per storage tier (device mirror + gather slots / host "
        "RAM rows / disk mmap rows) per tiered store", unit="bytes")


@functools.lru_cache(maxsize=None)
def _c_fetches():
    return metrics.counter(
        "raft_tpu_tier_fetch_total",
        "refine/oracle gathers served by a tiered store, by source tier")


@functools.lru_cache(maxsize=None)
def _c_h2d():
    return metrics.counter(
        "raft_tpu_tier_h2d_bytes_total",
        "host->device bytes transferred by cold-tier gathers (the refine "
        "hop's transfer cost; 0 while the mirror is resident)",
        unit="bytes")


@functools.lru_cache(maxsize=None)
def _c_spills():
    return metrics.counter(
        "raft_tpu_tier_spill_total",
        "device mirrors dropped, by reason (pressure = the obs.mem budget "
        "gate reclaimed HBM for an admission; explicit = spill() called)")


@functools.lru_cache(maxsize=None)
def _c_promotes():
    return metrics.counter(
        "raft_tpu_tier_promote_total",
        "device-mirror promotions (construction placement, hit-rate "
        "auto-promote, explicit promote(), load() layout restore)")


@functools.lru_cache(maxsize=None)
def _g_hit_ratio():
    return metrics.gauge(
        "raft_tpu_tier_hit_ratio",
        "fraction of fetched rows served device-resident (mirror hits / "
        "all fetched rows) since the store was created")


# -- device pieces ---------------------------------------------------------------

def mirror_gather(rows_dev: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Device-side candidate gather (the promoted / all-HBM refine path):
    ``rows_dev[clip(slots, 0)]``; sentinel slots read row 0 and are masked
    by candidate id downstream."""
    obs_dispatch.note(1)
    return rows_dev[slots.clamp_min(0).to(torch.int64)]


def shift_slots(ids: torch.Tensor, base: int) -> torch.Tensor:
    """Chunk-local candidate ids into store-slot ids; ``-1`` passes through."""
    obs_dispatch.note(1)
    return torch.where(ids >= 0, ids + int(base), ids)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A zero-copy tensor over a host array (a read-only memmap included:
    the store never writes through it)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a)


# -- placement -------------------------------------------------------------------

def decide_placement(n_bytes: int, res=None) -> str:
    """Initial mirror placement of ``n_bytes`` of raw rows: ``"device"`` only
    when a device budget is armed and the ledger's device bytes plus the
    mirror fit it; an unbudgeted store stays cold. A pure decision."""
    res = res or default_resources()
    budget = getattr(res, "memory_budget_bytes", None)
    if budget is None or not metrics._enabled:
        return "host"
    used = obs_mem.totals()["device_bytes"]
    return "device" if used + int(n_bytes) <= int(budget) else "host"


# -- live-store registry (the tiers debug section, pressure spills) --------------

_stores: "weakref.WeakSet[TieredStore]" = weakref.WeakSet()
_registered = False


def _ensure_registered() -> None:
    """Install the module's obs.mem hooks once, at the first store (importing
    the stream package must not touch the ledger's hook tables)."""
    global _registered
    if _registered:
        return
    _registered = True
    obs_mem.register_pressure_handler(_relieve_pressure)
    obs_mem.register_debug_section("tiers", debug_tiers)


def _relieve_pressure(need_bytes: int) -> int:
    """Budget-pressure spill: drop device mirrors, largest first, until
    ``need_bytes`` are reclaimed or none is left. Returns the bytes freed."""
    freed = 0
    stores = sorted((s for s in list(_stores) if s.mirror_resident),
                    key=lambda s: -s.row_bytes)
    for s in stores:
        if freed >= need_bytes:
            break
        freed += s.spill(reason="pressure")
    return freed


def spillable_bytes() -> int:
    """Device bytes a pressure spill could reclaim now: every live store's
    resident mirror (0 when no tiered store is live)."""
    return sum(s.row_bytes for s in list(_stores) if s.mirror_resident)


def tier_totals() -> dict:
    """Per-tier byte totals over every live store (empty with none live)."""
    out: dict[str, int] = {}
    for s in list(_stores):
        for tier, b in s.tier_bytes().items():
            if b:
                out[tier] = out.get(tier, 0) + b
    return out


# per-tier high-water marks since the last reset: a store that lived and died
# inside a measured window still shows in them
_tier_peak: dict = {}


def _note_tier_peak() -> None:
    for tier, b in tier_totals().items():
        if b > _tier_peak.get(tier, 0):
            _tier_peak[tier] = b


def reset_tier_peak() -> None:
    """Re-base the per-tier watermarks (as ``obs.mem.reset_peak``)."""
    _tier_peak.clear()
    _note_tier_peak()


def tier_peak() -> dict:
    """Per-tier high-water bytes since the last :func:`reset_tier_peak`."""
    return dict(_tier_peak)


def debug_tiers() -> dict:
    """The ``tiers`` debug section: every live store's residency, tier
    bytes, fetch and hit counters and recent spill / promote events."""
    stores = [s.stats() for s in list(_stores)]
    stores.sort(key=lambda r: (r["name"], r["shard"] or 0))
    return {"stores": stores, "totals": tier_totals()}


# -- the store -------------------------------------------------------------------

class _Ring:
    """One shape's upload ring: the last ``fetch_slots`` device uploads (the
    accounted slots) and, on a card, the pinned host buffers with the event
    of the copy that last read each and a lock each."""

    __slots__ = ("dev", "turn", "host", "events", "locks", "hturn")

    def __init__(self):
        self.dev: list = []
        self.turn = 0
        self.host: list = []
        self.events: list = []
        self.locks: list = []
        self.hturn = 0


class TieredStore:
    """Tiered raw-row store (see the module docstring).

    ``rows`` (n, d) land on the cold tier ``policy`` chooses (host RAM, or a
    ``<disk_path>.<name>.e<epoch>`` mmap), or stay where they are when they
    are an ``np.memmap`` and no ``disk_path`` is set (adopted, priced at 0
    host bytes). The device mirror is placed by :func:`decide_placement`
    against ``res``, or restored by ``residency=`` (the ``load`` path, which
    does not decide again). ``device`` is where uploads and the mirror go
    (default: ``res``'s device); ``name`` / ``shard`` / ``epoch`` key the
    ledger entry and the metric series."""

    def __init__(self, rows, *, name: str = "default",
                 shard: int | None = None, epoch: int = 0,
                 policy: TierPolicy | None = None, device=None, res=None,
                 residency: str | None = None,
                 clock: Callable[[], float] = time.monotonic):
        # memmap detection sees the raw argument: np.asarray would strip the
        # memmap subclass, and with it the disk-backed pricing
        raw = rows
        rows = np.asarray(rows)
        expects(rows.ndim == 2 and rows.shape[0] > 0,
                "TieredStore rows must be (n>0, d)")
        self._policy = policy or TierPolicy()
        self._name = name
        self._shard = None if shard is None else int(shard)
        self._epoch = int(epoch)
        res = res or default_resources()
        self._device = (res.torch_device if device is None
                        else torch.device(device))
        self._cuda = self._device.type == "cuda"
        self._clock = clock
        self._lock = threading.Lock()
        # guards the rings' bookkeeping; distinct from _lock so stats() never
        # waits behind an upload
        self._ring_lock = threading.Lock()
        self._mirror = None
        self._promoting = False   # the promote transition's reservation flag
        self._cold_fetches = 0    # host / disk gathers since the last promote
        self._rows_fetched = 0
        self._rows_hit = 0        # rows served from the resident mirror
        self._h2d_bytes = 0
        self._fetch_wall_s = 0.0  # host gathers + upload dispatch walls
        self._gather_wall_s = 0.0  # the host gathers alone
        self._host_syncs = 0      # slot-id reads back to the host
        self._spills = 0
        self._promotes = 0
        self._events: collections.deque = collections.deque(maxlen=16)
        self._rings: dict[tuple, _Ring] = {}
        self._slot_bytes = 0
        self._side = None         # the upload stream, made at the first upload

        self._mmap_adopted = False
        if self._policy.disk_path is None and isinstance(raw, np.memmap):
            # adopt the caller's memmap as the cold tier (a ChunkedReader's
            # backing array): no copy in memory, 0 host bytes
            self._disk_file = None
            self._mmap_adopted = True
            self._rows = raw
            host_gate = 0
        elif self._policy.disk_path is not None:
            self._disk_file = (f"{self._policy.disk_path}"
                               f".{name.replace('/', '_')}.e{self._epoch}")
            # unlink first: open_memmap("w+") truncates in place, which would
            # destroy pages a live older store of the same (path, name, epoch)
            # still maps; the unlink leaves its inode alive for it
            _unlink_quiet(self._disk_file)
            mm = np.lib.format.open_memmap(
                self._disk_file, mode="w+", dtype=rows.dtype, shape=rows.shape)
            mm[:] = rows
            mm.flush()
            self._rows = mm
            # the epoch file dies with the store, unless a later store has
            # reused the path (a fresh inode), whose file stays
            stat = os.stat(self._disk_file)
            weakref.finalize(self, _unlink_if_same_inode, self._disk_file,
                             (stat.st_dev, stat.st_ino))
            host_gate = 0
        else:
            self._disk_file = None
            self._rows = np.ascontiguousarray(rows)
            host_gate = self._rows.nbytes
        self._rows_t = _host_tensor(self._rows)
        # host admission, whole or nothing, before the ledger entry lands; a
        # store adds no device bytes, so the device budget does not run here
        obs_mem.gate_host(res, host_gate, site="tier",
                          detail=f"tiered store {name!r}")
        self._mem = obs_mem.account(
            "tier", name=name, shard=self._shard, epoch=self._epoch,
            host=([] if self._on_disk else [self._rows]), owner=self)
        _ensure_registered()
        _stores.add(self)
        if residency is None:
            residency = decide_placement(self._rows.nbytes, res)
        expects(residency in TIERS,
                "residency must be one of %s, got %r", TIERS, residency)
        if residency == "device":
            self.promote(res=res, reason="placement")
        self._publish_gauges()

    # -- introspection ---------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return self._rows.shape

    @property
    def dtype(self):
        return self._rows.dtype

    @property
    def row_bytes(self) -> int:
        """Bytes of one full copy of the rows (what a mirror costs)."""
        return int(self._rows.nbytes)

    @property
    def policy(self) -> TierPolicy:
        return self._policy

    @property
    def mirror_resident(self) -> bool:
        return self._mirror is not None

    @property
    def _on_disk(self) -> bool:
        """Cold rows are disk-backed (an epoch file or an adopted memmap)."""
        return self._disk_file is not None or self._mmap_adopted

    @property
    def mirror(self):
        """The promoted device copy (None while cold)."""
        return self._mirror

    @property
    def residency(self) -> str:
        """``device`` while the mirror is resident, else ``disk`` / ``host``
        by the backing array: the scalar ``save`` persists."""
        if self._mirror is not None:
            return "device"
        return "disk" if self._on_disk else "host"

    def host_view(self) -> np.ndarray:
        """The cold row array (ndarray or memmap): what folds, drift sampling
        and files read."""
        return self._rows

    def tier_bytes(self) -> dict:
        """Live bytes per tier: device = mirror + the rings' slots; one of
        host / disk carries the rows."""
        dev = self._slot_bytes + (self.row_bytes if self._mirror is not None
                                  else 0)
        return {
            "device": int(dev),
            "host": 0 if self._on_disk else self.row_bytes,
            "disk": self.row_bytes if self._on_disk else 0,
        }

    def stats(self) -> dict:
        """The JAX store's ``stats()`` plus ``host_syncs`` and
        ``gather_wall_s``."""
        tb = self.tier_bytes()
        return {
            "name": self._name, "shard": self._shard, "epoch": self._epoch,
            "rows": int(self._rows.shape[0]),
            "dim": int(self._rows.shape[1]),
            "dtype": str(self._rows.dtype),
            "residency": self.residency,
            "tier_bytes": tb,
            "rows_fetched": self._rows_fetched,
            "hit_ratio": (self._rows_hit / self._rows_fetched
                          if self._rows_fetched else 0.0),
            "h2d_bytes": self._h2d_bytes,
            "fetch_wall_s": round(self._fetch_wall_s, 6),
            "spills": self._spills, "promotes": self._promotes,
            "events": list(self._events),
            "host_syncs": self._host_syncs,
            "gather_wall_s": round(self._gather_wall_s, 6),
        }

    # -- accounting ------------------------------------------------------------
    def _reaccount(self) -> None:
        dev = [] if self._mirror is None else [self._mirror]
        with self._ring_lock:
            for ring in self._rings.values():
                dev.extend(ring.dev)
        obs_mem.reaccount(
            self._mem, device=dev,
            host=([] if self._on_disk else [self._rows]))

    def _publish_gauges(self) -> None:
        """Per-tier gauges and the peak watermark; only where tier bytes can
        change (construction, promote / spill, ring growth), never a fetch."""
        _note_tier_peak()
        if not metrics._enabled:
            return
        for tier, b in self.tier_bytes().items():
            _g_tier_bytes().set(b, tier=tier, name=self._name)
        self._publish_hit_ratio()

    def _publish_hit_ratio(self) -> None:
        if metrics._enabled and self._rows_fetched:
            _g_hit_ratio().set(self._rows_hit / self._rows_fetched,
                               name=self._name)

    # -- residency moves -------------------------------------------------------
    def promote(self, res=None, *, force: bool = False,
                reason: str = "explicit") -> bool:
        """Lift the device mirror (idempotent). Unless ``force``, it is priced
        against ``res.memory_budget_bytes`` first; a store that does not fit
        stays cold and returns False (a skipped optimisation, never an
        error). The transition is reserved under the lock before the upload,
        so two threads crossing ``promote_min_hits`` together upload once."""
        with self._lock:
            if self._mirror is not None:
                return True
            if self._promoting:
                return False
            self._promoting = True
        try:
            if not force and not self._headroom(res):
                return False
            mirror = _host_tensor(np.ascontiguousarray(self._rows)).to(
                self._device)
            with self._lock:
                self._mirror = mirror
            self._promotes += 1
            self._events.append({"event": "promote", "reason": reason,
                                 "at": round(self._clock(), 3)})
            obs_events.emit(
                "tier_promote", subject=("tier", self._name, None, None),
                evidence={"reason": reason, "bytes": self.row_bytes},
                counter=_c_promotes, counter_labels={"name": self._name})
        finally:
            with self._lock:
                self._promoting = False
        self._reaccount()
        self._publish_gauges()
        return True

    def _headroom(self, res) -> bool:
        res = res or default_resources()
        budget = getattr(res, "memory_budget_bytes", None)
        if budget is None:
            return True
        if not metrics._enabled:
            return False
        used = obs_mem.totals()["device_bytes"]
        return used + self.row_bytes <= int(budget)

    def spill(self, reason: str = "explicit") -> int:
        """Drop the device mirror (idempotent); returns the bytes freed. The
        cold copy is authoritative, so nothing is lost; searches in flight
        keep their snapshot of the mirror."""
        with self._lock:
            if self._mirror is None:
                return 0
            self._mirror = None
        freed = self.row_bytes
        self._cold_fetches = 0
        self._spills += 1
        self._events.append({"event": "spill", "reason": reason,
                             "at": round(self._clock(), 3)})
        obs_events.emit(
            "tier_spill",
            severity="warning" if reason == "pressure" else "info",
            subject=("tier", self._name, None, None),
            evidence={"reason": reason, "freed_bytes": freed},
            counter=_c_spills,
            counter_labels={"name": self._name, "reason": reason})
        self._reaccount()
        self._publish_gauges()
        return freed

    def retire(self) -> None:
        """Mark the ledger entry expected to free (a compaction retiring the
        pre-fold epoch's store)."""
        obs_mem.retire(self._mem)

    # -- the upload ring ---------------------------------------------------------
    def _upload(self, key: tuple, shape: tuple, fill) -> torch.Tensor:
        """A fresh device tensor of ``shape`` holding what ``fill(host)``
        writes into a host tensor of that shape (see the module docstring
        for the card's pinned ring, side stream and events). The ring keeps
        the last ``fetch_slots`` uploads of ``key``; its bytes are accounted
        once, when the ring grows."""
        tdt = self._rows_t.dtype
        with self._ring_lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = _Ring()
            if self._cuda:
                if self._side is None:
                    self._side = torch.cuda.Stream(device=self._device)
                j = ring.hturn
                ring.hturn = (j + 1) % self._policy.fetch_slots
                if len(ring.host) <= j:
                    ring.host.append(torch.empty(shape, dtype=tdt, pin_memory=True))
                    ring.events.append(None)
                    ring.locks.append(threading.Lock())
        if not self._cuda:
            dev = torch.empty(shape, dtype=tdt)
            fill(dev)
        else:
            with ring.locks[j]:
                # the copy that last read this buffer has finished
                if ring.events[j] is not None:
                    ring.events[j].synchronize()
                fill(ring.host[j])
                consumer = torch.cuda.current_stream(self._device)
                with torch.cuda.stream(self._side):
                    dev = torch.empty(shape, dtype=tdt, device=self._device)
                    dev.copy_(ring.host[j], non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self._side)
                ring.events[j] = done
                consumer.wait_event(done)
                # the allocator reuses the block only after the consumer's work
                dev.record_stream(consumer)
        grew = 0
        with self._ring_lock:
            if len(ring.dev) < self._policy.fetch_slots:
                ring.dev.append(dev)
                grew = dev.numel() * dev.element_size()
            else:
                ring.dev[ring.turn] = dev
                ring.turn = (ring.turn + 1) % len(ring.dev)
        if grew:
            with self._lock:
                self._slot_bytes += grew
            self._reaccount()
            self._publish_gauges()
        return dev

    def fetch(self, slots, res=None) -> torch.Tensor:
        """Gather candidate rows by store slot for the refine epilogue:
        ``slots`` (m, k0) int (``-1`` = padding, reads row 0, masked
        downstream) -> rows (m, k0, d) on the store's device. A resident
        mirror gathers on the device (a hit, no transfer); a cold store reads
        the slots back (one host sync), gathers on the host and uploads
        through the ring. ``promote_min_hits`` cold fetches under an armed
        budget with headroom promote the mirror."""
        faults.fire("tier/fetch", name=self._name, residency=self.residency)
        # one read of the mirror decides the branch and supplies the tensor:
        # a pressure spill on a writer thread cannot tear this query
        mirror = self._mirror
        if mirror is not None:
            out = mirror_gather(mirror, torch.as_tensor(slots).to(self._device))
            n_rows = int(np.prod(out.shape[:-1]))
            self._rows_fetched += n_rows
            self._rows_hit += n_rows
            if metrics._enabled:
                _c_fetches().inc(1, name=self._name, src="device")
            self._publish_hit_ratio()
            return out
        t0 = time.perf_counter()
        ids = torch.as_tensor(slots)
        if ids.device.type != "cpu":
            ids = ids.cpu()
            self._host_syncs += 1
        idx = ids.reshape(-1).clamp_min(0).to(torch.int64)
        d = self._rows.shape[1]
        shape = tuple(ids.shape) + (d,)
        rows_t = self._rows_t

        def fill(buf):
            t1 = time.perf_counter()
            torch.index_select(rows_t, 0, idx, out=buf.view(-1, d))
            self._gather_wall_s += time.perf_counter() - t1

        dev = self._upload(("fetch",) + shape, shape, fill)
        nbytes = dev.numel() * dev.element_size()
        self._fetch_wall_s += time.perf_counter() - t0
        self._rows_fetched += int(idx.numel())
        self._cold_fetches += 1
        self._h2d_bytes += nbytes
        src = "disk" if self._on_disk else "host"
        if metrics._enabled:
            _c_fetches().inc(1, name=self._name, src=src)
            _c_h2d().inc(nbytes, name=self._name)
        obs_dispatch.note(1)
        if (self._policy.auto_promote
                and self._cold_fetches >= self._policy.promote_min_hits):
            self._cold_fetches = 0
            # only under an armed budget with headroom: without one there is
            # no safe ceiling to promote a beyond-HBM store against
            res_eff = res or default_resources()
            if getattr(res_eff, "memory_budget_bytes", None) is not None:
                self.promote(res=res_eff, reason="hit-rate")
        self._publish_hit_ratio()
        return dev

    # -- the chunked oracle scan -----------------------------------------------
    @property
    def oracle_chunk(self) -> int:
        """Rows of one oracle chunk (every pass reuses this shape)."""
        return min(self._policy.oracle_chunk,
                   _pow2_at_least(self._rows.shape[0]))

    def n_oracle_chunks(self) -> int:
        c = self.oracle_chunk
        return -(-self._rows.shape[0] // c)

    def oracle_chunk_dev(self, ci: int):
        """``(rows_dev (chunk, d), base, valid)``: chunk ``ci`` of the cold
        rows uploaded through the ring; the last chunk is zero-padded and
        reports ``valid`` < chunk for the caller's mask."""
        c = self.oracle_chunk
        base = ci * c
        n, d = self._rows.shape
        expects(0 <= base < n, "oracle chunk %d out of range", ci)
        t0 = time.perf_counter()
        valid = min(c, n - base)
        block = self._rows[base:base + valid]

        def fill(buf):
            t1 = time.perf_counter()
            out = buf.numpy()
            np.copyto(out[:valid], block)
            if valid < c:
                out[valid:] = 0
            self._gather_wall_s += time.perf_counter() - t1

        dev = self._upload(("oracle", c), (c, d), fill)
        nbytes = dev.numel() * dev.element_size()
        self._fetch_wall_s += time.perf_counter() - t0
        self._h2d_bytes += nbytes
        src = "disk" if self._on_disk else "host"
        if metrics._enabled:
            _c_fetches().inc(1, name=self._name, src=src)
            _c_h2d().inc(nbytes, name=self._name)
        return dev, base, valid

    # no store-level warm helper: MutableIndex.warm_refined runs the real
    # search_refined and chunked-scan calls, filling these rings as it goes


def _pow2_at_least(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _unlink_if_same_inode(path: str, devino: tuple) -> None:
    """Unlink ``path`` only if it still names the inode the owning store
    created (a later store may have reused the path)."""
    try:
        stat = os.stat(path)
        if (stat.st_dev, stat.st_ino) == devino:
            os.unlink(path)
    except OSError:
        pass
