"""Memory ledger: live-bytes attribution, retirement audits, budget gate.

Counterpart of raft_tpu/obs/mem.py: the same ledger, metric names and audit,
over the port's tensors. Three pieces:

- **The ledger** (:class:`MemLedger`, module singleton behind the veneer
  functions). Every long-lived device/host allocation is
  :func:`account`\\ ed to ``(component, name, shard, epoch)`` — index stores
  (``index/<kind>``, accounted when the serve registry publishes them),
  serve staging buffers (``serve/staging``) and registry versions
  (``serve/version``). Totals publish as the ``raft_tpu_mem_device_bytes``
  / ``raft_tpu_mem_host_bytes`` gauges (per component+name) with process
  peak watermarks; per-device allocator occupancy rides
  ``raft_tpu_mem_hbm_bytes`` from ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info`` where a CUDA device is present (the CPU has
  none — there the ledger is the only view).

  Entries hold a **weakref** to their owner (the index / searcher
  closure): when the owner is garbage-collected the entry auto-releases,
  so accounted bytes are live bytes. The caching allocator rounds each
  block up, so ``torch.cuda.memory_allocated()`` reads a little above the
  ledger's tensor bytes.

- **The retirement audit**. :func:`retire` marks an allocation as
  expected-to-free (the registry marks a version at retire-after-drain).
  A retired entry that stays accounted — its owner still strongly
  referenced somewhere — is a leak; :func:`audit` lists them (optionally
  after a forced ``gc.collect()``) and the ``raft_tpu_mem_retired_unfreed``
  gauge tracks the count.

- **The budget gate**. ``Resources.memory_budget_bytes`` (None =
  unenforced, the default) is checked at ``publish`` admission through
  :func:`gate`, raising :class:`raft_tpu_torch.serve.errors.MemoryBudgetError`
  — an ``OverloadedError``, whole-or-nothing like every other admission
  refusal: the gate runs before any state lands.

- **The footprint estimator**. :func:`plan` predicts the index bytes and
  a build peak for each index kind, in-core or streamed
  (``core/chunked.py``), from the same sizing rules the builds use; it
  returns the JAX package's numbers for the same arguments. The builds
  gate on it before they spend anything: brute force on its upload's
  bytes, IVF-Flat, IVF-PQ and CAGRA on the planned index bytes, every
  streamed build on the planned build peak against the device budget and
  the planned host peak against ``Resources.host_budget_bytes``.

- **Pressure relief and the tiers**. A device overage consults the
  registered pressure handlers (:func:`register_pressure_handler`: the
  tiered stores of ``stream/tiered.py`` drop their device mirrors) once
  before the gate refuses; :func:`headroom` counts those mirrors as
  spillable, :func:`plan` prices a tiered store's cold rows on the host or
  disk tier, and :func:`debug_payload` carries every registered section
  (``tiers``).

``obs.disable()`` reduces every ledger touch point to a single module-flag
check (``account`` returns ``None`` and every entry point no-ops on
``None``).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
import weakref

import torch

from ..core.errors import RaftError
from . import events as obs_events
from . import metrics

__all__ = [
    "MemLedger", "ledger", "account", "account_index", "release", "retire",
    "reaccount", "totals", "reset_peak", "breakdown", "audit", "plan",
    "gate", "unaccounted_index_bytes", "hbm_stats", "note_workspace",
    "debug_payload", "gate_host", "headroom", "register_pressure_handler",
    "register_debug_section",
]

# -- metrics (catalogue: docs/observability.md) ------------------------------

@functools.lru_cache(maxsize=None)
def _g_device():
    return metrics.gauge(
        "raft_tpu_mem_device_bytes",
        "ledger-accounted live device bytes per component and name",
        unit="bytes")


@functools.lru_cache(maxsize=None)
def _g_host():
    return metrics.gauge(
        "raft_tpu_mem_host_bytes",
        "ledger-accounted live host bytes per component and name",
        unit="bytes")


@functools.lru_cache(maxsize=None)
def _g_device_peak():
    return metrics.gauge(
        "raft_tpu_mem_device_peak_bytes",
        "peak ledger-accounted device bytes since process start (or the "
        "last reset_peak)", unit="bytes")


@functools.lru_cache(maxsize=None)
def _g_host_peak():
    return metrics.gauge(
        "raft_tpu_mem_host_peak_bytes",
        "peak ledger-accounted host bytes since process start (or the "
        "last reset_peak)", unit="bytes")


@functools.lru_cache(maxsize=None)
def _g_hbm():
    return metrics.gauge(
        "raft_tpu_mem_hbm_bytes",
        "per-device allocator occupancy from torch.cuda.memory_stats() "
        "and mem_get_info() (stat in bytes_in_use/peak_bytes_in_use/"
        "bytes_reserved/bytes_limit); absent without a CUDA device — the "
        "ledger gauges are the fallback there", unit="bytes")


@functools.lru_cache(maxsize=None)
def _g_retired_unfreed():
    return metrics.gauge(
        "raft_tpu_mem_retired_unfreed",
        "allocations marked retired whose owner is still alive — the "
        "leak class the retirement audit exists to catch")


@functools.lru_cache(maxsize=None)
def _c_refusals():
    return metrics.counter(
        "raft_tpu_mem_budget_refusals_total",
        "admissions refused by the memory_budget_bytes gate, by site "
        "(build/publish/upsert)")


@functools.lru_cache(maxsize=None)
def _g_workspace():
    return metrics.gauge(
        "raft_tpu_mem_workspace_bytes",
        "transient workspace bytes implied by the last memory-aware tile "
        "choice per op — always <= Resources.workspace_bytes (the "
        "batching-heuristic contract, pinned by test)", unit="bytes")


# -- the ledger --------------------------------------------------------------

def _nbytes(arrays) -> int:
    """Total nbytes of one array or an iterable of arrays (duck-typed on
    ``.nbytes`` so tensors and numpy arrays both count)."""
    if arrays is None:
        return 0
    if hasattr(arrays, "nbytes"):
        return int(arrays.nbytes)
    return sum(int(a.nbytes) for a in arrays if a is not None)


class _Alloc:
    """One ledger entry. ``released`` flips exactly once (under the ledger
    lock); the owner weakref's callback routes through the ledger so a
    collected owner releases its entry automatically."""

    __slots__ = ("token", "component", "name", "shard", "epoch",
                 "device_bytes", "host_bytes", "created_at", "retired_at",
                 "released", "wref", "owner_key")

    def __init__(self, token, component, name, shard, epoch,
                 device_bytes, host_bytes, created_at):
        self.token = token
        self.component = component
        self.name = name
        self.shard = shard
        self.epoch = epoch
        self.device_bytes = device_bytes
        self.host_bytes = host_bytes
        self.created_at = created_at
        self.retired_at = None
        self.released = False
        self.wref = None
        self.owner_key = None


class MemLedger:
    """Thread-safe live-bytes ledger (see module doc). The module-level
    veneer functions operate on the process singleton (:func:`ledger`);
    construct directly for an isolated instance (tests)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        # REENTRANT: owner-weakref callbacks route through release(), and
        # the gc can run them on THIS thread at any allocation point —
        # including inside a ledger-locked section (a plain Lock would
        # deadlock). Re-entrant releases are safe: each completes atomically
        # in program order, and a just-created entry's owner is pinned by
        # the caller's frame, so the entry being built can never release
        # mid-account.
        self._lock = threading.RLock()
        self._allocs: dict[int, _Alloc] = {}
        # (id(owner), component) -> token: account() is idempotent per
        # owner+component — re-accounting replaces the entry (the stream
        # state's delta bucket grows; a wrapped sealed index re-attributes
        # under its serving name)
        self._owners: dict[tuple, int] = {}
        self._next = 1
        self._dev = 0
        self._host = 0
        self._dev_peak = 0
        self._host_peak = 0
        # per-(component, name) sums backing the labeled gauges
        self._cn: dict[tuple, list] = {}

    # -- internals (call under self._lock) ----------------------------------
    def _bump(self, a: _Alloc, dev_delta: int, host_delta: int) -> None:
        self._dev += dev_delta
        self._host += host_delta
        self._dev_peak = max(self._dev_peak, self._dev)
        self._host_peak = max(self._host_peak, self._host)
        cn = self._cn.setdefault((a.component, a.name), [0, 0])
        cn[0] += dev_delta
        cn[1] += host_delta
        if metrics._enabled:
            _g_device().set(cn[0], component=a.component, name=a.name)
            _g_host().set(cn[1], component=a.component, name=a.name)
            _g_device_peak().set(self._dev_peak)
            _g_host_peak().set(self._host_peak)

    def _release_locked(self, a: _Alloc) -> None:
        if a.released:
            return
        a.released = True
        self._bump(a, -a.device_bytes, -a.host_bytes)
        self._allocs.pop(a.token, None)
        # prune the owner map (a replacement already repointed the key —
        # only remove it while it still names THIS entry), or the ledger
        # would leak one dead mapping per publish→retire cycle forever
        if (a.owner_key is not None
                and self._owners.get(a.owner_key) == a.token):
            del self._owners[a.owner_key]
        if metrics._enabled and a.retired_at is not None:
            self._set_retired_gauge_locked()

    def _set_retired_gauge_locked(self) -> None:
        # list() snapshot: a gc-triggered owner callback can re-enter
        # release() on this thread (the RLock admits it) and mutate the
        # dict mid-iteration otherwise
        n = sum(1 for a in list(self._allocs.values())
                if a.retired_at is not None)
        _g_retired_unfreed().set(n)

    # -- accounting ----------------------------------------------------------
    def account(self, component: str, *, name: str = "default",
                shard: int | None = None, epoch: int = 0,
                device=None, host=None, device_bytes: int = 0,
                host_bytes: int = 0, owner=None) -> int | None:
        """Register a long-lived allocation; returns an opaque token (or
        ``None`` when obs is disabled — every other entry point no-ops on
        ``None``, which keeps the disabled hot path to one flag check).

        ``device=`` / ``host=`` take an array or iterable of arrays
        (``.nbytes`` summed) on top of the explicit ``*_bytes``. ``owner``
        (weakref-able) auto-releases the entry when collected — accounted
        bytes are live bytes — and makes the entry idempotent: a second
        ``account`` for the same ``(owner, component)`` replaces the first
        (re-attribution, e.g. a sealed index wrapped under a serving name).
        """
        if not metrics._enabled:
            return None
        dev_b = int(device_bytes) + _nbytes(device)
        host_b = int(host_bytes) + _nbytes(host)
        with self._lock:
            if owner is not None:
                old = self._owners.get((id(owner), component))
                if old is not None and old in self._allocs:
                    self._release_locked(self._allocs[old])
            token = self._next
            self._next += 1
            a = _Alloc(token, str(component), str(name),
                       None if shard is None else int(shard), int(epoch),
                       dev_b, host_b, self._clock())
            if owner is not None:
                # the callback releases through the ledger; a manual
                # release() beforehand just makes it a no-op
                # (an owner collected at interpreter exit, after this
                # module's globals are gone, has nothing left to release)
                a.wref = weakref.ref(owner, lambda _r, t=token:
                                     metrics is not None and self.release(t))
                a.owner_key = (id(owner), component)
                self._owners[a.owner_key] = token
            self._allocs[token] = a
            self._bump(a, dev_b, host_b)
        return token

    def reaccount(self, token: int | None, *, device=None, host=None,
                  device_bytes: int = 0, host_bytes: int = 0,
                  epoch: int | None = None) -> None:
        """Replace an entry's byte counts in place (the stream state's
        delta bucket grows and shrinks within one epoch)."""
        if token is None or not metrics._enabled:
            return
        dev_b = int(device_bytes) + _nbytes(device)
        host_b = int(host_bytes) + _nbytes(host)
        with self._lock:
            a = self._allocs.get(token)
            if a is None or a.released:
                return
            if epoch is not None:
                a.epoch = int(epoch)
            self._bump(a, dev_b - a.device_bytes, host_b - a.host_bytes)
            a.device_bytes, a.host_bytes = dev_b, host_b

    def release(self, token: int | None) -> None:
        """Drop an entry (idempotent; ``None`` no-ops)."""
        if token is None:
            return
        with self._lock:
            a = self._allocs.get(token)
            if a is not None:
                self._release_locked(a)

    def retire(self, token: int | None) -> None:
        """Mark an entry expected-to-free: its owner SHOULD become
        unreachable now (a serve version past its last lease, a pre-swap
        stream epoch). The entry stays accounted until the owner actually
        dies — a retired entry still alive is what :func:`audit` reports
        as a leak."""
        if token is None:
            return
        with self._lock:
            a = self._allocs.get(token)
            if a is None or a.released or a.retired_at is not None:
                return
            a.retired_at = self._clock()
            if metrics._enabled:
                self._set_retired_gauge_locked()

    def has_owner(self, owner, component: str | None = None) -> bool:
        """Whether ``owner`` has a live entry (under ``component``, or any)."""
        with self._lock:
            if component is not None:
                t = self._owners.get((id(owner), component))
                return t is not None and t in self._allocs
            return any(t in self._allocs
                       for (oid, _c), t in self._owners.items()
                       if oid == id(owner))

    # -- read side -----------------------------------------------------------
    def totals(self) -> dict:
        with self._lock:
            return {"device_bytes": self._dev, "host_bytes": self._host,
                    "device_peak_bytes": self._dev_peak,
                    "host_peak_bytes": self._host_peak,
                    "allocations": len(self._allocs)}

    def reset_peak(self) -> None:
        """Re-base the peak watermarks to the current totals (the bench
        scopes each row's peak this way; rows run sequentially)."""
        with self._lock:
            self._dev_peak, self._host_peak = self._dev, self._host
            if metrics._enabled:
                _g_device_peak().set(self._dev_peak)
                _g_host_peak().set(self._host_peak)

    def breakdown(self) -> list[dict]:
        """Every live entry as a dict, largest device footprint first."""
        now = self._clock()
        with self._lock:
            # list() snapshot — see _set_retired_gauge_locked: building the
            # row dicts allocates, allocation can run gc, and a dead
            # owner's callback re-enters release() through the RLock
            rows = [{
                "component": a.component, "name": a.name, "shard": a.shard,
                "epoch": a.epoch, "device_bytes": a.device_bytes,
                "host_bytes": a.host_bytes,
                "age_s": round(now - a.created_at, 3),
                "retired": a.retired_at is not None,
            } for a in list(self._allocs.values())]
        rows.sort(key=lambda r: (-r["device_bytes"], -r["host_bytes"],
                                 r["component"], r["name"]))
        return rows

    def audit(self, collect: bool = False) -> dict:
        """Retirement-audit status: entries marked retired whose owner is
        still alive (each one a leak of the PR 9 class — something still
        pins what the free path claimed to release). ``collect=True`` runs
        ``gc.collect()`` first so reference CYCLES that are merely
        not-yet-swept don't report as leaks (the tier-1 audits use it;
        the ``/debug/mem`` endpoint defaults off — forcing gc from a
        debug scrape would be rude)."""
        if collect:
            import gc

            gc.collect()
        now = self._clock()
        with self._lock:
            pending = [{
                "component": a.component, "name": a.name, "shard": a.shard,
                "epoch": a.epoch, "device_bytes": a.device_bytes,
                "host_bytes": a.host_bytes,
                "retired_for_s": round(now - a.retired_at, 3),
            } for a in list(self._allocs.values())
                if a.retired_at is not None]
            if metrics._enabled:
                self._set_retired_gauge_locked()
        pending.sort(key=lambda r: -r["retired_for_s"])
        return {"retired_unfreed": pending, "clean": not pending,
                "live_allocations": self.totals()["allocations"]}


_ledger = MemLedger()


def ledger() -> MemLedger:
    """The process-global ledger behind the module-level veneer."""
    return _ledger


def account(component, **kw):
    return _ledger.account(component, **kw)


def reaccount(token, **kw):
    return _ledger.reaccount(token, **kw)


def release(token):
    return _ledger.release(token)


def retire(token):
    return _ledger.retire(token)


def totals() -> dict:
    return _ledger.totals()


def reset_peak() -> None:
    return _ledger.reset_peak()


def breakdown() -> list[dict]:
    return _ledger.breakdown()


def audit(collect: bool = False) -> dict:
    return _ledger.audit(collect=collect)


# -- index accounting --------------------------------------------------------

def _index_kind_and_leaves(index):
    """(kind, device leaves) of a sealed index, or (None, ()) for unknown
    types (accounting must never be the thing that breaks a build)."""
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq

    if isinstance(index, brute_force.BruteForce):
        return "brute_force", ([] if index.dataset is None
                               else [index.dataset])
    for kind, cls in (("ivf_flat", ivf_flat.IvfFlatIndex),
                      ("ivf_pq", ivf_pq.IvfPqIndex),
                      ("cagra", cagra.CagraIndex)):
        if isinstance(index, cls):
            leaves = [getattr(index, f.name) for f in dataclasses.fields(index)]
            return kind, [x for x in leaves if isinstance(x, torch.Tensor)]
    return None, ()


def unaccounted_index_bytes(index) -> int:
    """Device bytes of ``index`` NOT already in the ledger — what a publish
    of it would newly pin. 0 for already-accounted indexes (their bytes are
    in the totals the gate compares) and for non-index serving hooks
    (closure-held arrays are not enumerable; a ``stream`` hook's bytes ride
    the mutable's own entries)."""
    kind, leaves = _index_kind_and_leaves(index)
    if kind is None or _ledger.has_owner(index, f"index/{kind}"):
        return 0
    return _nbytes(leaves)


def account_index(index, *, name: str = "default", shard: int | None = None,
                  epoch: int = 0):
    """Account a sealed index's device arrays under ``index/<kind>``
    (idempotent per index object — wrapping re-attributes the same entry
    under the serving name). The entry auto-releases when the index is
    collected. Returns the token (``None`` when disabled/unknown)."""
    if not metrics._enabled:
        return None
    kind, leaves = _index_kind_and_leaves(index)
    if kind is None:
        return None
    return _ledger.account(f"index/{kind}", name=name, shard=shard,
                           epoch=epoch, device=leaves, owner=index)


# -- per-device allocator stats ---------------------------------------------

def hbm_stats(update_gauges: bool = True) -> dict:
    """Per-device occupancy of every CUDA device: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (the caching allocator's allocated bytes,
    ``torch.cuda.memory_stats``), ``bytes_reserved`` (what it holds from
    the driver) and ``bytes_limit`` (the card's memory,
    ``torch.cuda.mem_get_info``). Empty without a CUDA device — callers
    fall back to the ledger gauges. Publishes
    ``raft_tpu_mem_hbm_bytes{device,stat}`` unless told not to."""
    out: dict = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats = {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                 "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
                 "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
                 "bytes_limit": int(total)}
        out[f"cuda:{i}"] = stats
        if update_gauges and metrics._enabled:
            for stat, v in stats.items():
                _g_hbm().set(v, device=f"cuda:{i}", stat=stat)
    return out


# -- workspace attribution (Resources.workspace_bytes satellite) -------------

def note_workspace(op: str, nbytes: int) -> None:
    """Record the transient workspace a memory-aware tile choice implies
    (``raft_tpu_mem_workspace_bytes{op=}``) — the observable half of the
    ``Resources.workspace_bytes`` contract: the gauge must never exceed
    the budget the tile was sized under (pinned by test)."""
    if metrics._enabled:
        _g_workspace().set(int(nbytes), op=op)


# -- footprint estimator -----------------------------------------------------

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1, "uint8": 1}


def _ivf_capacity(rows: int, n_lists: int, split_factor: float) -> int:
    """The build's list-capacity bound, ``_list_utils.list_cap_target``,
    the expression ``bound_capacity`` caps with (so a policy change moves
    the estimate too). On clustered data the cap binds, which makes it the
    estimate and not only the bound; near-uniform lists can come in below."""
    from ..neighbors._list_utils import list_cap_target

    return list_cap_target(rows, n_lists, split_factor)


def plan(kind: str, params=None, rows: int = 0, dim: int = 0, *,
         dtype: str = "float32", storage: str = "hbm", tier=None,
         streamed: bool = False, chunk_rows: int | None = None) -> dict:
    """Predict the long-lived device bytes and a coarse build peak of an
    index of ``kind`` over ``(rows, dim)`` data (raft_tpu/obs/mem.py:552,
    whose numbers it returns for the same arguments). ``params`` is the
    kind's ``IndexParams`` (``None`` for the defaults; brute force takes
    none). ``index_bytes`` is within ±20% of a build's tensor bytes at 100k
    rows: the dominant arrays are exact, the slack is IVF list padding.

    ``storage="tiered"`` adds the retained raw-row store (rows x dim x B)
    a ``MutableIndex(storage="tiered")`` keeps cold: on the host, or on the
    disk tier when ``tier`` (a ``TierPolicy``) sets ``disk_path``; the
    device figure is unchanged.

    ``streamed=True`` prices the out-of-core build (a
    :class:`~raft_tpu_torch.core.chunked.ChunkedReader`, ``chunk_rows`` a
    chunk, default ``DEFAULT_CHUNK_ROWS``): the whole-corpus float32
    working copy is replaced by two staged chunks and, for the IVF kinds,
    the label and id vectors of the chunked scatter (8 B a row).
    ``host_peak_bytes`` turns nonzero: the stager's two host buffers plus,
    for the IVF kinds, the trainset gathered off the reader, which the
    ``site="build_stream"`` gate prices against
    ``Resources.host_budget_bytes``.

    Returns ``{"kind", "rows", "dim", "index_bytes", "build_peak_bytes",
    "host_peak_bytes", "breakdown": {array: bytes}, "tiers": {"device",
    "host", "disk"}}``."""
    from ..core.errors import expects

    rows, dim = int(rows), int(dim)
    expects(rows > 0 and dim > 0, "plan() needs rows > 0 and dim > 0")
    item = _DTYPE_BYTES.get(str(dtype))
    expects(item is not None, "unknown dtype %r", dtype)
    bk: dict[str, int] = {}
    f32_copy = rows * dim * 4  # the build's working copy / ingest view
    train_rows = 0  # coarse-trainer subsample (IVF kinds; streamed host term)

    if kind == "brute_force":
        bk["dataset"] = rows * dim * item
        build_peak = bk["dataset"] + (f32_copy if item != 4 else 0)
    elif kind == "ivf_flat":
        from ..neighbors import ivf_flat

        p = params or ivf_flat.IndexParams()
        n_lists = min(int(p.n_lists), rows)
        # list_dtype "auto" stores bytes natively and float32 otherwise
        store = item if p.list_dtype == "auto" else _DTYPE_BYTES.get(p.list_dtype, 4)
        cap = _ivf_capacity(rows, n_lists, p.split_factor)
        bk["centers"] = n_lists * dim * 4
        bk["list_data"] = n_lists * cap * dim * store
        bk["list_ids"] = n_lists * cap * 4
        bk["list_norms"] = n_lists * cap * 4
        bk["list_sizes"] = n_lists * 4
        train_rows = min(max(int(rows * p.kmeans_trainset_fraction), n_lists), rows)
        build_peak = sum(bk.values()) + f32_copy
    elif kind == "ivf_pq":
        from ..distance.types import DistanceType, resolve_metric
        from ..neighbors import ivf_pq

        p = params or ivf_pq.IndexParams()
        n_lists = min(int(p.n_lists), rows)
        pq_dim = p.pq_dim or ivf_pq._default_pq_dim(dim, p.pq_bits)
        pq_len = -(-dim // pq_dim)
        d_rot = pq_dim * pq_len
        # the build's pq8_split rule: split 8-bit codebooks are two
        # 16-entry stages (32 rows), and L2 split indexes carry a per-slot
        # cross-term constant
        ip = resolve_metric(p.metric) == DistanceType.InnerProduct
        split = p.pq_bits == 8 and (p.pq8_split if p.pq8_split is not None else not ip)
        n_codes = 32 if split else 1 << p.pq_bits
        cap = _ivf_capacity(rows, n_lists, p.split_factor)
        bk["centers"] = n_lists * dim * 4
        bk["centers_rot"] = n_lists * d_rot * 4
        bk["rotation"] = d_rot * dim * 4
        if p.codebook_kind == "per_cluster":
            bk["codebooks"] = n_lists * n_codes * pq_len * 4
        else:  # per_subspace, and the "auto" default's common outcome
            bk["codebooks"] = pq_dim * n_codes * pq_len * 4
        bk["list_codes"] = n_lists * cap * pq_dim
        bk["list_ids"] = n_lists * cap * 4
        bk["list_sizes"] = n_lists * 4
        if split and not ip:
            bk["list_consts"] = n_lists * cap * 4
        if getattr(p, "residual_scale_norm", False):
            bk["list_scales"] = n_lists * 4
        # the fast-scan tier: packed signatures beside the codes plus the
        # per-list decode scales
        fast_scan = getattr(p, "fast_scan", "none")
        if fast_scan != "none":
            bk["list_sig"] = n_lists * cap * ivf_pq._sig_words(d_rot, fast_scan)
            bk["sig_scales"] = n_lists * 4
        # build peak: the float32 working copy and the rotated-residual
        # trainset dominate the transients
        train_rows = min(max(int(rows * p.kmeans_trainset_fraction), n_lists), rows)
        build_peak = sum(bk.values()) + f32_copy + train_rows * d_rot * 4
    elif kind == "cagra":
        from ..neighbors import cagra, ivf_pq

        p = params or cagra.IndexParams()
        bk["dataset"] = rows * dim * item
        bk["graph"] = rows * int(p.graph_degree) * 4
        # build peak: the knn graph's IVF-PQ index and the intermediate
        # graph (ids and distances at the refine width)
        _, gpu_top_k, n_lists, pq_bits = cagra.knn_build_plan(p, rows, dim)
        pq_plan = plan("ivf_pq", ivf_pq.IndexParams(n_lists=n_lists, pq_bits=pq_bits),
                       rows, dim)
        build_peak = (sum(bk.values()) + f32_copy + pq_plan["index_bytes"]
                      + rows * gpu_top_k * 8)
    else:
        raise RaftError(
            f"plan(): unknown index kind {kind!r} (expected brute_force, "
            "ivf_flat, ivf_pq or cagra)")
    expects(storage in ("hbm", "tiered"),
            "plan() storage must be 'hbm' or 'tiered', got %r", storage)
    host_peak = 0
    if streamed:
        from ..core.chunked import DEFAULT_CHUNK_ROWS

        cr = min(int(chunk_rows or DEFAULT_CHUNK_ROWS), rows)
        expects(cr >= 1, "plan() chunk_rows must be >= 1")
        # staged chunks land at 4 B an element at most; two are in flight
        staged_dev = 2 * cr * dim * min(item, 4)
        host_peak = 2 * cr * dim * item
        if kind in ("ivf_flat", "ivf_pq"):
            # the tiled passes remove the whole-corpus working copy; the
            # scatter keeps the label and id vectors (int32 each)
            build_peak = build_peak - f32_copy + staged_dev + rows * 8
            # the trainset gathered off the reader lands in host memory
            host_peak += train_rows * dim * item
        else:
            # brute force and CAGRA store the dataset: streaming removes
            # the host-side whole-corpus copy, not a device term
            build_peak += staged_dev
    tiers = {"device": int(sum(bk.values())), "host": 0, "disk": 0}
    if storage == "tiered":
        raw = rows * dim * item
        cold = "disk" if getattr(tier, "disk_path", None) is not None else "host"
        tiers[cold] = raw
        bk[f"tier_{cold}_rows"] = raw
    return {"kind": kind, "rows": rows, "dim": dim, "index_bytes": tiers["device"],
            "build_peak_bytes": int(build_peak), "host_peak_bytes": int(host_peak),
            "breakdown": bk, "tiers": tiers}


# -- budget gate -------------------------------------------------------------

# budget-pressure relief: callables ``fn(need_bytes) -> freed_bytes`` the gate
# consults once before it refuses a device admission (the tiered stores drop
# their device mirrors). Handlers drop only rebuildable state (caches).
_pressure_handlers: list = []

# extra debug_payload sections: key -> zero-argument payload callable (the
# tiered stores' registry contributes "tiers"); a failing one is skipped
_debug_sections: dict = {}


def register_pressure_handler(fn) -> None:
    """Register a budget-pressure relief hook (once per callable)."""
    if fn not in _pressure_handlers:
        _pressure_handlers.append(fn)


def register_debug_section(key: str, fn) -> None:
    """Register an extra :func:`debug_payload` section under ``key``."""
    _debug_sections[str(key)] = fn


def _relieve(need_bytes: int) -> None:
    for fn in list(_pressure_handlers):
        try:
            fn(int(need_bytes))
        except Exception:  # relief is best effort; the re-check decides
            pass


def gate(res, need_bytes, *, site: str, detail: str = "", host_bytes=0) -> None:
    """Admission check against ``res.memory_budget_bytes`` (device) and
    ``res.host_budget_bytes`` (host): refuse when the ledger's accounted
    bytes plus the projected growth would exceed the armed budget. Both
    budgets default ``None``, and then the gate is an attribute check.
    ``need_bytes`` / ``host_bytes`` may be callables (evaluated only when
    armed: :func:`plan` is not free). Raises
    :class:`raft_tpu_torch.serve.errors.MemoryBudgetError` BEFORE the caller
    touches any state (whole-or-nothing; the error carries ``site`` /
    ``budget_bytes`` / ``accounted_bytes`` / ``need_bytes``; a host refusal
    names ``site + "/host"``). A device overage is journalled as
    ``mem_pressure`` and consults the registered pressure handlers once (a
    tiered store's mirror is a cache: spilling it beats shedding the
    admission); only if the re-check still exceeds the budget is the
    refusal journalled as ``budget_refusal`` and raised.

    An armed budget REQUIRES observability: under ``obs.disable()`` the
    ledger stops accounting, so every gate would compare against a frozen
    (usually zero) total and cumulative enforcement would be silently void.
    That is a configuration error and fails loudly here rather than
    enforcing a budget that does not hold."""
    budget = getattr(res, "memory_budget_bytes", None)
    host_budget = getattr(res, "host_budget_bytes", None)
    if budget is None and host_budget is None:
        return
    if not metrics._enabled:
        raise RaftError(
            f"memory_budget_bytes/host_budget_bytes is set but observability is "
            f"disabled: the ledger the budget gates against does not account under "
            f"obs.disable(), so enforcement at {site!r} would be silently void — "
            "obs.enable() or unset the budget")
    from ..serve.errors import MemoryBudgetError

    if budget is not None:
        need = int(need_bytes() if callable(need_bytes) else need_bytes)
        used = _ledger.totals()["device_bytes"]
        if used + need > int(budget):
            obs_events.emit(
                "mem_pressure", subject=("mem", site, None, None),
                evidence={"site": site, "need_bytes": need, "accounted_bytes": used,
                          "budget_bytes": int(budget),
                          "overage_bytes": used + need - int(budget)})
            _relieve(used + need - int(budget))
            used = _ledger.totals()["device_bytes"]
        if used + need > int(budget):
            obs_events.emit(
                "budget_refusal", subject=("mem", site, None, None),
                evidence={"site": site, "need_bytes": need, "accounted_bytes": used,
                          "budget_bytes": int(budget)},
                counter=_c_refusals, counter_labels={"site": site})
            raise MemoryBudgetError(
                f"memory budget exceeded at {site}: accounted {used} B + "
                f"needed {need} B > budget {int(budget)} B"
                + (f" ({detail})" if detail else ""),
                site=site, budget_bytes=int(budget), accounted_bytes=used,
                need_bytes=need)
    if host_budget is not None:
        need_h = int(host_bytes() if callable(host_bytes) else host_bytes)
        used_h = _ledger.totals()["host_bytes"]
        # zero host need always admits: every device-side caller comes here
        # with host_bytes=0, and host growth the gate does not admit (delta
        # memtables, bitsets) must not turn those into refusals. The device
        # side refuses zero growth over budget; do not unify them.
        if need_h and used_h + need_h > int(host_budget):
            obs_events.emit(
                "budget_refusal", subject=("mem", f"{site}/host", None, None),
                evidence={"site": f"{site}/host", "need_bytes": need_h,
                          "accounted_bytes": used_h, "budget_bytes": int(host_budget)},
                counter=_c_refusals, counter_labels={"site": f"{site}/host"})
            raise MemoryBudgetError(
                f"host memory budget exceeded at {site}: accounted {used_h} B + "
                f"needed {need_h} B > host budget {int(host_budget)} B"
                + (f" ({detail})" if detail else ""),
                site=f"{site}/host", budget_bytes=int(host_budget),
                accounted_bytes=used_h, need_bytes=need_h)


def gate_host(res, host_bytes, *, site: str, detail: str = "") -> None:
    """The host half of :func:`gate` alone (raft_tpu/obs/mem.py:861), for
    admissions that add no device bytes. The device budget does not run
    here: it refuses any growth while the ledger sits over budget, which
    must not fail an operation that allocates no device memory."""
    budget = getattr(res, "host_budget_bytes", None)
    if budget is None:
        return
    if not metrics._enabled:
        raise RaftError(
            f"host_budget_bytes is set but observability is disabled: "
            f"enforcement at {site!r} would be silently void — "
            "obs.enable() or unset the budget")

    class _HostOnly:
        host_budget_bytes = int(budget)
        memory_budget_bytes = None

    gate(_HostOnly(), 0, site=site, detail=detail, host_bytes=host_bytes)


def headroom(res=None) -> dict | None:
    """Device-budget headroom snapshot, or ``None`` when no
    ``memory_budget_bytes`` is armed (an unarmed budget has no headroom
    to reason about). The control plane's reshard admission reads this —
    a topology doubling is a double-buffered migration, so it is refused
    unless enough of the budget is free OR reclaimable by a pressure
    spill. ``spillable_bytes``/``spillable_frac`` count the tiered
    stores' device mirrors (caches the gate's pressure handlers drop on
    demand); both are 0 when no tiered store is live. Fractions are of
    the budget, so ``headroom_frac + spillable_frac`` is the admission
    quantity — and the dict inlines as journal evidence verbatim, so a
    control decision and its admission check can never disagree."""
    if res is None:
        from ..core.resources import default_resources

        res = default_resources()
    budget = getattr(res, "memory_budget_bytes", None)
    if budget is None:
        return None
    budget = int(budget)
    used = _ledger.totals()["device_bytes"]
    spillable = 0
    try:
        from ..stream.tiered import spillable_bytes

        spillable = int(spillable_bytes())
    except Exception:  # headroom is a sensor, never the failure itself
        pass
    return {
        "budget_bytes": budget,
        "device_bytes": int(used),
        "headroom_bytes": max(0, budget - int(used)),
        "headroom_frac": (round(max(0.0, 1.0 - used / budget), 4)
                          if budget else 0.0),
        "spillable_bytes": spillable,
        "spillable_frac": (round(spillable / budget, 4) if budget else 0.0),
    }


# -- /debug/mem payload ------------------------------------------------------

def debug_payload(top: int = 20) -> dict:
    """The ``/debug/mem`` JSON: totals + peaks, per-component aggregates,
    the ``top`` largest allocations (component/name/shard/epoch), audit
    status, per-device memory stats where a CUDA device is present, and
    every registered extra section (``tiers``: per-store residency, tier
    bytes and spill / promote events, once a tiered store is live)."""
    rows = _ledger.breakdown()
    by_comp: dict[str, dict] = {}
    for r in rows:
        c = by_comp.setdefault(r["component"], {
            "device_bytes": 0, "host_bytes": 0, "allocations": 0})
        c["device_bytes"] += r["device_bytes"]
        c["host_bytes"] += r["host_bytes"]
        c["allocations"] += 1
    try:
        hbm = hbm_stats()
    except Exception:  # a debug endpoint must never take the process down
        hbm = {}
    out = {"totals": _ledger.totals(), "by_component": by_comp,
           "top": rows[:int(top)], "audit": _ledger.audit(), "hbm": hbm}
    for key, fn in list(_debug_sections.items()):
        try:
            out[key] = fn()
        except Exception:  # a debug endpoint must never take the process down
            pass
    return out
