"""The sweep engine: drive the search pipeline over a knob grid, measure
recall-vs-QPS, choose, and record why.

Counterpart of raft_tpu/tune/sweep.py, with its grids, choice rule,
evidence keys and ``raft_tpu_tune_*`` metrics. One :func:`sweep` call is
one decision: it runs every grid point through the real search path (the
entry points the serving tier dispatches), measures recall against exact
ground truth (the port's ``knn`` in the index's metric) and best-of-N
wall-clock QPS, and returns a :class:`~.decisions.Decision` whose evidence
holds the full trial table and the measured frontier.

The choice rule is the ANN-Benchmarks frontier read: among trials meeting
the recall target, take the QPS argmax; if none meet it, take the recall
argmax (and say so in the evidence). ``recall_target="default"`` anchors
the target to the FIRST grid point's measured recall — the grid's head is
by convention the incumbent hand-picked operating point, so the chosen
point matches or beats it on both axes by construction.

Each timed wall ends with a host copy of the first output (``.cpu()``),
which waits for the card; queries are placed on the index's device once,
before the trials, so the walls time the search, not the upload.

:func:`sweep_select_k` is the primitive-level twin for the wide-select
column threshold: it measures the port's plain route
(``select_k_impl(impl="torch")``) against the ``topk`` kernel
(``impl="kernel"``) at explicit (rows, cols, k) shapes. Where the kernel
is ineligible (CPU tensors, k over ``SELECT_K_DISPATCH_MAX_K``) the trial
records why and the decision keeps the port's current threshold.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.errors import expects
from ..obs import metrics
from .decisions import Decision, DecisionLog, _host, family_of, kind_of

__all__ = ["Trial", "sweep", "sweep_select_k", "default_grid", "smoke_grid",
           "funnel_grid"]


@functools.lru_cache(maxsize=None)
def _trials_total():
    return metrics.counter(
        "raft_tpu_tune_trials_total",
        "autotune sweep trials measured, by index kind and shape family")


@functools.lru_cache(maxsize=None)
def _trial_seconds():
    return metrics.histogram(
        "raft_tpu_tune_trial_seconds",
        "wall seconds per sweep trial (warm + timed repeats)",
        unit="seconds")


@functools.lru_cache(maxsize=None)
def _frontier_points():
    return metrics.gauge(
        "raft_tpu_tune_frontier_points",
        "points on the measured recall-vs-QPS frontier of the last sweep")


@functools.lru_cache(maxsize=None)
def _chosen_over_default():
    return metrics.gauge(
        "raft_tpu_tune_chosen_qps_over_default",
        "chosen operating point's QPS over the grid-head (default) point's")


class Trial(dict):
    """One measured grid point: ``{"params", "recall", "qps", "wall_s"}``
    (+ ``"error"`` for arms that could not run, e.g. the kernel arm on CPU
    tensors). A dict subclass so evidence serializes as plain JSON."""

    @property
    def ok(self) -> bool:
        return "error" not in self


# Default grids: the JAX package's. The HEAD of each grid is the incumbent
# hand-picked operating point (ivf_pq pq4 + refine 4 at p8, cagra itopk=32,
# ivf_flat p8), so recall_target="default" anchors to it.
_GRIDS = {
    "ivf_flat": [{"n_probes": p} for p in (8, 4, 16, 32)],
    "ivf_pq": [
        {"n_probes": 8, "refine_ratio": 4},
        {"n_probes": 4, "refine_ratio": 4},
        {"n_probes": 16, "refine_ratio": 4},
        {"n_probes": 8, "refine_ratio": 1},
        {"n_probes": 8, "refine_ratio": 8},
        {"n_probes": 16, "refine_ratio": 8},
        {"n_probes": 32, "refine_ratio": 4},
    ],
    "cagra": [
        {"itopk_size": 32},
        {"itopk_size": 64},
        {"itopk_size": 96},
        {"itopk_size": 32, "search_width": 2},
    ],
    "brute_force": [{}],
}


def default_grid(kind: str) -> list[dict]:
    """The per-kind default sweep grid (head = the incumbent operating
    point). Callers pass their own ``grid=`` to widen it; decisions record
    whichever grid actually ran."""
    expects(kind in _GRIDS, "no default grid for kind %r (one of %s)",
            kind, ", ".join(sorted(_GRIDS)))
    return [dict(g) for g in _GRIDS[kind]]


def smoke_grid(kind: str) -> list[dict]:
    """A 3-point budget grid (head kept) for smokes: proves the
    measure → choose → record loop without the full grid's wall clock."""
    return default_grid(kind)[:3]


def funnel_grid(widths=(4, 8, 16), refine_ratios=(1, 4)) -> list[dict]:
    """The quantization-funnel sweep grid for an IVF-PQ index built with a
    ``fast_scan`` tier: ``funnel_widen`` (binary tier → PQ rerank pool, per
    probed chunk) and ``refine_ratio`` (PQ → exact refine pool). HEAD is the
    classic scan (``funnel_widen=1``), so ``recall_target="default"``
    anchors the funnel's recall to the classic operating point."""
    grid = [{"n_probes": 8, "funnel_widen": 1, "refine_ratio": 4}]
    for rr in refine_ratios:
        for w in widths:
            grid.append({"n_probes": 8, "funnel_widen": int(w),
                         "refine_ratio": int(rr)})
    return grid


def _ground_truth(dataset, queries, k: int, metric="sqeuclidean", res=None):
    """Exact ids (rows, k) as a host array, through the port's ``knn`` on
    ``res``'s device (default: the default handle's)."""
    from ..neighbors.brute_force import knn

    _, ids = knn.native(dataset, queries, k, metric=metric, res=res)
    return _host(ids)


def _recall(ids, gt) -> float:
    ids, gt = _host(ids), _host(gt)
    kk = gt.shape[1]
    return float(np.mean([len(set(ids[r, :kk].tolist())
                              & set(gt[r].tolist())) / kk
                          for r in range(gt.shape[0])]))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    return next(o for o in out if isinstance(o, torch.Tensor))


def _measure(fn, queries, repeats: int):
    """Warm once, then best-of-``repeats`` wall time, each wall ending in a
    host copy of the first output (the bench protocol: an asynchronous
    launch would report fantasy QPS)."""
    out = fn(queries)
    _first_tensor(out).cpu()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = fn(queries)
        _first_tensor(out).cpu()
        best = min(best, time.perf_counter() - t0)
    return float(queries.shape[0]) / best, out


def _frontier(trials: list[Trial]) -> list[int]:
    """Indices of the non-dominated (recall, qps) points, by descending
    QPS — the measured operating frontier the evidence records."""
    ok = [(i, t) for i, t in enumerate(trials) if t.ok]
    ok.sort(key=lambda it: (-it[1]["qps"], -it[1]["recall"]))
    out, best_recall = [], -1.0
    for i, t in ok:
        if t["recall"] > best_recall:
            out.append(i)
            best_recall = t["recall"]
    return sorted(out)


def sweep(index, queries, *, k: int = 10, dataset=None, gt=None,
          recall_target="default", grid: list[dict] | None = None,
          base_params=None, repeats: int = 3, log: DecisionLog | None = None,
          attach: bool = False) -> Decision:
    """Measure a knob grid on one built index and pin the winner.

    ``dataset`` supplies the exact-ground-truth rows and the refine pool
    for ``refine_ratio`` trials (CAGRA indexes fall back to their own
    stored dataset); pass precomputed ``gt`` (rows, k) ids to skip the
    brute-force pass. ``recall_target`` is a float, or ``"default"`` to
    anchor at the grid head's measured recall (see module doc).
    ``base_params`` seeds the non-swept SearchParams fields. ``log`` adds
    the decision to a :class:`DecisionLog`; ``attach=True`` also pins it
    onto the index (``index.tuned``, persisted by ``save``). Everything
    runs on the index's device.
    """
    from ..core.resources import Resources
    from .apply import _device_of
    from .apply import attach as _attach
    from .apply import search_fn as _search_fn

    kind = kind_of(index)
    dtype = getattr(index, "data_kind", "float32")
    dtype = dtype if dtype in ("int8", "uint8") else "float32"
    res = Resources(device=_device_of(index))
    queries = res.put(queries)
    expects(queries.ndim == 2, "queries must be (rows, d)")
    if dataset is None and kind == "cagra":
        dataset = index.dataset
    # keyed AFTER dataset resolution: the scale-skew classifier (the
    # heavytail discriminator) needs raw rows for PQ indexes
    family = family_of(index, dataset)
    if gt is None:
        expects(dataset is not None,
                "sweep needs exact ground truth: pass dataset= (the indexed "
                "rows) or precomputed gt= (rows, k) ids")
        # ground truth in the INDEX's metric — recall against L2 neighbors
        # would silently mis-score an inner-product sweep
        gt = _ground_truth(dataset, queries, k,
                           metric=getattr(index, "metric", "sqeuclidean"), res=res)
    gt = _host(gt)
    expects(gt.shape[0] == queries.shape[0],
            "gt rows (%d) must match queries rows (%d)", gt.shape[0],
            queries.shape[0])
    grid = [dict(g) for g in (grid if grid is not None else
                              default_grid(kind))]
    expects(len(grid) >= 1, "sweep grid is empty")

    trials: list[Trial] = []
    for params in grid:
        t0 = time.perf_counter()
        try:
            fn = _search_fn(index, params, dataset=dataset,
                            base_params=base_params)
            qps, out = _measure(lambda q: fn(q, k), queries, repeats)
            rec = _recall(out[1], gt)
            trials.append(Trial(params=dict(params), recall=round(rec, 4),
                                qps=round(qps, 1),
                                wall_s=round(time.perf_counter() - t0, 3)))
        except Exception as e:
            # an arm that cannot run on this device/shape is evidence,
            # not a failure: the decision records WHY it was not chosen
            trials.append(Trial(params=dict(params),
                                error=f"{type(e).__name__}: {str(e)[:160]}",
                                wall_s=round(time.perf_counter() - t0, 3)))
        if metrics.enabled():
            _trials_total().inc(1, kind=kind, family=family)
            _trial_seconds().observe(trials[-1]["wall_s"], kind=kind)

    ok = [t for t in trials if t.ok]
    expects(bool(ok), "every sweep trial failed; first error: %s",
            trials[0].get("error"))
    default_trial = trials[0] if trials[0].ok else ok[0]
    if recall_target == "default":
        target = default_trial["recall"]
    else:
        target = float(recall_target)
    feasible = [t for t in ok if t["recall"] >= target]
    met = bool(feasible)
    chosen = (max(feasible, key=lambda t: t["qps"]) if met
              else max(ok, key=lambda t: t["recall"]))
    frontier = _frontier(trials)
    ratio = (chosen["qps"] / default_trial["qps"]
             if default_trial["qps"] else 0.0)
    if metrics.enabled():
        _frontier_points().set(len(frontier), kind=kind, family=family)
        _chosen_over_default().set(round(ratio, 3), kind=kind, family=family)

    decision = Decision(
        kind=kind, dtype=dtype, family=family, params=dict(chosen["params"]),
        evidence={
            "recall_target": round(target, 4), "target_met": met,
            "k": int(k), "n": int(getattr(index, "size", 0) or 0),
            "dim": int(getattr(index, "dim", queries.shape[1])),
            "queries": int(queries.shape[0]), "repeats": int(repeats),
            "backend": res.torch_device.type,
            "trials": [dict(t) for t in trials],
            "frontier": frontier,
            "default_params": dict(default_trial["params"]),
            "default_recall": default_trial["recall"],
            "default_qps": default_trial["qps"],
            "chosen_recall": chosen["recall"], "chosen_qps": chosen["qps"],
            "chosen_qps_over_default": round(ratio, 3),
        })
    if log is not None:
        log.add(decision)
    if attach:
        _attach(index, decision)
    return decision


# -- the wide-select threshold -------------------------------------------------

def sweep_select_k(*, rows: int = 256, cols=(32768, 65536, 131072),
                   ks=(10, 128), repeats: int = 3,
                   log: DecisionLog | None = None, res=None) -> Decision:
    """Measure the plain route (``impl="torch"``) against the ``topk``
    kernel (``impl="kernel"``) over explicit (rows, cols, k) shapes, on
    ``res``'s device (default: the default handle's), and pin the
    wide-dispatch column threshold.

    The chosen ``wide_cols_min`` is the smallest measured column width at
    which the kernel won for EVERY measured k, every wider measured width
    winning too (a threshold must not regress any k it gates; a non-monotone
    win is noise). Where the kernel arm is ineligible (CPU tensors, k over
    the cap), the trial records the reason and the port's current
    threshold is kept; ``evidence["kernel_measured"]`` says which.
    """
    from ..core.resources import default_resources
    from ..matrix.select_k import (SELECT_K_DISPATCH_MAX_K, select_k_impl,
                                   wide_cols_threshold)

    res = res or default_resources()
    dev = res.torch_device
    backend = dev.type
    trials: list[Trial] = []
    win_cols: dict[int, set] = {int(kk): set() for kk in ks}
    for n in cols:
        gen = torch.Generator(device=dev).manual_seed(int(n))
        vals = torch.rand((int(rows), int(n)), generator=gen, device=dev,
                          dtype=torch.float32)
        for kk in ks:
            arm_qps = {}
            for impl in ("torch", "kernel"):
                t0 = time.perf_counter()
                params = {"impl": impl, "cols": int(n), "k": int(kk)}
                if impl == "kernel" and (backend != "cuda"
                                         or kk > SELECT_K_DISPATCH_MAX_K):
                    trials.append(Trial(
                        params=params,
                        error=f"ineligible: backend={backend}, k={kk} "
                              f"(cap {SELECT_K_DISPATCH_MAX_K})",
                        wall_s=0.0))
                    # ineligible arms still count as measured trials, as
                    # sweep() counts its failed arms: the scrape must match
                    # the evidence's trial count
                    if metrics.enabled():
                        _trials_total().inc(1, kind="select_k", family="wide")
                        _trial_seconds().observe(0.0, kind="select_k")
                    continue
                try:
                    fn = functools.partial(select_k_impl, in_idx=None, k=int(kk),
                                           select_min=True, impl=impl)
                    qps, _ = _measure(fn, vals, repeats)
                    arm_qps[impl] = qps
                    trials.append(Trial(params=params, recall=1.0, qps=round(qps, 1),
                                        wall_s=round(time.perf_counter() - t0, 3)))
                except Exception as e:
                    trials.append(Trial(params=params,
                                        error=f"{type(e).__name__}: {str(e)[:160]}",
                                        wall_s=round(time.perf_counter() - t0, 3)))
                if metrics.enabled():
                    _trials_total().inc(1, kind="select_k", family="wide")
                    _trial_seconds().observe(trials[-1]["wall_s"], kind="select_k")
            if arm_qps.get("kernel", 0.0) > arm_qps.get("torch", float("inf")):
                win_cols[int(kk)].add(int(n))
        del vals

    current = wide_cols_threshold()
    chosen = current
    measured = bool(any(t.ok and t["params"]["impl"] == "kernel"
                        for t in trials))
    if measured:
        widths = sorted(int(c) for c in cols)
        for n in widths:
            if all(all(w in win_cols[int(kk)] for w in widths if w >= n)
                   for kk in ks):
                chosen = n
                break
    decision = Decision(
        kind="select_k", dtype="float32", family="wide",
        params={"wide_cols_min": int(chosen)},
        evidence={
            "backend": backend, "rows": int(rows),
            "cols": [int(c) for c in cols], "ks": [int(kk) for kk in ks],
            "repeats": int(repeats), "kernel_measured": measured,
            "previous_threshold": int(current),
            "trials": [dict(t) for t in trials],
        })
    # no frontier/ratio gauges here: a threshold sweep has no recall-vs-QPS
    # frontier, and filler values would contradict the catalogued semantics
    if log is not None:
        log.add(decision)
    return decision
