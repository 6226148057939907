"""Applying pinned decisions: decision → SearchParams → serving hook.

Counterpart of raft_tpu/tune/apply.py, with its resolution rule, knob
table, error texts and metric names. Three application surfaces:

- :func:`tuned_search_params` maps a decision's knob dict onto the owning
  module's ``SearchParams`` (unknown knobs are an error — a decision must
  never half-apply silently).
- :func:`make_searcher` builds the full serving hook, including the exact
  ``refine`` epilogue for ``refine_ratio`` operating points.
  ``serve.publish(..., tuned=)`` routes through it, and each module's
  ``batched_searcher`` consults the index's attached decision when no
  explicit params are given, so a loaded raft_tpu/9 index serves at its
  pinned operating point with no caller code.
- :func:`apply_global` pins process-wide dispatch thresholds (the
  wide-select column cutoff in :mod:`raft_tpu_torch.matrix.select_k`) from
  a ``select_k`` decision. The port applies such a pin only when its
  evidence shows the port's ``topk`` kernel was measured
  (``kernel_measured``): a sweep whose kernel arm was ineligible, or a JAX
  log (whose arm is the TPU's Pallas selector), keeps the port's threshold.

Every application increments ``raft_tpu_tune_applied_total``. The closures
here return tensors on the index's device under any
``config.set_output_as`` setting.
"""

from __future__ import annotations

import dataclasses
import functools

from ..config import keep_tensors
from ..core.errors import expects
from ..obs import metrics
from .decisions import Decision, DecisionLog, kind_of

__all__ = ["tuned_search_params", "search_fn", "make_searcher", "attach",
           "resolve", "apply_global"]

# Knobs each kind's SearchParams accepts from a decision; refine_ratio is
# the cross-cutting epilogue knob (IVF kinds only — CAGRA already scores
# candidates exactly, brute force IS the oracle).
_PARAM_FIELDS = {
    "brute_force": frozenset(),
    "ivf_flat": frozenset({"n_probes"}),
    "ivf_pq": frozenset({"n_probes", "lut_dtype", "scan_impl", "scan_order",
                         "group_size", "select_impl", "funnel_widen"}),
    "cagra": frozenset({"itopk_size", "max_iterations", "search_width",
                        "seed_pool", "hop_impl"}),
}
_REFINE_KINDS = frozenset({"ivf_flat", "ivf_pq"})


@functools.lru_cache(maxsize=None)
def _applied_total():
    return metrics.counter(
        "raft_tpu_tune_applied_total",
        "tuned decisions applied to a searcher or dispatch threshold")


def _module_for(kind: str):
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq

    return {"brute_force": brute_force, "ivf_flat": ivf_flat,
            "ivf_pq": ivf_pq, "cagra": cagra}[kind]


def _device_of(index):
    """The device an index's tensors live on."""
    if kind_of(index) == "brute_force":
        return index.dataset.device
    return index.device


def _as_params_dict(tuned) -> dict:
    if isinstance(tuned, Decision):
        return dict(tuned.params)
    return dict(tuned)


def tuned_search_params(kind: str, params, base=None):
    """Decision knobs → ``(SearchParams, refine_ratio)`` for ``kind``.

    ``params`` is a :class:`Decision` or its knob dict; ``base`` seeds the
    fields the decision does not pin. ``refine_ratio`` (default 1) is
    returned separately — it configures the exact-refine epilogue, not the
    index search itself. Unknown knobs raise.
    """
    expects(kind in _PARAM_FIELDS, "no tuned-params mapping for kind %r",
            kind)
    knobs = _as_params_dict(params)
    refine_ratio = int(knobs.pop("refine_ratio", 1))
    expects(refine_ratio >= 1, "refine_ratio must be >= 1, got %d",
            refine_ratio)
    expects(refine_ratio == 1 or kind in _REFINE_KINDS,
            "refine_ratio applies to IVF kinds only (got kind=%r)", kind)
    unknown = set(knobs) - set(_PARAM_FIELDS[kind])
    expects(not unknown,
            "decision knobs %s are not %s search params (accepted: %s)",
            sorted(unknown), kind, sorted(_PARAM_FIELDS[kind]) or "none")
    if kind == "brute_force":
        return None, refine_ratio
    mod = _module_for(kind)
    sp = base if base is not None else mod.SearchParams()
    if knobs:
        sp = dataclasses.replace(sp, **knobs)
    return sp, refine_ratio


def search_fn(index, params, *, dataset=None, base_params=None):
    """``(queries, k) -> (distances, ids)`` closure applying a decision's
    knobs to ``index`` — the shared core of the sweep engine's trial arms
    and :func:`make_searcher`. ``refine_ratio > 1`` widens the index search
    to ``k * refine_ratio`` candidates and re-ranks them exactly against
    ``dataset`` (required then; CAGRA supplies its own stored rows) in the
    index's metric, on the index's device."""
    kind = kind_of(index)
    sp, refine_ratio = tuned_search_params(kind, params, base=base_params)
    if kind == "brute_force":
        def bf(queries, k):
            with keep_tensors():
                return index.search(queries, int(k))

        return bf
    mod = _module_for(kind)
    if refine_ratio == 1:
        return lambda queries, k: mod.search.native(sp, index, queries, int(k))
    expects(dataset is not None,
            "a refine_ratio operating point needs the raw rows: pass "
            "dataset= (e.g. the array the index was built from)")
    from ..core.resources import Resources
    from ..neighbors.refine import refine

    metric = index.metric  # the refine re-rank must score like the index
    res = Resources(device=_device_of(index))

    def fn(queries, k):
        _, cand = mod.search.native(sp, index, queries, int(k) * refine_ratio)
        return refine(dataset, queries, cand, int(k), metric=metric, res=res)

    return fn


def resolve(index, tuned, dataset=None) -> Decision | None:
    """Normalize a ``tuned=`` argument against an index: a
    :class:`DecisionLog` resolves by the index's measured family
    (``dataset`` rows enable the scale-skew classifier for PQ indexes),
    a :class:`Decision`/dict passes through (kind-checked), ``True`` reads
    the decision attached to the index (``index.tuned``, e.g. restored by
    a raft_tpu/9 load), ``None``/no-match returns None (caller defaults).
    """
    if tuned is None:
        return None
    if tuned is True:
        tuned = getattr(index, "tuned", None)
        if tuned is None:
            return None
    if isinstance(tuned, DecisionLog):
        return tuned.resolve(index, dataset)
    if isinstance(tuned, dict):
        tuned = Decision.from_dict(tuned)
    expects(isinstance(tuned, Decision),
            "tuned= must be a DecisionLog, Decision, decision dict, or "
            "True (use the index's attached decision); got %r",
            type(tuned).__name__)
    expects(tuned.kind == kind_of(index),
            "decision %r pins %s params but the index is %s",
            tuned.key, tuned.kind, kind_of(index))
    return tuned


def make_searcher(index, tuned, *, dataset=None, base_params=None,
                  degrade_without_rows: bool = False):
    """Build the serving hook for an index at a pinned operating point —
    what ``serve.publish(..., tuned=)`` warms and flips to. The hook
    carries the standard ``kind``/``dim``/``query_dtype``/``device``
    contract plus ``tuned`` (the decision key) so a publish report can say
    WHICH pin is live.

    ``degrade_without_rows=True`` is the LOADED-index contract (the
    ``batched_searcher`` auto-consult path): a ``refine_ratio`` pin whose
    raw rows are unavailable serves the refine-free remainder of the
    decision — with a WARNING, never an error, because an attached pin
    must not make a previously-working default publish crash. Explicit
    application (``tuned=`` at publish, or calling this directly) stays
    strict: pass ``dataset=`` or get a clear error."""
    from ..neighbors._hooks import make_hook

    decision = resolve(index, tuned, dataset)
    expects(decision is not None,
            "no decision resolved for this index (empty log, or tuned=True "
            "on an index with nothing attached)")
    kind = kind_of(index)
    if dataset is None and kind == "cagra":
        dataset = index.dataset
    refine_ratio = int(decision.params.get("refine_ratio", 1))
    if refine_ratio > 1 and dataset is None and degrade_without_rows:
        from ..core.logger import logger

        logger.warning(
            "tuned decision %s pins refine_ratio=%d but no raw rows are "
            "available on this %s index; serving the refine-free remainder "
            "of the pin (pass dataset= to tune.make_searcher for the full "
            "operating point)", decision.key, refine_ratio, kind)
        trimmed = {kk: v for kk, v in decision.params.items()
                   if kk != "refine_ratio"}
        decision = Decision(kind=decision.kind, dtype=decision.dtype,
                            family=decision.family, params=trimmed,
                            evidence=decision.evidence)
        refine_ratio = 1
    fn = search_fn(index, decision, dataset=dataset,
                   base_params=base_params)
    hook_kind = kind + ("+refine" if refine_ratio > 1 else "")
    if kind == "brute_force":
        from ..neighbors.brute_force import _dtype_name

        dim, data_kind = index.dataset.shape[1], _dtype_name(index.dataset)
    else:
        dim, data_kind = index.dim, getattr(index, "data_kind", "float32")
    hook = make_hook(fn, hook_kind, dim, data_kind, _device_of(index))
    hook.tuned = decision.key
    if metrics.enabled():
        _applied_total().inc(1, kind=kind)
    return hook


def attach(index, decision) -> None:
    """Pin a decision onto the index object (``index.tuned``, a plain
    JSON-able dict). Persisted by the module ``save``/``write_index``
    (raft_tpu/9) and consulted by ``batched_searcher`` when no explicit
    params are passed."""
    if isinstance(decision, dict):
        decision = Decision.from_dict(decision)
    expects(isinstance(decision, Decision),
            "attach() takes a Decision or its dict, got %r",
            type(decision).__name__)
    expects(decision.kind == kind_of(index),
            "decision %r pins %s params but the index is %s",
            decision.key, decision.kind, kind_of(index))
    # validate now: a bad knob must fail at pin time, not first search
    tuned_search_params(decision.kind, decision)
    index.tuned = decision.to_dict()


def _kernel_measured(decision: Decision) -> bool:
    """Whether a ``select_k`` decision may move the port's threshold: True
    when its evidence shows the port's ``topk`` kernel measured
    (``kernel_measured``), or when it carries no sweep evidence at all (a
    hand-written pin); False for a sweep whose kernel arm was ineligible
    and for a JAX sweep (``pallas_measured``: the TPU's selector, not the
    port's kernel)."""
    ev = decision.evidence or {}
    if "kernel_measured" in ev:
        return bool(ev["kernel_measured"])
    return "pallas_measured" not in ev and "trials" not in ev


def apply_global(log: DecisionLog) -> dict:
    """Apply the process-wide dispatch decisions a log carries (the
    ``select_k`` wide-column threshold). Returns ``{what: value}`` for
    each pin applied; empty dict when the log has none, or when its
    ``select_k`` pin was not measured on the port's kernel (see
    :func:`_kernel_measured`). Read at dispatch time: apply before the
    searches it should steer."""
    from ..matrix.select_k import set_wide_cols_threshold

    applied = {}
    dec = log.get("select_k", "float32", "wide")
    if dec is not None:
        if not _kernel_measured(dec):
            from ..core.logger import logger

            logger.info("tune.apply_global: the select_k pin %s was not measured "
                        "on the port's topk kernel; keeping the threshold", dec.key)
            return applied
        cols = int(dec.params["wide_cols_min"])
        set_wide_cols_threshold(cols)
        applied["select_k.wide_cols_min"] = cols
        if metrics.enabled():
            _applied_total().inc(1, kind="select_k")
    return applied
