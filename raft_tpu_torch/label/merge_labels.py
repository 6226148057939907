"""Merge two labellings according to a core-point mask.

Counterpart of raft_tpu/label/merge_labels.py (reference:
label/merge_labels.cuh, detail/merge_labels.cuh:85-108). Labels take values
1..N and ``max_label`` marks an unlabelled point; wherever ``mask`` holds,
the point's two labels become equivalent, each equivalence class is
relabelled to its smallest member, and the result is the smaller of the two
relabelled inputs.

The JAX module's rounds, in the same order: scatter-mins over a map R of
N slots (``scatter_reduce_("amin")`` into N + 1 slots, the last one
dropped, for JAX's ``.at[].min(mode="drop")``), then a pointer jump
``R = R[R]``. Its ``lax.while_loop`` becomes a host loop that reads the
round's change flag once a round, so the result equals JAX's exactly.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources

__all__ = ["merge_labels"]


def _scatter_min(r, idx, vals):
    n = r.shape[0]
    buf = torch.cat([r, r.new_full((1,), n)])
    return buf.scatter_reduce_(0, idx, vals, "amin", include_self=True)[:n]


def _merge(labels_a, labels_b, mask, max_label: int):
    """(merged labels, rounds)."""
    n = labels_a.shape[0]
    dev = labels_a.device
    labelled = mask & (labels_a != max_label) & (labels_b != max_label)
    # 0-based label ids; unlabelled points scatter to the dropped slot n
    la = torch.where(labelled, labels_a.to(torch.int64) - 1, n)
    lb = torch.where(labelled, labels_b.to(torch.int64) - 1, n)
    la_c, lb_c = la.clamp_max(n - 1), lb.clamp_max(n - 1)
    r = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = 0
    changed = True
    while changed:
        ra, rb = r[la_c], r[lb_c]
        rmin = torch.where(labelled, r[torch.minimum(ra, rb)], n)
        r = _scatter_min(r, la, rmin)
        r = _scatter_min(r, lb, rmin)
        # pointer jumping: R only decreases, so R[R] is still a valid lower
        # bound of each class
        r = r[r]
        rounds += 1
        changed = bool((labelled & (ra != rb)).any())

    def relabel(lx):
        unl = lx == max_label
        l0 = torch.where(unl, 0, lx.to(torch.int64) - 1)
        return torch.where(unl, lx, (r[l0] + 1).to(lx.dtype))

    return torch.minimum(relabel(labels_a), relabel(labels_b)), rounds


def merge_labels(labels_a, labels_b, mask, max_label=None, res: Resources | None = None):
    """Merge labellings A and B (reference: label/merge_labels.cuh:57).

    Returns the merged labels (the reference updates ``labels_a`` in
    place). ``max_label`` defaults to the type's maximum, the reference's
    MAX_LABEL sentinel for unlabelled points.
    """
    res = res or default_resources()
    labels_a, labels_b = res.put(labels_a), res.put(labels_b)
    mask = res.put(mask, torch.bool)
    expects(labels_a.shape == labels_b.shape == mask.shape, "shape mismatch")
    if max_label is None:
        max_label = torch.iinfo(labels_a.dtype).max
    return _merge(labels_a, labels_b.to(labels_a.dtype), mask, int(max_label))[0]
