"""Batched top-k selection with index payloads.

Counterpart of raft_tpu/matrix/select_k.py (reference:
cpp/include/raft/matrix/select_k.cuh, two algorithms picked by a
heuristic). Two routes, split by one rule, :func:`wide_dispatch_ok`: rows of
:data:`WIDE_SELECT_COLS_DEFAULT` columns or more of a float type on a CUDA
device go to the ``topk`` kernel (ops/topk.py, k <= 256, one launch for
values and payload ids); everything else goes to :func:`_select_k`, a plain
PyTorch top-k that ranks as ``lax.top_k`` does: the total order of the
values (-0 below +0, NaN by its bits), ties to the lowest column. The
threshold was measured on the card (``chip_smoke.py``'s sweep);
:func:`set_wide_cols_threshold` pins another.

Integer values always take the plain route, which ranks them exactly (the
kernel ranks after a float32 cast).
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..ops.topk import (float_order_key, gather_exact, lowest_index_positions,
                        top_k_lowest_index)
from ..obs.instrument import instrument, nrows

__all__ = ["select_k", "select_k_impl", "wide_dispatch_ok",
           "set_wide_cols_threshold", "wide_cols_threshold"]

# widest k the kernel is dispatched for; equals ops.topk.TOPK_MAX_K
SELECT_K_DISPATCH_MAX_K = 256
# The smallest width of chip_smoke.py's sweep (1,024 to 100,003 columns;
# 10,000 and 128 rows; k of 10, 32, 40 and 193) at and above which the
# topk kernel beat the plain route at every k and row count, on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit (at 1,024 columns 0.0097-0.31 ms
# against 0.060-1.75 ms; PERF.md has the sweep).
WIDE_SELECT_COLS_DEFAULT = 1024
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_KEY_MAX = (1 << 32) - 1      # float_order_key's largest key

_wide_cols_override: int | None = None


def set_wide_cols_threshold(n: int | None) -> None:
    """Pin (or with None, reset) the wide-select column threshold."""
    global _wide_cols_override
    expects(n is None or int(n) >= 1,
            "wide-select threshold must be >= 1 columns, got %r", n)
    _wide_cols_override = None if n is None else int(n)


def wide_cols_threshold() -> int:
    """The live threshold: a :func:`set_wide_cols_threshold` pin, else
    :data:`WIDE_SELECT_COLS_DEFAULT` columns."""
    if _wide_cols_override is not None:
        return _wide_cols_override
    return WIDE_SELECT_COLS_DEFAULT


def wide_dispatch_ok(n: int, k: int, dtype, device=None) -> bool:
    """True when (n, k, dtype) on ``device`` goes to the ``topk`` kernel:
    a CUDA device, n at or above :func:`wide_cols_threshold`, 0 < k <= 256
    and a float type of at most 32 bits. ``device`` defaults to the default
    handle's device."""
    if device is None:
        device = default_resources().device
    return (torch.device(device).type == "cuda" and n >= wide_cols_threshold()
            and 0 < k <= SELECT_K_DISPATCH_MAX_K and dtype in _FLOATS)


def _is_integer(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def _select_k(values, in_idx, k: int, select_min: bool):
    """Plain top-k, ties to the lowest column. Values are gathered from the
    input, so they stay exact."""
    if _is_integer(values.dtype):
        # ~v flips the order without wrapping (signed: -v - 1, unsigned:
        # max - v)
        key = ~values if select_min else values
        _, top_i = top_k_lowest_index(key, k)
    elif values.dtype in _FLOATS:
        # lax.top_k's total order, from the float32 bits (no float
        # arithmetic, so NaN ranks alike on every device)
        key = float_order_key(values.to(torch.float32).view(torch.int32))
        top_i = lowest_index_positions(_KEY_MAX - key if select_min else key, k)
    else:
        _, top_i = top_k_lowest_index(-values if select_min else values, k)
    top_v = gather_exact(values, top_i)
    if in_idx is not None:
        top_i = torch.gather(in_idx, 1, top_i)
    return top_v, top_i.to(torch.int32)


def select_k_impl(values, in_idx, k: int, select_min: bool,
                  impl: str = "auto"):
    """Routed top-k for callers inside a pipeline. ``impl``: "auto" applies
    :func:`wide_dispatch_ok`; "torch" forces the plain route (the JAX
    package's "xla"); "kernel" forces ops.topk (its "pallas"; float values
    only, and on a CPU tensor ops.topk runs its plain version)."""
    expects(impl in ("auto", "torch", "kernel"),
            "select impl must be 'auto', 'torch' or 'kernel', got %r", impl)
    n = values.shape[1]
    use_kernel = (impl == "kernel" or
                  (impl == "auto"
                   and wide_dispatch_ok(n, k, values.dtype, values.device)))
    if use_kernel:
        expects(values.dtype in _FLOATS,
                "the topk kernel ranks after a float32 cast; integer or "
                "float64 values (%s) need the plain route", values.dtype)
        from ..ops.topk import topk

        return topk(values, int(k), select_min=bool(select_min), in_idx=in_idx)
    return _select_k(values, in_idx, int(k), bool(select_min))


@instrument("matrix.select_k",
            items=lambda a, kw: nrows(a[0] if a else kw["values"]),
            labels=lambda a, kw: {"k": a[1] if len(a) > 1 else kw["k"]})
def select_k(values, k: int, select_min: bool = True, indices=None,
             res: Resources | None = None):
    """Select the k smallest (or largest) entries per row, with their
    indices (reference: raft::matrix::select_k). ``indices`` optionally
    gives the payload id of each column (same shape as ``values``); by
    default the column offsets are returned.

    Runs on the handle's device. Returns (values (m, k), indices (m, k)
    int32), best first, ties to the lowest column.
    """
    res = res or default_resources()
    values = res.put(values)
    expects(values.ndim == 2, "select_k expects a 2-D (batch, n) matrix")
    n = values.shape[1]
    expects(0 < k <= n, "k=%d must be in (0, n=%d]", k, n)
    if indices is not None:
        indices = res.put(indices).to(torch.int64)
        expects(indices.shape == values.shape,
                "indices payload must match values shape")
    return select_k_impl(values, indices, int(k), bool(select_min))
