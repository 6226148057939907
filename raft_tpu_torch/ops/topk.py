"""Row-wise top-k with column payloads: the ``topk`` kernel and its plain
version.

Counterpart of raft_tpu/ops/topk.py (``topk_pallas``, the streaming Pallas
selector behind ``select_k`` for wide rows). The CUDA kernel
(``csrc/topk.cu``) is a per-row radix select; see its header for the design
and its bound. :func:`topk_plain` is the same function in PyTorch.

Contract, as ``topk_pallas``'s: entries are ranked after a cast to float32,
negation for ``select_min`` and a clamp to ±2.9e38, so ±inf inputs still
rank (and tie with the clamped extremes); -0 ties with +0; equal entries go
to the lowest column. Values are gathered from ``x`` afterwards, so they are
exact, infinities included.

:func:`topk` runs the kernel on a CUDA tensor and the plain version on a CPU
tensor, and nothing else: there is no fallback from one to the other.
``topk.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.errors import expects

__all__ = ["topk", "topk_plain", "top_k_lowest_index", "TOPK_MAX_K"]

TOPK_MAX_K = 256
_CLAMP = 2.9e38
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_SHIFT = 1 << 31


def _ordered_key(v: torch.Tensor) -> torch.Tensor | None:
    """int64 keys in [0, 2^32) in the order of ``v``'s values (-0 equal to
    +0), or None for types that do not fit (int64, float64)."""
    if v.dtype in (torch.float32, torch.bfloat16, torch.float16):
        b = (v.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
        return torch.where(b >= 0, b + _SHIFT, _SHIFT - 1 - (b & (_SHIFT - 1)))
    if v.dtype in (torch.int8, torch.int16, torch.int32):
        return v.to(torch.int64) + _SHIFT
    if v.dtype in (torch.uint8, torch.bool):
        return v.to(torch.int64)
    return None


def top_k_lowest_index(v: torch.Tensor, k: int):
    """The k largest entries of each row of ``v`` and their columns, sorted
    best first, equal entries by lowest column: ``lax.top_k``'s contract,
    which ``torch.topk`` does not promise for ties. Returns (values, int64
    columns). Works through row chunks of ~2^27 entries to bound its int64
    temporaries."""
    rows = max(1, (1 << 27) // max(1, v.shape[1]))
    if v.shape[0] > rows:
        parts = [top_k_lowest_index(v[i:i + rows], k)
                 for i in range(0, v.shape[0], rows)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    key = _ordered_key(v)
    if key is None:
        vals, idx = torch.sort(v, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    cols = torch.arange(v.shape[1], device=v.device, dtype=torch.int64)
    composite = key * _SHIFT + (_SHIFT - 1 - cols)   # unique per row
    _, pos = torch.topk(composite, k, dim=1)
    return torch.gather(v, 1, pos), pos


def _rank_values(x: torch.Tensor, select_min: bool) -> torch.Tensor:
    s = x.to(torch.float32)
    if select_min:
        s = -s
    return torch.clamp(s, -_CLAMP, _CLAMP)


def _check(x, k):
    expects(x.ndim == 2, "topk expects a 2-D (m, n) matrix")
    expects(x.dtype in _DTYPE_CODE,
            "topk ranks float32/bfloat16/float16 values, got %s", x.dtype)
    n = x.shape[1]
    expects(0 < k <= min(TOPK_MAX_K, n),
            "k=%d must be in (0, min(%d, n=%d)]", k, TOPK_MAX_K, n)


def _finish(x, pos):
    pos = torch.clamp_max(pos, x.shape[1] - 1)     # degenerate rows only
    return torch.gather(x, 1, pos.to(torch.int64)), pos.to(torch.int32)


def topk_plain(x: torch.Tensor, k: int, select_min: bool = True):
    """Plain PyTorch version of the ``topk`` kernel. Returns (values (m, k)
    in x's dtype, columns (m, k) int32), best first."""
    _check(x, k)
    _, pos = top_k_lowest_index(_rank_values(x, select_min), k)
    return _finish(x, pos)


def _launch(x: torch.Tensor, k: int, select_min: bool) -> torch.Tensor:
    from ._build import load

    lib = load("topk")
    fn = lib.topk_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    m, n = x.shape
    out_i = torch.empty((m, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), m, n, k, int(select_min),
                 out_i.data_ptr(), stream)
    topk.launches += 1
    expects(err == 0, "topk kernel launch failed: cudaError %d", err)
    return out_i


def topk(x: torch.Tensor, k: int, select_min: bool = True):
    """Top-k of each row of ``x`` (2-D, float32/bfloat16/float16), k <= 256.

    Returns (values (m, k) in x's dtype, columns (m, k) int32), best first.
    A CUDA tensor runs the ``topk`` kernel; a CPU tensor runs
    :func:`topk_plain`.
    """
    _check(x, k)
    if x.device.type == "cpu":
        return topk_plain(x, k, select_min)
    expects(x.device.type == "cuda", "topk runs on cuda or cpu tensors, got %s",
            x.device)
    expects(x.shape[0] > 0, "topk needs at least one row")
    x = x.contiguous()
    return _finish(x, _launch(x, int(k), bool(select_min)))


topk.launches = 0
