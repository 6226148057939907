"""Row-wise top-k with column payloads: the ``topk`` kernel and its plain
version.

Counterpart of raft_tpu/ops/topk.py (``topk_pallas``, the streaming Pallas
selector behind ``select_k``). The CUDA kernel (``csrc/topk.cu``) reads each
row once, keeps only the entries that beat the row's running k-th best and
radix-selects them in shared memory; see its header for the design and its
bound. :func:`topk_plain` is the same function in PyTorch.

Contract, as ``topk_pallas``'s: entries are ranked after a cast to float32,
negation for ``select_min`` and a clamp to ±2.9e38, so ±inf inputs still
rank (and tie with the clamped extremes); -0 ties with +0; equal entries go
to the lowest column. NaN, which the Pallas kernel leaves undefined, ranks by
its bits as in ``lax.top_k``: +NaN above +inf, -NaN below -inf. The ranking
is computed on the float32 bits alone (no float arithmetic touches a NaN),
so it is the same on every device. Values are read from ``x`` at the chosen
columns, so they are exact, infinities and NaN bits included.

:func:`topk` runs the kernel on a CUDA tensor and the plain version on a CPU
tensor, and nothing else: there is no fallback from one to the other. One
launch writes values, columns and, given ``in_idx``, payload ids.
``topk.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.errors import expects

__all__ = ["topk", "topk_plain", "top_k_lowest_index", "lowest_index_positions",
           "float_order_key", "gather_exact", "TOPK_MAX_K"]

TOPK_MAX_K = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PAYLOAD_CODE = {torch.int32: 1, torch.int64: 2}

_SHIFT = 1 << 31
_SIGN = -(1 << 31)            # the float32 sign bit, as an int32
_CLAMP_BITS = 0x7F5A2BF8      # float32(2.9e38)
_INF_BITS = 0x7F800000


def float_order_key(bits: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) in the total order of float32 bit patterns
    ``bits`` (int32): -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN."""
    b = bits.to(torch.int64)
    return torch.where(b >= 0, b + _SHIFT, _SHIFT - 1 - (b & (_SHIFT - 1)))


def _ordered_key(v: torch.Tensor) -> torch.Tensor | None:
    """int64 keys in [0, 2^32) in the order of ``v``'s values (-0 equal to
    +0), or None for types that do not fit (int64, float64)."""
    if v.dtype in (torch.float32, torch.bfloat16, torch.float16):
        b = v.to(torch.float32).view(torch.int32)
        return float_order_key(torch.where(b == _SIGN, 0, b))
    if v.dtype in (torch.int8, torch.int16, torch.int32):
        return v.to(torch.int64) + _SHIFT
    if v.dtype in (torch.uint8, torch.bool):
        return v.to(torch.int64)
    return None


_SAME_SIZE_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                  torch.float16: torch.int16, torch.float64: torch.int64}


def gather_exact(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, 1, pos)`` that keeps every bit of a float value:
    floats are gathered as integers of their size (the CPU's bfloat16 gather
    does not keep the bits of a negative NaN)."""
    pos = pos.to(torch.int64)
    as_int = _SAME_SIZE_INT.get(x.dtype)
    if as_int is None:
        return torch.gather(x, 1, pos)
    return torch.gather(x.view(as_int), 1, pos).view(x.dtype)


def lowest_index_positions(key: torch.Tensor, k: int) -> torch.Tensor:
    """Columns (int64) of the k largest int64 keys in [0, 2^32) of each row,
    best first, equal keys by lowest column. Works through row chunks of
    ~2^27 entries to bound its int64 temporaries."""
    rows = max(1, (1 << 27) // max(1, key.shape[1]))
    if key.shape[0] > rows:
        return torch.cat([lowest_index_positions(key[i:i + rows], k)
                          for i in range(0, key.shape[0], rows)])
    cols = torch.arange(key.shape[1], device=key.device, dtype=torch.int64)
    composite = key * _SHIFT + (_SHIFT - 1 - cols)   # unique per row
    return torch.topk(composite, k, dim=1).indices


def top_k_lowest_index(v: torch.Tensor, k: int):
    """The k largest entries of each row of ``v`` and their columns, sorted
    best first, equal entries by lowest column: ``lax.top_k``'s contract,
    which ``torch.topk`` does not promise for ties (-0 ranks with +0).
    Returns (values, int64 columns)."""
    key = _ordered_key(v)
    if key is None:
        vals, idx = torch.sort(v, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    pos = lowest_index_positions(key, k)
    return gather_exact(v, pos), pos


def _rank_keys(x: torch.Tensor, select_min: bool) -> torch.Tensor:
    """The kernel's rank of every entry as an int64 key, from the float32
    bits: negated by a sign flip, clamped unless NaN, -0 folded into +0."""
    b = x.to(torch.float32).view(torch.int32)
    if select_min:
        b = b ^ _SIGN
    mag = b & 0x7FFFFFFF
    b = torch.where((mag > _CLAMP_BITS) & (mag <= _INF_BITS), (b & _SIGN) | _CLAMP_BITS, b)
    return float_order_key(torch.where(b == _SIGN, 0, b))


def _check(x, k, in_idx=None):
    expects(x.ndim == 2, "topk expects a 2-D (m, n) matrix")
    expects(x.dtype in _DTYPE_CODE,
            "topk ranks float32/bfloat16/float16 values, got %s", x.dtype)
    n = x.shape[1]
    expects(0 < k <= min(TOPK_MAX_K, n),
            "k=%d must be in (0, min(%d, n=%d)]", k, TOPK_MAX_K, n)
    if in_idx is not None:
        expects(in_idx.shape == x.shape and in_idx.dtype in _PAYLOAD_CODE
                and in_idx.device == x.device,
                "in_idx must be int32/int64 of x's shape on x's device, got %s %s on %s",
                tuple(in_idx.shape), in_idx.dtype, in_idx.device)


def topk_plain(x: torch.Tensor, k: int, select_min: bool = True):
    """Plain PyTorch version of the ``topk`` kernel. Returns (values (m, k)
    in x's dtype, columns (m, k) int32), best first."""
    _check(x, k)
    pos = lowest_index_positions(_rank_keys(x, select_min), k)
    return gather_exact(x, pos), pos.to(torch.int32)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("topk").topk_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x: torch.Tensor, k: int, select_min: bool, in_idx):
    fn = _kernel()
    m, n = x.shape
    out_v = torch.empty((m, k), dtype=x.dtype, device=x.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), m, n, k, int(select_min),
                 None if in_idx is None else in_idx.data_ptr(),
                 0 if in_idx is None else _PAYLOAD_CODE[in_idx.dtype],
                 out_v.data_ptr(), out_i.data_ptr(), stream)
    topk.launches += 1
    expects(err == 0, "topk kernel launch failed: cudaError %d", err)
    return out_v, out_i


def topk(x: torch.Tensor, k: int, select_min: bool = True, in_idx=None):
    """Top-k of each row of ``x`` (2-D, float32/bfloat16/float16), k <= 256.

    Returns (values (m, k) in x's dtype, ids (m, k) int32), best first: the
    columns, or with ``in_idx`` (int32/int64, x's shape) its ids at those
    columns. A CUDA tensor runs the ``topk`` kernel (one launch); a CPU
    tensor runs :func:`topk_plain`.
    """
    _check(x, k, in_idx)
    if x.device.type == "cpu":
        v, pos = topk_plain(x, k, select_min)
        if in_idx is not None:
            pos = torch.gather(in_idx, 1, pos.to(torch.int64)).to(torch.int32)
        return v, pos
    expects(x.device.type == "cuda", "topk runs on cuda or cpu tensors, got %s",
            x.device)
    expects(x.shape[0] > 0, "topk needs at least one row")
    return _launch(x.contiguous(), int(k), bool(select_min),
                   None if in_idx is None else in_idx.contiguous())


topk.launches = 0
