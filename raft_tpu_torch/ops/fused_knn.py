"""Fused distance + top-k for exact brute-force kNN: the ``fused_knn``
kernel and its plain version.

Counterpart of raft_tpu/ops/fused_knn.py (``fused_knn``, the Pallas kernel
that scores never leave). The CUDA kernel (``csrc/fused_knn.cu``) returns,
per query, the k largest scores ``2·q·y − yn`` (l2) or ``q·y − yn`` (ip) and
their dataset rows, best first, starting from the sentinels (-3e38, 2^30);
equal scores go to the lowest row. See its header for the design and bound.
:func:`fused_knn_plain` computes the same function in PyTorch, query tile by
query tile.

Around the kernel this module keeps the JAX wrapper's contract: ``yn``
carries |y|² (l2), an optional ``row_bias`` and the 3e38 penalty of rows the
``keep_mask`` drops, clamped at 3e38; the epilogue turns scores into
distances (``|q|² − s`` clamped at 0, optional sqrt, or the similarity for
ip) and reports unfilled slots as -1 / ±inf. The TPU kernel's 128-lane
padding of ``d`` and its VMEM block-size loop are TPU artefacts and are not
carried over.

Modes: "f32" (float32 products, never TF32), "f32x3" (bf16 hi/lo split,
``hi·hi + hi·lo + lo·hi``), "bf16" (operands cast to bfloat16 here, float32
sums) and "s8" (int8 operands, exact int32 sums).

:func:`fused_knn` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback from one to the other.
``fused_knn.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.errors import expects
from ..distance.pairwise import full_f32
from .topk import top_k_lowest_index

__all__ = ["fused_knn", "fused_knn_plain", "shapes_eligible", "FUSED_KNN_MAX_K"]

FUSED_KNN_MAX_K = 64
_NEG = -3.0e38                # "no entry" score
_BIG = 2**30                  # "no entry" row
_MASK_PENALTY = 3.0e38        # added to yn for rows the keep-mask drops
_MODES = {"f32": 0, "f32x3": 1, "bf16": 2, "s8": 3}
_IO_TYPE = {"f32": torch.float32, "f32x3": torch.float32,
            "bf16": torch.bfloat16, "s8": torch.int8}
_NB = 128                     # the kernel's dataset tile (rows)


def shapes_eligible(n: int, d: int, k: int) -> bool:
    """The fused path's shape gate, the same as the JAX package's: k <= 64,
    n >= 4096 (below that the GEMM + top-k path is as good) and
    64 <= d <= 4096."""
    return 0 < k <= FUSED_KNN_MAX_K and n >= 4096 and 64 <= d <= 4096


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _dots(q, y, mode):
    """q @ y.T in the mode's arithmetic, float32 out."""
    if mode == "s8":
        # int8 products summed exactly (float64 holds every int32 sum here),
        # then rounded to float32 as an int32 -> float32 conversion would be
        return (q.to(torch.float64) @ y.to(torch.float64).T).to(torch.float32)
    with full_f32():
        if mode == "f32x3":
            qh, yh = _bf16_round(q), _bf16_round(y)
            ql, yl = _bf16_round(q - qh), _bf16_round(y - yh)
            return (qh @ yh.T + qh @ yl.T) + ql @ yh.T
        return q.to(torch.float32) @ y.to(torch.float32).T


def _select_plain(qs, ds, yn, k, l2, mode, tile=128):
    """Plain version of the kernel: scores, then the top-k by (score desc,
    row asc) with the (-3e38, 2^30) sentinels, query tile by query tile."""
    vals, ids = [], []
    for i in range(0, qs.shape[0], tile):
        dots = _dots(qs[i:i + tile], ds, mode)
        s = (2.0 * dots if l2 else dots) - yn[None, :]
        v, p = top_k_lowest_index(s, k)
        # the sentinel outranks only scores below it (rows dropped by the
        # mask sit near -3e38 and may still fill a slot, as in the kernel)
        empty = v < _NEG
        vals.append(torch.where(empty, torch.full_like(v, _NEG), v))
        ids.append(torch.where(empty, torch.full_like(p, _BIG), p).to(torch.int32))
    return torch.cat(vals), torch.cat(ids)


def _nsplit(m: int, n: int, qt: int, slots: int) -> int:
    """Dataset splits per query tile. Blocks run in waves of ``slots`` (the
    device's resident blocks), each block walking ceil(tiles / splits)
    dataset tiles: take the fewest splits (each costs a list warm-up and a
    merge) whose tile-steps in all, waves x tiles per block, are within 2%
    of the least. Splits are at least 8 tiles long."""
    tiles = -(-n // _NB)
    mt = -(-m // qt)
    steps = [(-(-mt * s // slots)) * (-(-tiles // s))
             for s in range(1, max(1, min(tiles // 8, 1024)) + 1)]
    best = min(steps)
    return next(i + 1 for i, t in enumerate(steps) if t <= 1.02 * best)


def _vector_ready(t):
    """The kernel loads four elements at a time: zero-pad the feature dim to
    a multiple of 4 (zeros change no product) and align the start."""
    if t.shape[1] % 4:
        t = torch.nn.functional.pad(t, (0, 4 - t.shape[1] % 4))
    if t.data_ptr() % (4 * t.element_size()):
        t = t.clone()
    return t


def _config(lib, mode: int, k: int):
    """(queries per block, resident blocks on the current device) of the
    kernel for this mode and k."""
    fn = lib.fused_knn_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    qt, slots = ctypes.c_int(), ctypes.c_int()
    err = fn(mode, k, ctypes.byref(qt), ctypes.byref(slots))
    expects(err == 0 and slots.value > 0,
            "fused_knn kernel config failed: cudaError %d, %d resident blocks",
            err, slots.value)
    return qt.value, slots.value


def _launch(qs, ds, yn, k, l2, mode):
    from ._build import load

    for t, name in ((qs, "queries"), (ds, "dataset"), (yn, "yn")):
        expects(t.device == ds.device and t.is_contiguous(),
                "fused_knn: %s must be contiguous on %s", name, ds.device)
    expects(qs.dtype == ds.dtype == _IO_TYPE[mode] and yn.dtype == torch.float32,
            "fused_knn: mode %r takes %s operands and float32 yn, got %s/%s/%s",
            mode, _IO_TYPE[mode], qs.dtype, ds.dtype, yn.dtype)
    lib = load("fused_knn")
    fn = lib.fused_knn_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    qs, ds = _vector_ready(qs), _vector_ready(ds)
    m, d = qs.shape
    n = ds.shape[0]
    dev = ds.device
    with torch.cuda.device(dev):
        qt, slots = _config(lib, _MODES[mode], k)
    ns = _nsplit(m, n, qt, slots)
    out_v = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    part_v = torch.empty((m, ns, k) if ns > 1 else (0,), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, ns, k) if ns > 1 else (0,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_MODES[mode], qs.data_ptr(), ds.data_ptr(), yn.data_ptr(),
                 m, n, d, k, int(l2), ns, part_v.data_ptr(), part_i.data_ptr(),
                 out_v.data_ptr(), out_i.data_ptr(), stream)
    fused_knn.launches += 1
    expects(err == 0, "fused_knn kernel launch failed: cudaError %d", err)
    return out_v, out_i


def _prepare(dataset, queries, k, metric, mode, keep_mask, row_bias):
    n, d = dataset.shape
    expects(0 < k <= FUSED_KNN_MAX_K,
            "fused_knn supports k in (0, %d], got %d — use brute_force.knn "
            "for larger k", FUSED_KNN_MAX_K, k)
    expects(k <= n, "k=%d must be <= n=%d", k, n)
    expects(mode in _MODES, "mode must be one of %s, got %r", sorted(_MODES), mode)
    expects(metric in ("l2", "ip"), "metric must be 'l2' or 'ip', got %r", metric)
    expects(queries.ndim == 2 and queries.shape[1] == d,
            "queries must be (m, %d)", d)
    if mode == "s8":
        expects(dataset.dtype == torch.int8 and queries.dtype == torch.int8,
                "mode='s8' requires int8 operands (shift uint8 by -128 "
                "first), got %s/%s", dataset.dtype, queries.dtype)
    l2 = metric == "l2"
    base = (dataset.to(torch.float32).square().sum(dim=1) if l2
            else torch.zeros((n,), dtype=torch.float32, device=dataset.device))
    if row_bias is not None:
        rb = torch.as_tensor(row_bias, dtype=torch.float32, device=dataset.device)
        expects(tuple(rb.shape) == (n,), "row_bias must be (n,)")
        base = base + rb
    if keep_mask is not None:
        keep = torch.as_tensor(keep_mask, device=dataset.device).to(torch.bool)
        expects(tuple(keep.shape) == (n,), "keep_mask must be (n,)")
        # clamp: a huge |y|² plus the penalty would overflow to inf, and an
        # inf norm turns the masked arithmetic into NaN
        base = torch.clamp_max(base + torch.where(keep, 0.0, _MASK_PENALTY),
                               _MASK_PENALTY)
    io = _IO_TYPE[mode]
    ds = dataset.to(io).contiguous()
    qs = queries.to(io).contiguous()
    return ds, qs, base.contiguous(), l2


def _finish(queries, out_v, out_i, l2, sqrt):
    empty = out_v <= _NEG / 2
    out_i = torch.where(empty, -1, out_i)
    if l2:
        qn = queries.to(torch.float32).square().sum(dim=1, keepdim=True)
        dist = torch.clamp_min(qn - out_v, 0.0)
        if sqrt:
            dist = torch.sqrt(dist)
        dist = torch.where(empty, math.inf, dist)
    else:
        dist = torch.where(empty, -math.inf, out_v)   # similarity, larger = closer
    return dist, out_i


def fused_knn(dataset, queries, k, *, metric="l2", mode="f32", keep_mask=None,
              sqrt=False, row_bias=None):
    """Exact brute-force kNN through the ``fused_knn`` kernel.

    ``dataset`` (n, d) and ``queries`` (m, d) are tensors on one device.
    ``metric``: "l2" (squared euclidean; ``sqrt=True`` for euclidean) or
    "ip" (inner product, larger = closer; cosine is "ip" over normalized
    rows). ``mode="s8"`` takes int8 operands. ``row_bias`` (n,) is subtracted
    from every row's score. Returns (distances (m, k) float32, rows (m, k)
    int32); slots no admissible row fills read -1 and +inf (l2) or -inf (ip).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    expects(dataset.device == queries.device,
            "dataset and queries must be on one device, got %s and %s",
            dataset.device, queries.device)
    ds, qs, yn, l2 = _prepare(dataset, queries, k, metric, mode, keep_mask, row_bias)
    if ds.device.type == "cpu":
        out_v, out_i = _select_plain(qs, ds, yn, int(k), l2, mode)
    else:
        expects(ds.device.type == "cuda",
                "fused_knn runs on cuda or cpu tensors, got %s", ds.device)
        out_v, out_i = _launch(qs, ds, yn, int(k), l2, mode)
    return _finish(queries, out_v, out_i, l2, sqrt)


def fused_knn_plain(dataset, queries, k, *, metric="l2", mode="f32",
                    keep_mask=None, sqrt=False, row_bias=None):
    """Plain PyTorch version of :func:`fused_knn`: the same arguments, the
    same results, on any device."""
    ds, qs, yn, l2 = _prepare(dataset, queries, k, metric, mode, keep_mask, row_bias)
    out_v, out_i = _select_plain(qs, ds, yn, int(k), l2, mode)
    return _finish(queries, out_v, out_i, l2, sqrt)


fused_knn.launches = 0
