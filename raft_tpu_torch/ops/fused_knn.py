"""Fused distance + top-k for exact brute-force kNN: the ``fused_knn``
kernels and their plain version.

Counterpart of raft_tpu/ops/fused_knn.py (``fused_knn``, the Pallas kernel
that scores never leave). The CUDA kernels return, per query, the k largest scores ``2·q·y − yn`` (l2) or ``q·y − yn`` (ip) and
their dataset rows, best first, starting from the sentinels (-3e38, 2^30);
equal scores go to the lowest row. See their headers for the designs and
bounds.
:func:`fused_knn_plain` computes the same function in PyTorch, query tile by
query tile.

Around the kernel this module keeps the JAX wrapper's contract: ``yn``
carries |y|² (l2), an optional ``row_bias`` and the 3e38 penalty of rows the
``keep_mask`` drops, clamped at 3e38; the epilogue turns scores into
distances (``|q|² − s`` clamped at 0, optional sqrt, or the similarity for
ip) and reports unfilled slots as -1 / ±inf. The TPU kernel's 128-lane
padding of ``d`` and its VMEM block-size loop are TPU artefacts and are not
carried over.

Modes: "f32" (float32 products on CUDA cores, never TF32; ``csrc/fused_knn.cu``),
and on the tensor cores (``csrc/fused_knn_tc.cu``, wgmma): "bf16" (operands
cast to bfloat16 here, float32 sums), "f32x3" (float32 operands split into
bf16 hi and lo planes by :func:`bf16_split`, a kernel of the same source,
``(hi·hi + hi·lo) + lo·hi``) and "s8" (int8 operands, exact int32 sums).

:func:`fused_knn` launches the mode's kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback from one to the other.
``fused_knn.launches`` counts the kernels' launches, ``launches_by_mode`` per
mode.
:func:`tile_plan` is the tensor-core kernel's shared-memory plan, computed
from shapes alone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.errors import expects
from ._build import count_launch
from ..distance.pairwise import full_f32
from .topk import top_k_lowest_index

__all__ = ["fused_knn", "fused_knn_plain", "fused_knn_config", "tile_plan", "bf16_split",
           "bf16_split_plain", "row_ready", "tc_rounding_bound", "shapes_eligible",
           "FUSED_KNN_MAX_K", "SMEM_MAX"]

FUSED_KNN_MAX_K = 64
_NEG = -3.0e38                # "no entry" score
_BIG = 2**30                  # "no entry" row
_MASK_PENALTY = 3.0e38        # added to yn for rows the keep-mask drops
_MODES = {"f32": 0, "f32x3": 1, "bf16": 2, "s8": 3}
_IO_TYPE = {"f32": torch.float32, "f32x3": torch.float32,
            "bf16": torch.bfloat16, "s8": torch.int8}
_NB = 128                     # the FFMA kernel's dataset tile (rows)

# The tensor-core kernel (csrc/fused_knn_tc.cu): queries per block, dataset
# rows per tile, operand planes and bytes per element, per mode.
_TC = {"bf16": (256, 128, 1, 2), "s8": (256, 128, 1, 1), "f32x3": (128, 64, 2, 2)}
# Tile-steps one list insertion per query row costs the tensor-core kernel
# (_nsplit's warm-up term): a warp inserts into its query rows one at a
# time, and its warpgroup's next products wait for it. The least-squares fit
# of bf16's times at k = 1, 10 and 64 on the H100 (chip_smoke.py prints
# each mode's fit beside it; PERF.md).
_INSERT_TILES = 9.6
SMEM_MAX = 232_448            # dynamic shared memory a block may have on Hopper
_CH = 128                     # bytes of a row per TMA box / 128-byte swizzle span
_MAX_STAGES = 8
_ALIGN = 1024


def shapes_eligible(n: int, d: int, k: int) -> bool:
    """The fused path's shape gate, the same as the JAX package's: k <= 64,
    n >= 4096 (below that the GEMM + top-k path is as good) and
    64 <= d <= 4096."""
    return 0 < k <= FUSED_KNN_MAX_K and n >= 4096 and 64 <= d <= 4096


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _flush(x):
    """Subnormal float32 values as zeros of their sign."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0.0, x)


def bf16_split_plain(x):
    """The round-to-nearest bf16 split of float32 ``x`` into (hi, lo) bf16
    planes, ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, as JAX's ``_scores``
    (raft_tpu/ops/fused_knn.py) makes them: its subtraction runs with
    subnormals flushed to zero (XLA on the CPU, and the TPU), so this one
    flushes its operands and result too. :func:`_dots` keeps the unflushed
    residual; the two differ only where |lo| < 2^-126."""
    hi = x.to(torch.bfloat16)
    return hi, _flush(_flush(x) - _flush(hi.to(torch.float32))).to(torch.bfloat16)


def bf16_split(x):
    """:func:`bf16_split_plain` of a float32 tensor: on a CUDA tensor the
    ``bf16_split`` kernel (csrc/fused_knn_tc.cu, one pass: 4 bytes read and
    4 written an element), on a CPU tensor the plain version.
    ``bf16_split.launches`` counts the kernel's launches."""
    if x.device.type == "cpu":
        return bf16_split_plain(x)
    from ._build import load

    expects(x.device.type == "cuda" and x.dtype == torch.float32,
            "bf16_split takes float32 on cuda or cpu, got %s on %s", x.dtype, x.device)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    hi = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lo = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    fn = load("fused_knn_tc").bf16_split_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(bf16_split)
    expects(err == 0, "bf16_split kernel launch failed: cudaError %d", err)
    return hi, lo


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


def _split_steps(mt: int, tiles: int, s: int, slots: int, nb: int, warm: float) -> float:
    """Tile-steps of one launch at ``s`` splits: waves of ``slots`` blocks
    (``mt`` query tiles x ``s``), each walking ceil(tiles / s) dataset
    tiles of ``nb`` rows and paying a warm-up of its per-query lists, about
    ``warm`` x (1 + ln(rows / warm)) tile-steps: the insertions a running
    top-k makes over a split of that many rows, k x (1 + ln(rows / k)),
    with ``warm`` = k x the tile-steps one insertion per row costs (0 for
    the FFMA kernel, whose tiles dwarf its insertions)."""
    per = -(-tiles // s)
    w = warm * (1.0 + math.log(max(per * nb / warm, 1.0))) if warm else 0.0
    return (-(-mt * s // slots)) * (per + w)


def _nsplit(m: int, n: int, qt: int, slots: int, nb: int = _NB, warm: float = 0.0) -> int:
    """Dataset splits per query tile: the fewest whose tile-steps
    (:func:`_split_steps`) are within 2% of the least. Splits are at least
    8 tiles long."""
    tiles = -(-n // nb)
    mt = -(-m // qt)
    costs = [_split_steps(mt, tiles, s, slots, nb, warm)
             for s in range(1, max(1, min(tiles // 8, 1024)) + 1)]
    best = min(costs)
    return next(i + 1 for i, c in enumerate(costs) if c <= 1.02 * best)


def row_ready(t):
    """An operand as the kernels read it: rows of a multiple of 16 bytes
    (the TMA's stride rule, and the FFMA kernel's four-float loads), zeros
    padded on the right only when d needs it (zeros change no product), and
    a 16-byte aligned base."""
    per = 16 // t.element_size()
    if t.shape[1] % per:
        t = torch.nn.functional.pad(t, (0, per - t.shape[1] % per))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def tile_plan(mode: str, d: int, k: int) -> dict:
    """Shared-memory plan of the tensor-core kernel for ``mode`` at feature
    dim ``d`` (after :func:`row_ready`'s pad) and ``k``: ``qt`` queries a
    block, ``nb`` dataset rows a tile, ``kc`` 128-byte chunks a row,
    ``resident`` (the query tile loaded once per block, else restaged with
    every dataset chunk), ``stages`` of the copy ring and ``smem`` bytes
    (beside them a ring of as many tiles' yn). The query tile stays
    resident when it fits beside two stages and the per-query lists (qt x k
    x 8 bytes); the ring then takes what is left, up to 8 stages. A layout
    that does not fit in ``SMEM_MAX`` even restaged raises.
    csrc/fused_knn_tc.cu's ``layout`` computes the same bytes."""
    qt, nb, planes, elt = _TC[mode]
    kc = -(-d * elt // _CH)
    a_chunk, b_chunk = planes * qt * _CH, planes * nb * _CH
    lists = qt * k * 8

    def total(resident, stages):
        stage = b_chunk + (0 if resident else a_chunk)
        yn_slots = max(2, stages // kc)     # the yn ring holds as many tiles
        body = (kc * a_chunk if resident else 0) + stages * stage + lists + yn_slots * nb * 4
        return body + (2 * stages + 1 + 2 * yn_slots) * 8 + _ALIGN

    for resident in (True, False):
        stages = 2
        while stages < _MAX_STAGES and total(resident, stages + 1) <= SMEM_MAX:
            stages += 1
        if total(resident, stages) <= SMEM_MAX:
            return dict(qt=qt, nb=nb, kc=kc, resident=resident, stages=stages,
                        smem=total(resident, stages))
    expects(False, "fused_knn mode %r: no layout of d=%d, k=%d fits in %d bytes of "
            "shared memory (%d needed restaged)", mode, d, k, SMEM_MAX, total(False, 2))


def tc_rounding_bound(dataset, queries, ids, metric="l2", mode="bf16"):
    """How far a tensor-core mode's scores may lie from the plain version's,
    per returned (query, slot): (m, k) float32, 0 for s8 and empty slots.

    wgmma sums float32 by truncation where an FFMA sum rounds to nearest:
    about one unit in the last place of the running sum per k-step (16
    features). So |Δdot| <= (d/16 + 3) · 2^-23 · Σ_j |q_j · y_j| (the 3 for
    f32x3's two combining adds and the plain sum's own rounding), and a
    score, or an l2 distance, moves by c·|Δdot|, c = 2 for l2 and 1 for ip.
    Below 1e-5 of the distance for d <= 256 at the test data's scale; the
    checks at larger d hold the kernel to it (PERF.md)."""
    if mode == "s8":
        return torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    steps = -(-dataset.shape[1] // 16)
    rows = dataset.to(torch.float32).abs()[ids.clamp_min(0).long()]       # (m, k, d)
    sab = (queries.to(torch.float32).abs()[:, None, :] * rows).sum(dim=-1)
    c = 2.0 if metric == "l2" else 1.0
    return torch.where(ids >= 0, c * (steps + 3) * 2.0**-23 * sab, 0.0)


def _config(lib, mode: str, d: int, k: int, plan: dict | None):
    """(queries per block, resident blocks on the current device) of the
    mode's kernel at this d and k."""
    if plan is None:
        fn = lib.fused_knn_config
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        qt, slots = ctypes.c_int(), ctypes.c_int()
        err = fn(k, ctypes.byref(qt), ctypes.byref(slots))
    else:
        fn = lib.fused_knn_tc_config
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        qt, nb, slots, smem = (ctypes.c_int() for _ in range(4))
        err = fn(_MODES[mode], d, k, int(plan["resident"]), plan["stages"], ctypes.byref(qt),
                 ctypes.byref(nb), ctypes.byref(slots), ctypes.byref(smem))
        expects(err != 0 or (qt.value, nb.value, smem.value)
                == (plan["qt"], plan["nb"], plan["smem"]),
                "fused_knn tile plan disagrees with the kernel: %s against qt=%d nb=%d "
                "smem=%d", plan, qt.value, nb.value, smem.value)
    expects(err == 0 and slots.value > 0,
            "fused_knn kernel config failed: cudaError %d, %d resident blocks",
            err, slots.value)
    return qt.value, slots.value


def fused_knn_config(mode: str, d: int, k: int, device=None) -> dict:
    """The mode's tile plan at (d, k) and how many of its blocks the card
    holds at once (``slots``): what the launcher sizes the splits from."""
    from ._build import load

    lib = load("fused_knn" if mode == "f32" else "fused_knn_tc")
    plan = None if mode == "f32" else tile_plan(mode, d, k)
    with torch.cuda.device(device or torch.cuda.current_device()):
        qt, slots = _config(lib, mode, d, k, plan)
    return dict(plan or {}, qt=qt, slots=slots)


def _operands(qs, ds, mode):
    """The kernel's operand tensors: [q, y] (f32, bf16, s8) or the bf16
    planes [q_hi, q_lo, y_hi, y_lo] (f32x3), each through row_ready."""
    if mode == "f32x3":
        qh, ql = bf16_split(qs)
        yh, yl = bf16_split(ds)
        return [row_ready(t) for t in (qh, ql, yh, yl)]
    return [row_ready(qs), row_ready(ds)]


def _launch(qs, ds, yn, k, l2, mode):
    from ._build import load

    for t, name in ((qs, "queries"), (ds, "dataset"), (yn, "yn")):
        expects(t.device == ds.device and t.is_contiguous(),
                "fused_knn: %s must be contiguous on %s", name, ds.device)
    expects(qs.dtype == ds.dtype == _IO_TYPE[mode] and yn.dtype == torch.float32,
            "fused_knn: mode %r takes %s operands and float32 yn, got %s/%s/%s",
            mode, _IO_TYPE[mode], qs.dtype, ds.dtype, yn.dtype)
    ops = _operands(qs, ds, mode)
    m, d = ops[0].shape
    n = ds.shape[0]
    dev = ds.device
    tc = mode != "f32"
    lib = load("fused_knn_tc" if tc else "fused_knn")
    plan = tile_plan(mode, d, k) if tc else None
    with torch.cuda.device(dev):
        qt, slots = _config(lib, mode, d, k, plan)
    nb = plan["nb"] if tc else _NB
    ns = _nsplit(m, n, qt, slots, nb, _INSERT_TILES * k if tc else 0.0)
    out_v = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    part_v = torch.empty((m, ns, k) if ns > 1 else (0,), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, ns, k) if ns > 1 else (0,), dtype=torch.int32, device=dev)
    outs = [part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tc:
            # rows past n score -inf: +inf in yn up to whole tiles
            tiles = -(-n // nb)
            ynp = torch.nn.functional.pad(yn, (0, tiles * nb - n), value=math.inf)
            q, y = ops[0], ops[-2 if mode == "f32x3" else 1]
            ql, yl = (ops[1], ops[3]) if mode == "f32x3" else (q, y)
            fn = lib.fused_knn_tc_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
            err = fn(_MODES[mode], q.data_ptr(), ql.data_ptr(), y.data_ptr(), yl.data_ptr(),
                     ynp.data_ptr(), m, n, d, k, int(l2), ns, int(plan["resident"]),
                     plan["stages"], *outs, stream)
        else:
            fn = lib.fused_knn_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
            err = fn(ops[0].data_ptr(), ops[1].data_ptr(), yn.data_ptr(), m, n, d, k,
                     int(l2), ns, *outs, stream)
    count_launch(fused_knn, mode)
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


bf16_split.launches = 0
fused_knn.launches = 0
fused_knn.launches_by_mode = dict.fromkeys(_MODES, 0)
