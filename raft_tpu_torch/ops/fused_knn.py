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

Modes: "f32", and on the tensor cores (``csrc/fused_knn_tc.cu``, wgmma):
"bf16" (operands cast to bfloat16 here, float32 sums), "f32x3" (float32
operands split into bf16 hi and lo planes by :func:`bf16_split`, a kernel of
the same source, ``(hi·hi + hi·lo) + lo·hi``) and "s8" (int8 operands,
exact int32 sums). Mode "f32" has two routes on the card, a fixed dispatch
by the query count m (:func:`f32_route`): up to :data:`M_SMALL` queries the
row-split kernel of ``csrc/fused_knn.cu`` (the grid walks the dataset, each
row read once, float32 FFMA products, |y|² summed in the kernel, so the
wrapper passes only the row bias and mask penalty); beyond, "tf32x3": the
tensor-core kernel over the round-to-nearest-even tf32 split of the float32
operands (:func:`tf32_split`, ``hi·hi + (hi·lo + lo·hi)``, float32-accurate
as the TPU kernel's ``Precision.HIGHEST`` split is; never one TF32 product).

:func:`fused_knn` launches the mode's kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback from one to the other.
``fused_knn.launches`` counts the kernels' launches, ``launches_by_mode`` per
mode and ``launches_by_route`` per route of mode f32.
:func:`tile_plan` is the tensor-core kernel's shared-memory plan and
:func:`row_plan` / :func:`row_splits` the row-split kernel's, computed from
shapes alone.
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
           "bf16_split_plain", "tf32_split", "tf32_split_plain", "row_plan", "row_splits",
           "f32_route", "row_ready", "tc_rounding_bound", "shapes_eligible",
           "FUSED_KNN_MAX_K", "SMEM_MAX", "M_SMALL"]

FUSED_KNN_MAX_K = 64
_NEG = -3.0e38                # "no entry" score
_BIG = 2**30                  # "no entry" row
_MASK_PENALTY = 3.0e38        # added to yn for rows the keep-mask drops
_MODES = {"f32": 0, "f32x3": 1, "bf16": 2, "s8": 3}
_IO_TYPE = {"f32": torch.float32, "f32x3": torch.float32,
            "bf16": torch.bfloat16, "s8": torch.int8}
# Mode f32's routes on the card: "rows", the row-split kernel
# (csrc/fused_knn.cu) for m <= M_SMALL queries, where reading the dataset
# (once up to 64 queries, once a 64-query tile beyond) bounds the call;
# beyond, "tf32x3": the tensor-core kernel over the 3xTF32
# split (csrc/fused_knn_tc.cu). M_SMALL is the crossover of chip_smoke.py
# phase 3's sweep of both routes over m in {1, 8, ..., 512} at 1M x 128 on
# the H100: the row-split route was the faster at every swept m up to 256,
# the batch route from 384 on (PERF.md).
M_SMALL = 256
_F32_ROUTES = ("rows", "tf32x3")

# The tensor-core kernel (csrc/fused_knn_tc.cu): queries per block, dataset
# rows per tile, operand planes and bytes per element, per mode.
_TC = {"bf16": (256, 128, 1, 2), "s8": (256, 128, 1, 1), "f32x3": (128, 64, 2, 2),
       "tf32x3": (128, 64, 2, 4)}
_TC_MODE = {"f32x3": 1, "bf16": 2, "s8": 3, "tf32x3": 4}   # the kernel's mode numbers
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
# The row-split kernel: queries a block may hold, and its warps.
_ROW_MQ = (1, 2, 4, 8, 16, 32, 64)
_ROW_WARPS = 8


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


def tf32_split_plain(x):
    """The round-to-nearest-even tf32 split of float32 ``x`` into float32
    planes (hi, lo): ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, each with
    its low 13 mantissa bits zero, so the tensor core reads both exactly
    (csrc/fused_knn_tc.cu ``tf32_rn``, bit for bit). ``x - hi`` is exact,
    and ``hi + lo`` holds x to about 2^-22 of |x|. inf and NaN keep their
    bits in hi."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def rn(u):
        finite = (u & 0x7F800000) != 0x7F800000
        u = torch.where(finite, u + 0xFFF + ((u >> 13) & 1), u) & 0xFFFFE000
        return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)

    hi = rn(u)
    lo = rn((x - hi).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    return hi, lo


def tf32_split(x):
    """:func:`tf32_split_plain` of a float32 tensor: on a CUDA tensor the
    ``tf32_split`` kernel (csrc/fused_knn_tc.cu, one pass: 4 bytes read and
    8 written an element), on a CPU tensor the plain version.
    ``tf32_split.launches`` counts the kernel's launches."""
    if x.device.type == "cpu":
        return tf32_split_plain(x)
    from ._build import load

    expects(x.device.type == "cuda" and x.dtype == torch.float32,
            "tf32_split takes float32 on cuda or cpu, got %s on %s", x.dtype, x.device)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    hi = torch.empty_like(x)
    lo = torch.empty_like(x)
    fn = load("fused_knn_tc").tf32_split_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(tf32_split)
    expects(err == 0, "tf32_split kernel launch failed: cudaError %d", err)
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
    with ``warm`` = k x the tile-steps one insertion per row costs (0
    leaves the tile-steps alone)."""
    per = -(-tiles // s)
    w = warm * (1.0 + math.log(max(per * nb / warm, 1.0))) if warm else 0.0
    return (-(-mt * s // slots)) * (per + w)


def _nsplit(m: int, n: int, qt: int, slots: int, nb: int, warm: float = 0.0) -> int:
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
    (the TMA's stride rule), zeros
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
    ``mode="tf32x3"`` (mode f32's batch route) takes a k-step per 8
    features but sums hi·hi in two chains of alternate k-steps, so each
    truncating sum still runs over d/16 steps; its split adds 6 units (the
    dropped lo·lo term and the rounding of lo, each up to 2^-22 of |q·y|)
    and the chains' combining adds one more: (d/16 + 10) · 2^-23 ·
    Σ_j |q_j · y_j|.
    Below 1e-5 of the distance for d <= 256 at the test data's scale; the
    checks at larger d hold the kernel to it (PERF.md)."""
    if mode == "s8":
        return torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    extra = 10 if mode == "tf32x3" else 3
    steps = -(-dataset.shape[1] // 16)
    rows = dataset.to(torch.float32).abs()[ids.clamp_min(0).long()]       # (m, k, d)
    sab = (queries.to(torch.float32).abs()[:, None, :] * rows).sum(dim=-1)
    c = 2.0 if metric == "l2" else 1.0
    return torch.where(ids >= 0, c * (steps + extra) * 2.0**-23 * sab, 0.0)


def row_plan(m: int, k: int) -> dict:
    """Shared-memory plan of mode f32's row-split kernel for m queries and
    k: ``mq`` queries a block (the least power of two up to 64 that holds
    m; 64 beyond, and the grid then walks query tiles), ``nb`` dataset rows
    a tile, ``rg`` row groups (lists a query keeps in a block: 8 warps hold
    mq / min(mq, 8) query groups), ``stages`` of the ring (each a 128-byte
    box of nb rows and of the mq queries, the latter padded to 8 rows, up
    to 8 stages) and ``smem`` bytes. csrc/fused_knn.cu's ``row_layout``
    computes the same bytes; d does not enter it (a row is staged 32
    features at a time)."""
    mq = next((q for q in _ROW_MQ if m <= q), _ROW_MQ[-1])
    nb = 128 if mq == 64 else 256
    rg = _ROW_WARPS // (mq // min(mq, 8))

    def total(stages):
        return (stages * (nb + max(mq, 8)) * _CH + 2 * rg * mq * k * 4 + 2 * stages * 8
                + _ALIGN)

    expects(total(2) <= SMEM_MAX, "fused_knn rows route: k=%d needs %d bytes of shared "
            "memory", k, total(2))
    stages = max(s for s in range(2, _MAX_STAGES + 1) if total(s) <= SMEM_MAX)
    return dict(mq=mq, nb=nb, rg=rg, stages=stages, smem=total(stages))


def row_splits(m: int, n: int, plan: dict, slots: int) -> tuple[int, int]:
    """(splits, waves) of the row-split route: split s takes tiles
    [s·T/S, (s+1)·T/S) of the dataset's T tiles (never empty: S <= T), and
    splits x query tiles fill a whole number of waves of the card's
    ``slots`` resident blocks where the dataset has tiles enough; of 1 to 8
    waves, the fewest whose tile-steps (waves x (tiles a split + one for a
    block's start)) are least."""
    tiles = -(-n // plan["nb"])
    mt = -(-m // plan["mq"])
    per_wave = max(1, slots // mt)
    best = None
    for w in range(1, 9):
        s = min(tiles, w * per_wave)
        waves = -(-mt * s // slots)
        cost = waves * (-(-tiles // s) + 1)
        if best is None or cost < best[0]:
            best = (cost, s, waves)
    return best[1], best[2]


def _rows_config(lib, m: int, k: int, plan: dict) -> int:
    """Resident blocks of the row-split kernel on the current device,
    after checking the kernel's plan against :func:`row_plan`."""
    fn = lib.fused_knn_rows_config
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    mq, nb, slots, smem = (ctypes.c_int() for _ in range(4))
    err = fn(m, k, plan["stages"], ctypes.byref(mq), ctypes.byref(nb), ctypes.byref(slots),
             ctypes.byref(smem))
    expects(err != 0 or (mq.value, nb.value, smem.value) == (plan["mq"], plan["nb"], plan["smem"]),
            "fused_knn row plan disagrees with the kernel: %s against mq=%d nb=%d smem=%d",
            plan, mq.value, nb.value, smem.value)
    expects(err == 0 and slots.value > 0,
            "fused_knn rows config failed: cudaError %d, %d resident blocks", err, slots.value)
    return slots.value


def _config(lib, mode: str, d: int, k: int, plan: dict):
    """(queries per block, resident blocks on the current device) of the
    tensor-core kernel in ``mode`` at this d and k, after checking the
    kernel's plan against :func:`tile_plan`'s."""
    fn = lib.fused_knn_tc_config
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    qt, nb, slots, smem = (ctypes.c_int() for _ in range(4))
    err = fn(_TC_MODE[mode], d, k, int(plan["resident"]), plan["stages"], ctypes.byref(qt),
             ctypes.byref(nb), ctypes.byref(slots), ctypes.byref(smem))
    expects(err != 0 or (qt.value, nb.value, smem.value)
            == (plan["qt"], plan["nb"], plan["smem"]),
            "fused_knn tile plan disagrees with the kernel: %s against qt=%d nb=%d "
            "smem=%d", plan, qt.value, nb.value, smem.value)
    expects(err == 0 and slots.value > 0,
            "fused_knn kernel config failed: cudaError %d, %d resident blocks",
            err, slots.value)
    return qt.value, slots.value


def fused_knn_config(mode: str, d: int, k: int, device=None, m: int = 1) -> dict:
    """The tile plan at (d, k) and how many of its blocks the card holds at
    once (``slots``): what the launcher sizes the splits from. ``mode``: a
    tensor-core mode, "tf32x3", or "rows" (the row-split kernel's plan for
    ``m`` queries)."""
    from ._build import load

    with torch.cuda.device(device or torch.cuda.current_device()):
        if mode == "rows":
            plan = row_plan(m, k)
            return dict(plan, slots=_rows_config(load("fused_knn"), m, k, plan))
        plan = tile_plan(mode, d, k)
        qt, slots = _config(load("fused_knn_tc"), mode, d, k, plan)
    return dict(plan, qt=qt, slots=slots)


def _operands(qs, ds, kind):
    """The kernel's operand tensors: [q, y] (bf16, s8, mode f32's row-split
    route) or the hi / lo planes [q_hi, q_lo, y_hi, y_lo]
    (f32x3's bf16 planes, tf32x3's float32 planes), each through
    row_ready."""
    split = {"f32x3": bf16_split, "tf32x3": tf32_split}.get(kind)
    if split is not None:
        qh, ql = split(qs)
        yh, yl = split(ds)
        return [row_ready(t) for t in (qh, ql, yh, yl)]
    return [row_ready(qs), row_ready(ds)]


def _check_operands(qs, ds, io, extra=()):
    for t, name in ((qs, "queries"), (ds, "dataset"), *extra):
        expects(t.device == ds.device and t.is_contiguous(),
                "fused_knn: %s must be contiguous on %s", name, ds.device)
    expects(qs.dtype == ds.dtype == io, "fused_knn: %s operands expected, got %s/%s",
            io, qs.dtype, ds.dtype)


def _outputs(m, k, ns, dev):
    """(out_v, out_i), the splits' parts and the pointers a launcher takes
    (parts, then outputs). The caller holds the parts until its launch is
    queued, so the allocator cannot hand their memory to another tensor
    first."""
    out_v = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
    part_v = torch.empty((m, ns, k) if ns > 1 else (0,), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, ns, k) if ns > 1 else (0,), dtype=torch.int32, device=dev)
    return out_v, out_i, (part_v, part_i), [part_v.data_ptr(), part_i.data_ptr(),
                                            out_v.data_ptr(), out_i.data_ptr()]


def _launch_tc(qs, ds, yn, k, l2, kind):
    """The tensor-core kernel (csrc/fused_knn_tc.cu) in ``kind``: a mode,
    or "tf32x3" (mode f32's batch route). Returns (out_v, out_i, err)."""
    from ._build import load

    _check_operands(qs, ds, _IO_TYPE["f32" if kind == "tf32x3" else kind], ((yn, "yn"),))
    expects(yn.dtype == torch.float32, "fused_knn: yn must be float32, got %s", yn.dtype)
    ops = _operands(qs, ds, kind)
    m, d = ops[0].shape
    n = ds.shape[0]
    dev = ds.device
    lib = load("fused_knn_tc")
    plan = tile_plan(kind, d, k)
    with torch.cuda.device(dev):
        qt, slots = _config(lib, kind, d, k, plan)
    nb = plan["nb"]
    ns = _nsplit(m, n, qt, slots, nb, _INSERT_TILES * k)
    out_v, out_i, parts, outs = _outputs(m, k, ns, dev)
    # rows past n score -inf: +inf in yn up to whole tiles
    ynp = torch.nn.functional.pad(yn, (0, -(-n // nb) * nb - n), value=math.inf)
    q, y = ops[0], ops[-2 if len(ops) == 4 else 1]
    ql, yl = (ops[1], ops[3]) if len(ops) == 4 else (q, y)
    fn = lib.fused_knn_tc_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(_TC_MODE[kind], q.data_ptr(), ql.data_ptr(), y.data_ptr(), yl.data_ptr(),
                 ynp.data_ptr(), m, n, d, k, int(l2), ns, int(plan["resident"]),
                 plan["stages"], *outs, torch.cuda.current_stream(dev).cuda_stream)
    return out_v, out_i, err


def _launch_rows(qs, ds, pen, clamp, k, l2):
    """Mode f32's row-split kernel (csrc/fused_knn.cu). ``pen`` is the row
    bias plus mask penalty, or None; the kernel sums |y|² itself. Returns
    (out_v, out_i, err)."""
    from ._build import load

    _check_operands(qs, ds, torch.float32, () if pen is None else ((pen, "penalty"),))
    q, y = row_ready(qs), row_ready(ds)
    m, d = q.shape
    n = ds.shape[0]
    dev = ds.device
    lib = load("fused_knn")
    plan = row_plan(m, k)
    with torch.cuda.device(dev):
        slots = _rows_config(lib, m, k, plan)
    ns, _ = row_splits(m, n, plan, slots)
    out_v, out_i, parts, outs = _outputs(m, k, ns, dev)
    fn = lib.fused_knn_rows_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), y.data_ptr(), 0 if pen is None else pen.data_ptr(), int(clamp),
                 m, n, d, k, int(l2), ns, plan["stages"], *outs,
                 torch.cuda.current_stream(dev).cuda_stream)
    return out_v, out_i, err


def _checked(dataset, queries, k, metric, mode, keep_mask, row_bias):
    """The contract's checks; returns (ds, qs) in the mode's operand type,
    l2, and the row bias and keep mask as tensors on the dataset's device
    (or None)."""
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
    rb = keep = None
    if row_bias is not None:
        rb = torch.as_tensor(row_bias, dtype=torch.float32, device=dataset.device)
        expects(tuple(rb.shape) == (n,), "row_bias must be (n,)")
    if keep_mask is not None:
        keep = torch.as_tensor(keep_mask, device=dataset.device).to(torch.bool)
        expects(tuple(keep.shape) == (n,), "keep_mask must be (n,)")
    io = _IO_TYPE[mode]
    return (dataset.to(io).contiguous(), queries.to(io).contiguous(), metric == "l2",
            rb, keep)


def _base(dataset, l2, rb, keep):
    """yn of the contract: |y|² (l2), plus the row bias, plus the 3e38
    penalty of the rows the keep mask drops, clamped at 3e38."""
    n = dataset.shape[0]
    base = (dataset.to(torch.float32).square().sum(dim=1) if l2
            else torch.zeros((n,), dtype=torch.float32, device=dataset.device))
    if rb is not None:
        base = base + rb
    if keep is not None:
        # clamp: a huge |y|² plus the penalty would overflow to inf, and an
        # inf norm turns the masked arithmetic into NaN
        base = torch.clamp_max(base + torch.where(keep, 0.0, _MASK_PENALTY), _MASK_PENALTY)
    return base.contiguous()


def _penalty(rb, keep):
    """What the row-split route adds to the |y|² it sums itself: the row
    bias plus the mask penalty, (n,) float32, or None when there is
    neither; and whether the sum is clamped at 3e38 (a keep mask)."""
    pen = rb
    if keep is not None:
        p = torch.where(keep, 0.0, _MASK_PENALTY)
        pen = p if pen is None else pen + p
    return (None if pen is None else pen.contiguous()), keep is not None


def _prepare(dataset, queries, k, metric, mode, keep_mask, row_bias):
    """The plain version's inputs: (ds, qs, yn, l2)."""
    ds, qs, l2, rb, keep = _checked(dataset, queries, k, metric, mode, keep_mask, row_bias)
    return ds, qs, _base(dataset, l2, rb, keep), l2


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


def f32_route(m: int) -> str:
    """Mode f32's route for m queries: "rows" (the row-split kernel of
    csrc/fused_knn.cu) up to :data:`M_SMALL`, else "tf32x3" (the
    tensor-core kernel over the 3xTF32 split). A fixed dispatch by m."""
    return "rows" if m <= M_SMALL else "tf32x3"


def _on_card(dataset, ds, qs, k, l2, rb, keep, mode, route):
    """Launch ``mode``'s kernel (mode f32: ``route``'s) and count it.
    Returns (out_v, out_i)."""
    if route == "rows":
        out_v, out_i, err = _launch_rows(qs, ds, *_penalty(rb, keep), k, l2)
    else:
        out_v, out_i, err = _launch_tc(qs, ds, _base(dataset, l2, rb, keep), k, l2,
                                       route or mode)
    count_launch(fused_knn, mode, route)
    expects(err == 0, "fused_knn kernel launch failed: cudaError %d", err)
    return out_v, out_i


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
    Mode "f32" takes the route :func:`f32_route` gives for m.
    """
    expects(dataset.device == queries.device,
            "dataset and queries must be on one device, got %s and %s",
            dataset.device, queries.device)
    ds, qs, l2, rb, keep = _checked(dataset, queries, k, metric, mode, keep_mask, row_bias)
    if ds.device.type == "cpu":
        out_v, out_i = _select_plain(qs, ds, _base(dataset, l2, rb, keep), int(k), l2, mode)
    else:
        expects(ds.device.type == "cuda",
                "fused_knn runs on cuda or cpu tensors, got %s", ds.device)
        route = f32_route(qs.shape[0]) if mode == "f32" else None
        out_v, out_i = _on_card(dataset, ds, qs, int(k), l2, rb, keep, mode, route)
    return _finish(queries, out_v, out_i, l2, sqrt)


def _fused_knn_f32(route, dataset, queries, k, *, metric="l2", keep_mask=None, sqrt=False,
                   row_bias=None):
    """Mode f32 on the card by the route named ("rows" or "tf32x3") at any
    m, not the one :func:`f32_route` gives: for timing the routes against
    each other and checking each at the other's query counts. Counts its
    launch as :func:`fused_knn` does."""
    expects(route in _F32_ROUTES, "route must be one of %s, got %r", _F32_ROUTES, route)
    expects(dataset.device.type == "cuda" and queries.device == dataset.device,
            "a named route runs on one cuda device, got %s and %s",
            dataset.device, queries.device)
    ds, qs, l2, rb, keep = _checked(dataset, queries, k, metric, "f32", keep_mask, row_bias)
    out_v, out_i = _on_card(dataset, ds, qs, int(k), l2, rb, keep, "f32", route)
    return _finish(queries, out_v, out_i, l2, sqrt)


def fused_knn_plain(dataset, queries, k, *, metric="l2", mode="f32",
                    keep_mask=None, sqrt=False, row_bias=None):
    """Plain PyTorch version of :func:`fused_knn`: the same arguments, the
    same results, on any device."""
    ds, qs, yn, l2 = _prepare(dataset, queries, k, metric, mode, keep_mask, row_bias)
    out_v, out_i = _select_plain(qs, ds, yn, int(k), l2, mode)
    return _finish(queries, out_v, out_i, l2, sqrt)


bf16_split.launches = 0
tf32_split.launches = 0
fused_knn.launches = 0
fused_knn.launches_by_mode = dict.fromkeys(_MODES, 0)
fused_knn.launches_by_route = dict.fromkeys(_F32_ROUTES, 0)
