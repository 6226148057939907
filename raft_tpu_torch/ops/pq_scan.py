"""IVF-PQ look-up-table scan: the ``pq_scan`` kernel and its plain version.

Counterpart of raft_tpu/ops/pq_scan.py (``pq_lut_scan``, the Pallas LUT16
sweep behind ``SearchParams(scan_impl="pallas")``). For every (query, probe)
pair of a search step the function scores every slot of the list the pair
probes::

    pq4:        out[b, j] = sum_s lut[b, s, c & 15]
    split pq8:  out[b, j] = sum_s (lut[b, s, c >> 4] + lut[b, s, 16 + (c & 15)])

with ``c = list_codes[probe_lists[b], j, s]``, summed in float32 in subspace
order. Unlike ``pq_lut_scan``, which takes the gathered (pairs, cap, S) code
planes and a (pairs, K, S) LUT, this takes the index's ``list_codes`` as
stored and the probed list ids, and the LUT in ``ivf_pq._pq_search``'s own
(pairs, S, K) layout: the CUDA kernel (``csrc/pq_scan.cu``; see its header
for the design and its bound) follows the list ids itself, so the code gather
never reaches device memory. The TPU kernel's lane packing and padding of S
are TPU artefacts and are not carried over.

:func:`pq_scan_plain` sums in the same order as the kernel, so on the card
the two agree bit for bit. :func:`pq_scan` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; there is no fallback from
one to the other. ``pq_scan.launches`` counts the kernel's launches.

:func:`pq_scan_topk` is the scan fused with the search's per-chunk select
(the second kernel of ``csrc/pq_scan.cu``): for each query of a tile it
scores every slot of the lists the query probes, adds the pair's bias (and
the slot's constant for split pq8 under L2), masks empty slots with ±inf and
keeps the k best, so only (T, k) values and ids leave the kernel.
:func:`pq_scan_topk_plain` is the same composition in PyTorch
(:func:`pq_scan_plain`, the two adds, ``torch.where``, ``topk_plain`` with
the ids as payload); ``pq_scan_topk.launches`` counts the fused kernel's
launches. Both take an optional sample filter, ``keep_words``: the keep-mask
packed by :func:`pack_keep_words`, one bit for each id; a slot whose id's
bit is clear, or whose id lies past the bitset's last word, scores ±inf as
an empty slot does (the JAX package's ``apply_id_filter`` on the chunk's
scores) and keeps its id.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.errors import expects
from ._build import count_launch
from .topk import TOPK_MAX_K, topk_plain

__all__ = ["pq_scan", "pq_scan_plain", "pq_scan_topk", "pq_scan_topk_plain",
           "pq_scan_topk_fits", "pack_keep_words", "keep_bits"]

_LUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448            # shared memory a block can use (H100)
_THREADS = 256                # the kernel's slots per block


def _check(list_codes, probe_lists, lut, split):
    expects(list_codes.ndim == 3 and list_codes.dtype == torch.uint8,
            "pq_scan: list_codes must be (n_lists, cap, S) uint8, got %s %s",
            tuple(list_codes.shape), list_codes.dtype)
    expects(probe_lists.ndim == 1 and probe_lists.dtype == torch.int32,
            "pq_scan: probe_lists must be (pairs,) int32, got %s %s",
            tuple(probe_lists.shape), probe_lists.dtype)
    _, cap, s = list_codes.shape
    k = 32 if split else 16
    expects(tuple(lut.shape) == (probe_lists.shape[0], s, k),
            "pq_scan: lut must be (pairs=%d, S=%d, K=%d), got %s",
            probe_lists.shape[0], s, k, tuple(lut.shape))
    expects(lut.dtype in _LUT_CODE, "pq_scan: lut must be float32 or bfloat16, got %s",
            lut.dtype)
    expects(list_codes.device == probe_lists.device == lut.device,
            "pq_scan: list_codes, probe_lists and lut must be on one device")
    return cap, s


def pq_scan_plain(list_codes, probe_lists, lut, split: bool = False):
    """Plain PyTorch version of the ``pq_scan`` kernel: the same arguments,
    the same (pairs, cap) float32 scores, on any device."""
    cap, s_dim = _check(list_codes, probe_lists, lut, split)
    lutf = lut.to(torch.float32)
    rows = probe_lists.to(torch.int64)
    acc = torch.zeros((rows.shape[0], cap), dtype=torch.float32, device=lut.device)
    for s in range(s_dim):
        c = list_codes[rows, :, s].to(torch.int64)     # (pairs, cap)
        table = lutf[:, s, :]                           # (pairs, K)
        if split:
            acc = acc + (torch.gather(table, 1, c >> 4)
                         + torch.gather(table, 1, 16 + (c & 15)))
        else:
            acc = acc + torch.gather(table, 1, c & 15)
    return acc


def _launch(list_codes, probe_lists, lut, split):
    from ._build import load

    for t, name in ((list_codes, "list_codes"), (probe_lists, "probe_lists"), (lut, "lut")):
        expects(t.is_contiguous(), "pq_scan: %s must be contiguous", name)
    n_lists, cap, s = list_codes.shape
    pairs = probe_lists.shape[0]
    expects(pairs > 0 and cap > 0 and s > 0, "pq_scan needs pairs, slots and subspaces")
    expects(s * lut.shape[2] * 4 <= _MAX_SMEM,
            "pq_scan: a %d x %d float32 LUT exceeds a block's shared memory", s, lut.shape[2])
    expects(-(-cap // _THREADS) <= 65535, "pq_scan: cap=%d is too large", cap)
    lib = load("pq_scan")
    fn = lib.pq_scan_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    out = torch.empty((pairs, cap), dtype=torch.float32, device=lut.device)
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fn(_LUT_CODE[lut.dtype], int(split), list_codes.data_ptr(),
                 probe_lists.data_ptr(), lut.data_ptr(), pairs, n_lists, cap, s,
                 out.data_ptr(), stream)
    count_launch(pq_scan)
    expects(err == 0, "pq_scan kernel launch failed: cudaError %d", err)
    return out


def pq_scan(list_codes, probe_lists, lut, split: bool = False):
    """Scores (pairs, cap) float32 of every slot of the list each pair probes.

    ``list_codes`` (n_lists, cap, S) uint8 as an IVF-PQ index stores them;
    ``probe_lists`` (pairs,) int32, the list each (query, probe) pair scans;
    ``lut`` (pairs, S, K) float32 or bfloat16, K = 16, or 32 with ``split``
    (nibble-split pq8: the high nibble indexes columns 0-15, the low nibble
    columns 16-31). A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`pq_scan_plain`.
    """
    _check(list_codes, probe_lists, lut, split)
    if lut.device.type == "cpu":
        return pq_scan_plain(list_codes, probe_lists, lut, split)
    expects(lut.device.type == "cuda", "pq_scan runs on cuda or cpu tensors, got %s",
            lut.device)
    return _launch(list_codes, probe_lists, lut, bool(split))


pq_scan.launches = 0


def pack_keep_words(keep_mask):
    """A bool keep-mask (n,) as the kernel's bitset: (ceil(n / 32),) int32,
    bit ``i & 31`` of word ``i >> 5`` set when id ``i`` is kept."""
    keep = keep_mask.to(torch.bool).reshape(-1)
    n = keep.shape[0]
    bits = torch.zeros(-(-n // 32) * 32, dtype=torch.int64, device=keep.device)
    bits[:n] = keep.to(torch.int64)
    words = (bits.reshape(-1, 32) << torch.arange(32, device=keep.device)).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def keep_bits(keep_words, ids):
    """Whether each id of ``ids`` (any shape, -1 padding allowed) is kept by
    the packed ``keep_words``; padding and ids past the bitset's last word
    read as not kept."""
    i = ids.to(torch.int64).clamp_min(0)
    n_words = keep_words.shape[0]
    word = keep_words.to(torch.int64)[(i >> 5).clamp_max(n_words - 1)]
    return (((word >> (i & 31)) & 1) == 1) & (ids >= 0) & ((i >> 5) < n_words)


# pq_scan_topk's shared memory, as csrc/pq_scan.cu lays it out (fused::Layout)
_TOPK_STAGES = 2              # tiles in the kernel's ring
_TOPK_TILE = 512              # slots a tile
_SELECT_SMEM = 39_040         # the static shared memory ptxas reports (the select buffer)


def pq_scan_topk_smem(s: int, split: bool, lut_dtype, pc: int) -> int:
    """Bytes of shared memory the ``pq_scan_topk`` kernel takes at S=``s``,
    ``pc`` probes a chunk and a ``lut_dtype`` LUT."""
    k = 32 if split else 16
    staged = s % 16 == 0 and (s // 16) & (s // 16 - 1) == 0    # rows of 16 x 2^i bytes
    stage = (_TOPK_TILE * s if staged else 0) + s * k * lut_dtype.itemsize
    return _TOPK_STAGES * stage + s * k * 4 + 128 + pc * 8 + _SELECT_SMEM


def pq_scan_topk_fits(s: int, split: bool, lut_dtype, pc: int) -> bool:
    """True when the ``pq_scan_topk`` kernel's shared memory fits a block."""
    return pq_scan_topk_smem(s, split, lut_dtype, pc) <= _MAX_SMEM


def _check_topk(list_codes, list_ids, probe_lists, lut, bias, k, split, list_consts,
                keep_words=None):
    expects(list_codes.ndim == 3 and list_codes.dtype == torch.uint8,
            "pq_scan_topk: list_codes must be (n_lists, cap, S) uint8, got %s %s",
            tuple(list_codes.shape), list_codes.dtype)
    n_lists, cap, s = list_codes.shape
    expects(tuple(list_ids.shape) == (n_lists, cap) and list_ids.dtype == torch.int32,
            "pq_scan_topk: list_ids must be (n_lists=%d, cap=%d) int32, got %s %s",
            n_lists, cap, tuple(list_ids.shape), list_ids.dtype)
    expects(probe_lists.ndim == 2 and probe_lists.dtype == torch.int32,
            "pq_scan_topk: probe_lists must be (T, pc) int32, got %s %s",
            tuple(probe_lists.shape), probe_lists.dtype)
    t, pc = probe_lists.shape
    kk = 32 if split else 16
    expects(tuple(lut.shape) == (t, pc, s, kk),
            "pq_scan_topk: lut must be (T=%d, pc=%d, S=%d, K=%d), got %s",
            t, pc, s, kk, tuple(lut.shape))
    expects(lut.dtype in _LUT_CODE,
            "pq_scan_topk: lut must be float32 or bfloat16, got %s", lut.dtype)
    expects(tuple(bias.shape) == (t, pc) and bias.dtype == torch.float32,
            "pq_scan_topk: bias must be (T, pc) float32, got %s %s",
            tuple(bias.shape), bias.dtype)
    expects(list_consts is None or (tuple(list_consts.shape) == (n_lists, cap)
                                    and list_consts.dtype == torch.float32),
            "pq_scan_topk: list_consts must be (n_lists, cap) float32 or None")
    expects(keep_words is None or (keep_words.ndim == 1 and keep_words.dtype == torch.int32
                                   and keep_words.shape[0] >= 1),
            "pq_scan_topk: keep_words must be (words >= 1,) int32 or None")
    expects(0 < k <= min(TOPK_MAX_K, pc * cap),
            "pq_scan_topk: k=%d must be in (0, min(%d, pc x cap = %d)]",
            k, TOPK_MAX_K, pc * cap)
    devs = {a.device for a in (list_codes, list_ids, probe_lists, lut, bias, list_consts,
                               keep_words) if a is not None}
    expects(len(devs) == 1, "pq_scan_topk: every tensor must be on one device")
    return t, pc, cap, s


def pq_scan_topk_plain(list_codes, list_ids, probe_lists, lut, bias, k: int,
                       select_min: bool, split: bool = False, list_consts=None,
                       keep_words=None):
    """Plain PyTorch version of the ``pq_scan_topk`` kernel: the same
    arguments, the same (values (T, k) float32, ids (T, k) int32), on any
    device."""
    t, pc, cap, s = _check_topk(list_codes, list_ids, probe_lists, lut, bias, k, split,
                                list_consts, keep_words)
    scores = pq_scan_plain(list_codes, probe_lists.reshape(-1),
                           lut.reshape(t * pc, s, lut.shape[3]), split).reshape(t, pc, cap)
    scores = scores + bias[:, :, None]
    rows = probe_lists.to(torch.int64)
    if list_consts is not None:
        scores = scores + list_consts[rows]
    ids = list_ids[rows]                                    # (T, pc, cap)
    live = ids >= 0 if keep_words is None else keep_bits(keep_words, ids)
    scores = torch.where(live, scores, math.inf if select_min else -math.inf)
    v, pos = topk_plain(scores.reshape(t, pc * cap), k, select_min)
    return v, torch.gather(ids.reshape(t, pc * cap), 1, pos.to(torch.int64))


def _launch_topk(list_codes, list_ids, probe_lists, lut, bias, k, select_min, split,
                 list_consts, keep_words):
    from ._build import load

    t, pc = probe_lists.shape
    n_lists, cap, s = list_codes.shape
    for a, name in ((list_codes, "list_codes"), (list_ids, "list_ids"),
                    (probe_lists, "probe_lists"), (lut, "lut"), (bias, "bias"),
                    (list_consts, "list_consts"), (keep_words, "keep_words")):
        expects(a is None or a.is_contiguous(), "pq_scan_topk: %s must be contiguous", name)
    expects(t > 0, "pq_scan_topk needs at least one query")
    expects(lut.data_ptr() % 16 == 0, "pq_scan_topk: lut must be 16-byte aligned")
    expects(pq_scan_topk_fits(s, split, lut.dtype, pc),
            "pq_scan_topk: S=%d, pc=%d needs %d bytes of shared memory, more than a block's",
            s, pc, pq_scan_topk_smem(s, split, lut.dtype, pc))
    fn = load("pq_scan").pq_scan_topk_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    out_v = torch.empty((t, k), dtype=torch.float32, device=lut.device)
    out_i = torch.empty((t, k), dtype=torch.int32, device=lut.device)
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        err = fn(_LUT_CODE[lut.dtype], int(split), list_codes.data_ptr(), list_ids.data_ptr(),
                 None if list_consts is None else list_consts.data_ptr(),
                 None if keep_words is None else keep_words.data_ptr(),
                 0 if keep_words is None else keep_words.shape[0], probe_lists.data_ptr(),
                 lut.data_ptr(), bias.data_ptr(), t, pc, n_lists, cap, s, k, int(select_min),
                 out_v.data_ptr(), out_i.data_ptr(), stream)
    count_launch(pq_scan_topk)
    expects(err == 0, "pq_scan_topk kernel launch failed: cudaError %d", err)
    return out_v, out_i


def pq_scan_topk(list_codes, list_ids, probe_lists, lut, bias, k: int, select_min: bool,
                 split: bool = False, list_consts=None, keep_words=None):
    """The k best scores of every slot of the lists each query probes, and
    their ids: (values (T, k) float32, ids (T, k) int32), best first.

    ``list_codes`` (n_lists, cap, S) uint8 and ``list_ids`` (n_lists, cap)
    int32 as the index stores them; ``probe_lists`` (T, pc) int32;
    ``lut`` (T, pc, S, K) float32 or bfloat16 (K as in :func:`pq_scan`);
    ``bias`` (T, pc) float32; ``list_consts`` (n_lists, cap) float32, added
    for split pq8 under L2, else None; ``keep_words`` (words,) int32, the
    filter's bitset (:func:`pack_keep_words`), or None; an id past its last
    word is not kept. Score = (scan + bias) + const; slots with ``list_ids < 0`` or whose
    id's keep bit is clear score +inf (``select_min``) or -inf. Ranked as
    :func:`~raft_tpu_torch.ops.topk.topk` ranks, equal scores to the lowest
    flat position ``p * cap + j``; a query with fewer than k filled slots
    gets ±inf and id -1 in the rest. k <= 256. A CUDA tensor launches the
    kernel; a CPU tensor runs :func:`pq_scan_topk_plain`.
    """
    _check_topk(list_codes, list_ids, probe_lists, lut, bias, k, split, list_consts,
                keep_words)
    if lut.device.type == "cpu":
        return pq_scan_topk_plain(list_codes, list_ids, probe_lists, lut, bias, k,
                                  select_min, split, list_consts, keep_words)
    expects(lut.device.type == "cuda", "pq_scan_topk runs on cuda or cpu tensors, got %s",
            lut.device)
    return _launch_topk(list_codes, list_ids, probe_lists, lut, bias, int(k),
                        bool(select_min), bool(split), list_consts, keep_words)


pq_scan_topk.launches = 0
