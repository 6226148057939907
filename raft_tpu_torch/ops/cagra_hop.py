"""CAGRA beam hop: the ``cagra_hop`` kernel and its plain version.

Counterpart of raft_tpu/ops/cagra_hop.py (``cagra_hop``, the Pallas kernel
behind ``SearchParams(hop_impl="fused*")``). One call updates the beam of
every query row of a search batch by one hop: it scores the row's ``cw``
candidates by the direct ``||v - q||^2`` in float32, scores +inf where the
id is negative or ``valid`` is 0, merges them into the 128-lane beam
(``extract``: itopk passes of minimum extraction over [beam | candidates]
after dropping candidates already in the beam; ``arena``: gated insertion
over the arena's worst entry), and takes ``width`` picks of the best
unvisited lanes < itopk. Ties go to the lowest id throughout; the rules are
the JAX kernel's, stated in ``csrc/cagra_hop.cu``'s header.

One departure from ``cagra_hop``'s arguments: where it takes the candidate
rows pre-gathered, (m, cw, d), this takes the ``dataset`` (n, d) float32 or
int8 in the same position, and the kernel reads each candidate's row by id.
``merge="arena_smem"`` (the TPU kernel's SMEM-gated variant, with the same
insertion rules) runs ``arena``; ``profile`` carve-outs other than "full"
are TPU profiling aids and are not ported.

Summation order. :func:`cagra_hop_plain` sums as the kernel does: the dims
are dealt to 32 lanes in runs of 4 (lane l owns dims c*128 + 4l .. +3 for
c = 0, 1, ...), each lane adds its squared differences in increasing dim
order, and the 32 lane sums are added as a halving tree (16, 8, 4, 2, 1).
The kernel rounds every subtraction, product and sum on its own (no FMA),
so on the card the two agree bit for bit in every output.

:func:`cagra_hop` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback from one to the other.
``cagra_hop.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..core.errors import expects
from ._build import count_launch

__all__ = ["cagra_hop", "cagra_hop_plain", "hop_shapes_eligible", "MAX_D", "POOL"]

POOL = 128                    # beam lanes: itopk + width * degree must fit
_BIG = 1 << 30
_NEG = -3.0e38
_MERGES = {"extract": 0, "arena": 1, "arena_smem": 1}
_DATA_CODE = {torch.float32: 0, torch.int8: 1}
_WARPS = 4                    # query rows per block (csrc/cagra_hop.cu)
_MAX_SMEM = 232448            # shared memory a block can use (H100)
# widest d whose zero-padded query rows (4 per block, float32) fit a
# block's shared memory beside the 4 KB of candidate arrays
MAX_D = (_MAX_SMEM - _WARPS * POOL * 8) // (_WARPS * 4) // 128 * 128


def hop_shapes_eligible(itopk: int, deg: int, width: int, d: int) -> bool:
    """Whether the kernel takes the shape: the merge pool (itopk beam lanes
    plus width * deg candidates) fits the 128 lanes, and d <= :data:`MAX_D`,
    the kernel's shared-memory limit per block (it replaces the TPU kernel's
    VMEM budget)."""
    return (width >= 1 and itopk >= 1 and d >= 1
            and itopk + width * deg <= POOL and d <= MAX_D)


def _check(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, itopk, width,
           merge, profile):
    expects(merge in _MERGES,
            "merge must be 'extract', 'arena' or 'arena_smem', got %r", merge)
    expects(profile == "full", "cagra_hop: profile=%r is not yet ported "
            "(the TPU kernel's profiling carve-outs)", profile)
    expects(queries.ndim == 2 and queries.dtype == torch.float32,
            "cagra_hop: queries must be (m, d) float32, got %s %s",
            tuple(queries.shape), queries.dtype)
    m, d = queries.shape
    expects(dataset.ndim == 2 and dataset.shape[1] == d and dataset.dtype in _DATA_CODE,
            "cagra_hop: dataset must be (n, d=%d) float32 or int8, got %s %s",
            d, tuple(dataset.shape), dataset.dtype)
    for t, dt, name in ((beam_d, torch.float32, "beam_d"), (beam_i, torch.int32, "beam_i"),
                        (beam_v, torch.int32, "beam_v")):
        expects(tuple(t.shape) == (m, POOL) and t.dtype == dt,
                "cagra_hop: %s must be (m=%d, %d) %s, got %s %s",
                name, m, POOL, dt, tuple(t.shape), t.dtype)
    expects(nbrs.ndim == 2 and nbrs.shape[0] == m and nbrs.dtype == torch.int32,
            "cagra_hop: nbrs must be (m=%d, cw) int32, got %s %s",
            m, tuple(nbrs.shape), nbrs.dtype)
    expects(valid.shape == nbrs.shape and valid.dtype == torch.int32,
            "cagra_hop: valid must be %s int32, got %s %s",
            tuple(nbrs.shape), tuple(valid.shape), valid.dtype)
    cw = nbrs.shape[1]
    expects(itopk >= 1 and cw >= 1 and itopk + cw <= POOL and width >= 1,
            "cagra_hop needs 1 <= itopk, 1 <= cw, itopk + cw <= %d and width >= 1; "
            "got itopk=%d cw=%d width=%d", POOL, itopk, cw, width)
    devs = {t.device for t in (queries, beam_d, beam_i, beam_v, nbrs, dataset, valid)}
    expects(len(devs) == 1, "cagra_hop: all tensors must be on one device, got %s",
            sorted(map(str, devs)))
    return m, d, cw


def _scores(queries, nbrs, dataset, valid):
    """(m, cw) float32 ||v - q||^2 in the kernel's order; +inf where masked."""
    m, d = queries.shape
    cw = nbrs.shape[1]
    ok = (nbrs >= 0) & (valid > 0)
    rows = dataset[nbrs.to(torch.int64).clamp_min(0)].to(torch.float32)   # (m, cw, d)
    diff = rows - queries[:, None, :]
    sq = diff * diff
    dp = -(-d // 128) * 128
    if dp > d:
        sq = F.pad(sq, (0, dp - d))          # adds +0: leaves a lane sum as it is
    sq = sq.reshape(m, cw, dp // 128, 32, 4)
    acc = torch.zeros((m, cw, 32), dtype=torch.float32, device=queries.device)
    for c in range(dp // 128):
        for t in range(4):
            acc = acc + sq[:, :, c, :, t]
    for h in (16, 8, 4, 2, 1):
        acc = acc[..., :h] + acc[..., h:2 * h]
    return torch.where(ok, acc[..., 0], math.inf)


def _merge_extract(bd, bi, bv, nd, nbrs, itopk):
    m, cw = nbrs.shape
    nd = torch.where((nbrs[:, :, None] == bi[:, None, :itopk]).any(-1), math.inf, nd)
    pad = POOL - itopk - cw
    dev = bd.device
    pd = torch.cat([bd[:, :itopk], nd,
                    torch.full((m, pad), math.inf, dtype=torch.float32, device=dev)], 1)
    pi = torch.cat([bi[:, :itopk], nbrs,
                    torch.full((m, pad), -1, dtype=torch.int32, device=dev)], 1)
    pv = torch.cat([bv[:, :itopk], torch.zeros_like(nbrs),
                    torch.ones((m, pad), dtype=torch.int32, device=dev)], 1)
    od = torch.full((m, POOL), math.inf, dtype=torch.float32, device=dev)
    oi = torch.full((m, POOL), -1, dtype=torch.int32, device=dev)
    ov = torch.ones((m, POOL), dtype=torch.int32, device=dev)
    for t in range(itopk):
        mn = pd.min(dim=1, keepdim=True).values
        sel = pd <= mn
        amid = torch.where(sel, pi, _BIG).min(dim=1, keepdim=True).values
        wv = torch.where((pi == amid) & sel, pv, _BIG).min(dim=1).values
        od[:, t] = mn[:, 0]
        oi[:, t] = torch.where(mn[:, 0] < math.inf, amid[:, 0], -1)
        ov[:, t] = wv.clamp_max(1)
        pd = torch.where(pi == amid, math.inf, pd)
    return od, oi, ov


def _merge_arena(bd, bi, bv, nd, nbrs, itopk):
    od, oi, ov = bd.clone(), bi.clone(), bv.clone()
    lane = torch.arange(POOL, device=bd.device)
    in_arena = lane < itopk
    cd = nd
    for _ in range(nbrs.shape[1]):
        admask = torch.where(in_arena, od, _NEG)
        worst = admask.max(dim=1, keepdim=True).values
        best = cd.min(dim=1, keepdim=True).values
        improve = best < worst                # a row whose gate closed stays as it is
        bid = torch.where(cd <= best, nbrs, _BIG).min(dim=1, keepdim=True).values
        dup = ((oi == bid) & in_arena).any(dim=1, keepdim=True)
        wlane = torch.where(admask >= worst, lane, -1).max(dim=1, keepdim=True).values
        at = improve & ~dup & (lane == wlane)
        od = torch.where(at, best, od)
        oi = torch.where(at, bid, oi)
        ov = torch.where(at, 0, ov)
        cd = torch.where(improve & (nbrs == bid), math.inf, cd)
    return od, oi, ov


def _emit_pick(od, oi, ov, itopk, width):
    m = od.shape[0]
    lane = torch.arange(POOL, device=od.device)
    pick = torch.empty((m, width), dtype=torch.int32, device=od.device)
    nocand = torch.empty((m, width), dtype=torch.int32, device=od.device)
    for w in range(width):
        cd = torch.where((ov > 0) | (lane >= itopk), math.inf, od)
        mn = cd.min(dim=1, keepdim=True).values
        nc = mn >= math.inf
        pid = torch.where(cd <= mn, oi, _BIG).min(dim=1, keepdim=True).values
        ov = torch.where((oi == pid) & ~nc, 1, ov)
        pick[:, w] = pid[:, 0].clamp(0, _BIG)
        nocand[:, w] = nc[:, 0].to(torch.int32)
    return ov, pick, nocand


def cagra_hop_plain(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, itopk: int,
                    width: int = 1, merge: str = "extract", profile: str = "full"):
    """Plain PyTorch version of the ``cagra_hop`` kernel: the same arguments,
    the same outputs, on any device. Candidate ids must be below n."""
    _check(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, itopk, width,
           merge, profile)
    nd = _scores(queries, nbrs, dataset, valid)
    fn = _merge_extract if merge == "extract" else _merge_arena
    od, oi, ov = fn(beam_d, beam_i, beam_v, nd, nbrs, int(itopk))
    ov, pick, nocand = _emit_pick(od, oi, ov, int(itopk), int(width))
    return od, oi, ov, pick, nocand


def _launch(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, itopk, width, merge):
    from ._build import load

    for t, name in ((queries, "queries"), (beam_d, "beam_d"), (beam_i, "beam_i"),
                    (beam_v, "beam_v"), (nbrs, "nbrs"), (dataset, "dataset"),
                    (valid, "valid")):
        expects(t.is_contiguous(), "cagra_hop: %s must be contiguous", name)
    m, d = queries.shape
    n, cw = dataset.shape[0], nbrs.shape[1]
    expects(m >= 1 and n >= 1, "cagra_hop needs queries and dataset rows")
    expects(n < 2 ** 31, "cagra_hop: n=%d rows exceed int32 ids", n)
    expects(d <= MAX_D, "cagra_hop: d=%d exceeds the kernel's shared-memory limit %d",
            d, MAX_D)
    lib = load("cagra_hop")
    fn = lib.cagra_hop_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    dev = queries.device
    od = torch.empty((m, POOL), dtype=torch.float32, device=dev)
    oi = torch.empty((m, POOL), dtype=torch.int32, device=dev)
    ov = torch.empty((m, POOL), dtype=torch.int32, device=dev)
    pick = torch.empty((m, width), dtype=torch.int32, device=dev)
    nocand = torch.empty((m, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DATA_CODE[dataset.dtype], queries.data_ptr(), dataset.data_ptr(), m, n, d,
                 beam_d.data_ptr(), beam_i.data_ptr(), beam_v.data_ptr(), nbrs.data_ptr(),
                 valid.data_ptr(), cw, itopk, width, _MERGES[merge], od.data_ptr(),
                 oi.data_ptr(), ov.data_ptr(), pick.data_ptr(), nocand.data_ptr(), stream)
    count_launch(cagra_hop)
    expects(err == 0, "cagra_hop kernel launch failed: cudaError %d", err)
    return od, oi, ov, pick, nocand


def cagra_hop(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, itopk: int,
              width: int = 1, merge: str = "extract", profile: str = "full"):
    """One CAGRA hop over the whole query batch.

    ``queries`` (m, d) float32; ``beam_d`` / ``beam_i`` / ``beam_v`` (m, 128)
    float32 / int32 / int32, the padded beam (lanes >= itopk hold +inf / -1 /
    1); ``nbrs`` (m, cw) int32 candidate ids (-1: none, all below n);
    ``dataset`` (n, d) float32 or int8, whose rows the candidates name;
    ``valid`` (m, cw) int32, 0 masks a candidate (all zero primes the loop);
    ``merge`` "extract", "arena" or "arena_smem" (runs "arena").

    Returns (beam_d, beam_i, beam_v, pick (m, width) int32 clipped to
    [0, 2^30], no_cand (m, width) int32). Beam distances are the full
    ``||v - q||^2``. A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`cagra_hop_plain`.
    """
    _check(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, itopk, width,
           merge, profile)
    if queries.device.type == "cpu":
        return cagra_hop_plain(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid,
                               itopk, width, merge)
    expects(queries.device.type == "cuda", "cagra_hop runs on cuda or cpu tensors, got %s",
            queries.device)
    return _launch(queries, beam_d, beam_i, beam_v, nbrs, dataset, valid, int(itopk),
                   int(width), merge)


cagra_hop.launches = 0
