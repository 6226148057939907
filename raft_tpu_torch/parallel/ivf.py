"""Multi-device IVF: distributed BUILD (no rank ever trains on, or holds the
rows of, another rank's block) and distributed SEARCH (the inverted lists
split over the ranks, probed locally, candidates merged).

Counterpart of raft_tpu/parallel/ivf.py. The reference leaves multi-GPU ANN
serving to users composing raft::comms with per-shard indexes and
knn_merge_parts. Both halves are first-class drivers here:

- **build / build_pq / extend**: the dataset's rows split over the ranks;
  coarse centers by the psum-EM balanced k-means (every rank assigns its
  block, the center sums and counts are all-reduced, balancing re-seeds
  come from a pooled all-gathered subsample, so every rank computes the
  same centers); every per-row step (assignment, residual encode, norms)
  runs on the rank's block; the padded lists are filled one list block (L/S
  lists) at a time: each rank scatters its rows into the block, the block
  is all-reduced and its owner keeps it. The owners' blocks are then
  all-gathered, so every rank returns the whole index (the JAX package
  returns an array sharded by lists; an eager rank holds what it returns).
- **search / search_pq**: each rank takes its L/S lists (and their
  centers), ranks its own centers and scans its own top ``n_probes`` lists,
  then one all-gather + ``_select_k`` merge gives the global result. Each
  rank's scan work is the same, and the probed lists number S x
  ``n_probes``. A rank's slice of an index is memoized on its device for as
  long as the index lives unchanged (:mod:`._progcache`).

The local searches are the single-device ones (``ivf_flat._ivf_search``:
the ``topk`` kernel takes its chunk selects on the card;
``ivf_pq._pq_search``: ``pq_scan_topk``), so the kernels run through here.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..comms.comms import Comms
from ..core import tracing
from ..core.errors import expects
from ..distance.pairwise import full_f32
from ..distance.types import DistanceType
from ..matrix.select_k import _select_k
from ..neighbors.ivf_flat import IvfFlatIndex, SearchParams, _ivf_search
from ..obs.instrument import instrument, nrows
from ._progcache import ProgramCache, memo
from .kmeans import _counts, onehot_sums, rank_generator

__all__ = ["build", "build_pq", "extend", "search", "search_pq"]

# the ranks' memoized index slices, releasable per communicator
# (parallel.release_programs)
_PROGRAMS = ProgramCache(maxsize=256)


def _cat_pad(a, pad: int, fill):
    """``a`` with ``pad`` rows of ``fill`` appended along dim 0."""
    tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, tail])


def _pad_lists_to_multiple(index: IvfFlatIndex, size: int) -> IvfFlatIndex:
    """Pad the index with empty lists so n_lists divides the ranks (sub-list
    splitting makes n_lists data-dependent). Padding centers sit at +1e30 so
    L2 coarse scores rank them last; even probed, their slots are all id -1
    / +inf and cannot win the merge. Inner product has no constant
    worst-ranked center (the sign of q·c depends on q), so there the list
    count must already divide."""
    L = index.n_lists
    pad = (-L) % size
    if pad == 0:
        return index
    expects(
        index.metric != DistanceType.InnerProduct,
        "inner-product distributed search needs n_lists (%d) divisible by the "
        "mesh axis (%d) — rebuild with a different n_lists",
        L, size,
    )
    return IvfFlatIndex(
        centers=_cat_pad(index.centers, pad, 1e30),
        list_data=_cat_pad(index.list_data, pad, 0),
        list_ids=_cat_pad(index.list_ids, pad, -1),
        list_norms=_cat_pad(index.list_norms, pad, math.inf),
        list_sizes=_cat_pad(index.list_sizes, pad, 0),
        metric=index.metric,
        split_factor=index.split_factor,
        data_kind=index.data_kind,
    )


def _rank_lists(comms: Comms, a):
    """This rank's block of a list-major array, on its device."""
    b = a.shape[0] // comms.size()
    lo = comms.rank() * b
    return comms.put(a[lo:lo + b]).contiguous()


def _merge(comms: Comms, d_loc, i_loc, k: int, inner: bool):
    with tracing.range("parallel.ivf.merge"):
        d_all = comms.allgather(d_loc)               # (S, m, k)
        i_all = comms.allgather(i_loc)
        m, size = d_loc.shape[0], comms.size()
        d_flat = d_all.movedim(0, 1).reshape(m, size * k)
        i_flat = i_all.movedim(0, 1).reshape(m, size * k)
        return _select_k(d_flat, i_flat, k, not inner)


def _flat_shard(comms: Comms, index: IvfFlatIndex) -> IvfFlatIndex:
    index = _pad_lists_to_multiple(index, comms.size())
    return IvfFlatIndex(*(_rank_lists(comms, a) for a in (
        index.centers, index.list_data, index.list_ids, index.list_norms, index.list_sizes)),
        metric=index.metric, split_factor=index.split_factor, data_kind=index.data_kind)


@instrument("parallel.ivf.search",
            items=lambda a, kw: nrows(a[3] if len(a) > 3 else kw["queries"]),
            labels=lambda a, kw: {"k": a[4] if len(a) > 4 else kw["k"],
                                  "size": (a[0] if a else kw["comms"]).size()})
def search(comms: Comms, params: SearchParams, index: IvfFlatIndex, queries, k: int):
    """Distributed IVF-Flat search (multi-device analogue of ivf_flat.search).

    Every rank calls with the whole ``index``; rank r probes its own
    ``n_probes`` best lists of the r-th block of L/S, and the candidates
    merge with one all-gather + select. With L lists over S ranks each rank
    scans n_probes of its L/S lists, so S x n_probes lists are probed in
    all: recall can only exceed the single-device setting at equal
    ``n_probes``.

    Returns (distances (m, k), global ids (m, k)), equal on every rank.
    """
    from ..core.resources import Resources
    from ..neighbors.brute_force import _coerce_queries
    from ..neighbors.ivf_flat import search_plan

    shard = memo(_PROGRAMS, comms, "flat", index, lambda: _flat_shard(comms, index))
    queries = _coerce_queries(index.data_kind, comms.put(queries))
    n_probes = min(params.n_probes, shard.n_lists)
    expects(0 < k <= n_probes * index.capacity, "k exceeds per-shard candidate pool")
    # the single-device search's tile plan over the rank's lists (the JAX
    # driver fixes 256-query tiles of every probe: its gathered lists would
    # outgrow the card's memory at a large capacity)
    query_tile, probe_chunk = search_plan(shard, queries.shape[0], n_probes, int(k),
                                          Resources(device=comms.device))
    with tracing.range("parallel.ivf.local_search"):
        d_loc, i_loc = _ivf_search(shard, queries, n_probes, int(k), query_tile, probe_chunk)
    return _merge(comms, d_loc, i_loc, int(k), index.metric == DistanceType.InnerProduct)


def _pad_pq_lists(index, size: int):
    """Pad an IvfPqIndex with empty lists so n_lists divides the ranks (the
    trick of _pad_lists_to_multiple: far-away centers rank last in the L2
    coarse scoring; padded lists are size 0 so their slots never win)."""
    from ..neighbors.ivf_pq import IvfPqIndex

    L = index.n_lists
    pad = (-L) % size
    if pad == 0:
        return index
    expects(
        index.metric != DistanceType.InnerProduct,
        "inner-product distributed search needs n_lists (%d) divisible by the "
        "mesh axis (%d) — rebuild with a different n_lists",
        L, size,
    )
    far = 1e15
    codebooks = index.codebooks
    if index.codebook_kind == "per_cluster":
        codebooks = _cat_pad(codebooks, pad, 0)
    return IvfPqIndex(
        centers=_cat_pad(index.centers, pad, far),
        centers_rot=_cat_pad(index.centers_rot, pad, far),
        rotation=index.rotation,
        codebooks=codebooks,
        list_codes=_cat_pad(index.list_codes, pad, 0),
        list_ids=_cat_pad(index.list_ids, pad, -1),
        list_sizes=_cat_pad(index.list_sizes, pad, 0),
        list_consts=_cat_pad(index.list_consts, pad, 0),
        metric=index.metric,
        codebook_kind=index.codebook_kind,
        pq_bits=index.pq_bits,
        split_factor=index.split_factor,
        pq_split=index.pq_split,
        data_kind=index.data_kind,
    )


def _pq_shard(comms: Comms, index):
    from ..neighbors.ivf_pq import IvfPqIndex

    index = _pad_pq_lists(index, comms.size())
    per_cluster = index.codebook_kind == "per_cluster"
    return IvfPqIndex(
        _rank_lists(comms, index.centers), _rank_lists(comms, index.centers_rot),
        comms.put(index.rotation),
        _rank_lists(comms, index.codebooks) if per_cluster else comms.put(index.codebooks),
        _rank_lists(comms, index.list_codes), _rank_lists(comms, index.list_ids),
        _rank_lists(comms, index.list_sizes), list_consts=_rank_lists(comms, index.list_consts),
        metric=index.metric, codebook_kind=index.codebook_kind, pq_bits=index.pq_bits,
        split_factor=index.split_factor, pq_split=index.pq_split)


@instrument("parallel.ivf.search_pq",
            items=lambda a, kw: nrows(a[3] if len(a) > 3 else kw["queries"]),
            labels=lambda a, kw: {"k": a[4] if len(a) > 4 else kw["k"],
                                  "size": (a[0] if a else kw["comms"]).size()})
def search_pq(comms: Comms, params, index, queries, k: int, res=None):
    """Distributed IVF-PQ search: the lists split over the ranks, local LUT
    scans (``pq_scan_topk`` on the card), one all-gather + select merge (the
    composition of :func:`search`).

    ``params`` is :class:`raft_tpu_torch.neighbors.ivf_pq.SearchParams`.
    Distances are PQ-approximate, like the single-device search; run
    :func:`raft_tpu_torch.neighbors.refine.refine` against the dataset to
    sharpen the candidates. ``res`` sizes the scan's workspace.

    Returns (distances (m, k), global ids (m, k)), equal on every rank.
    """
    from ..core.resources import default_resources
    from ..neighbors._list_utils import plan_search_tiles, pq_scan_bytes_per_probe_row
    from ..neighbors.brute_force import _coerce_queries
    from ..neighbors.ivf_pq import _SELECT_IMPLS, _check_split_consts, _pq_search, \
        resolve_scan_impl

    res = res or default_resources()
    _check_split_consts(index)
    expects(not index.scale_normed,
            "distributed PQ search does not shard list_scales yet; a "
            "residual_scale_norm index is single-device only")
    expects(params.scan_order in ("auto", "tiled"),
            "the distributed search runs the tiled scan order; "
            "scan_order=%r is single-device only", params.scan_order)
    expects(params.lut_dtype in ("float32", "bfloat16", "int8"),
            "lut_dtype must be 'float32', 'bfloat16' or 'int8', got %r",
            params.lut_dtype)
    shard = memo(_PROGRAMS, comms, "pq", index, lambda: _pq_shard(comms, index))
    queries = _coerce_queries(index.data_kind, comms.put(queries))
    n_probes = min(params.n_probes, shard.n_lists)
    expects(0 < k <= n_probes * index.capacity, "k exceeds per-shard candidate pool")
    # the single-device search's workspace model, with the rank's n_probes
    n_codes = index.codebooks.shape[-2]
    query_tile, probe_chunk = plan_search_tiles(
        queries.shape[0], n_probes, int(k), index.capacity,
        bytes_per_probe_row=pq_scan_bytes_per_probe_row(index.capacity, index.pq_dim, n_codes),
        budget_bytes=res.workspace_bytes, max_query_tile=128)
    scan_impl = resolve_scan_impl(params, index, n_codes)
    with tracing.range("parallel.ivf.local_search_pq"):
        d_loc, i_loc = _pq_search(shard, queries, n_probes, int(k), query_tile, probe_chunk,
                                  params.lut_dtype, scan_impl,
                                  _SELECT_IMPLS[params.select_impl])
    return _merge(comms, d_loc, i_loc, int(k), index.metric == DistanceType.InnerProduct)


# ---------------------------------------------------------------------------
# distributed build / extend
# ---------------------------------------------------------------------------
#
#   phase 1: balanced psum-EM: per-rank fused 1-NN assignment, all-reduced
#     center sums and counts, balancing re-seeds drawn from a pooled
#     (all-gathered) subsample, so every rank computes the SAME centers;
#     gives the centers, this rank's labels and the global counts.
#   phase 2 (host): the capacity from the global counts (no sub-list
#     splitting in the distributed build: balanced k-means bounds the skew).
#   phase 3: the padded lists, one list block (L/S lists) at a time:
#     cross-rank write positions from an exclusive prefix over the
#     all-gathered per-rank list counts; each block is scattered into,
#     all-reduced and kept by its owner, so a rank's working set is one
#     block; the owners' blocks are then all-gathered.


def _pooled_balanced_centers(comms: Comms, x_shard, g_rank, g_all, L: int, n_iters: int,
                             small_ratio: float, n_global: int, sub: int, inner: bool,
                             tile: int, batch_shard: int = 0):
    """Distributed balanced EM. Returns (centers, this rank's labels, global
    counts), the centers and counts equal on every rank: the replicated
    math consumes identical inputs (the all-gathered pool, the all-reduced
    statistics) and draws from ``g_all``, seeded alike on every rank;
    ``g_rank`` is the rank's own stream (its subsample and shuffle).

    ``batch_shard > 0`` selects mini-batch EM: each iteration assigns one
    rotating ``batch_shard``-row mini-batch a rank (a fixed per-rank
    shuffle), the all-reduced batch sums and counts drive the streaming 1/c
    center update, and the balancing re-seed runs on the batch counts
    against the batch-scaled threshold; the two closing full passes
    (sharpening, list-fill labels) follow either way."""
    from ..cluster.kmeans_balanced import _assign_labels, _choice, _reseed_small

    dev = x_shard.device
    xf = x_shard.to(torch.float32)
    shard_rows = x_shard.shape[0]
    idx = _choice(g_rank, shard_rows, sub, dev)
    pool = comms.allgather(xf[idx], tiled=True)                   # (S*sub, d)
    centers = pool[_choice(g_all, pool.shape[0], L, dev)]
    ptile = min(tile, pool.shape[0])
    S = comms.size()

    if batch_shard:
        perm = torch.randperm(shard_rows, generator=g_rank, device=dev)
        offs = torch.arange(batch_shard, device=dev)
        ccounts = torch.zeros((L,), dtype=torch.float32, device=dev)
        for i in range(n_iters):
            xb = xf[perm[(i * batch_shard + offs) % shard_rows]]
            labels = _assign_labels(xb, centers, min(tile, batch_shard), inner)
            sums = comms.allreduce(onehot_sums(labels, xb, L))
            counts = comms.allreduce(_counts(labels, L))
            ccounts = ccounts + counts
            # the streaming 1/c mean update; a zero-count row is a no-op
            centers = centers + (sums - counts[:, None] * centers) / torch.clamp_min(
                ccounts, 1.0)[:, None]
            pool_w = counts[_assign_labels(pool, centers, ptile, inner).to(torch.int64)]
            centers, small = _reseed_small(centers, counts, pool_w, pool, g_all, L,
                                           batch_shard * S / L, small_ratio)
            # re-seeded centers forget their history
            ccounts = torch.where(small, 0.0, ccounts)
    else:
        for _ in range(n_iters):
            labels = _assign_labels(x_shard, centers, tile, inner)
            sums = comms.allreduce(onehot_sums(labels, xf, L))
            counts = comms.allreduce(_counts(labels, L))
            centers = torch.where(counts[:, None] > 0,
                                  sums / torch.clamp_min(counts, 1.0)[:, None], centers)
            pool_w = counts[_assign_labels(pool, centers, ptile, inner).to(torch.int64)]
            centers, _ = _reseed_small(centers, counts, pool_w, pool, g_all, L,
                                       n_global / L, small_ratio)
    # a closing sharpening pass without balancing, so centers are true means
    labels = _assign_labels(x_shard, centers, tile, inner)
    sums = comms.allreduce(onehot_sums(labels, xf, L))
    counts = comms.allreduce(_counts(labels, L))
    centers = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[:, None], centers)
    labels = _assign_labels(x_shard, centers, tile, inner)
    gcounts = comms.allreduce(torch.bincount(labels.to(torch.int64), minlength=L))
    return centers, labels.to(torch.int32), gcounts.to(torch.int32)


def _global_positions(comms: Comms, labels, L: int, base=None):
    """Write position of each local row inside its global list: the
    exclusive prefix of the all-gathered per-rank list counts + the row's
    rank within its list on this rank (+ a per-list ``base``, for
    extend)."""
    from ..neighbors._list_utils import list_positions

    lab = labels.to(torch.int64)
    lc = torch.bincount(lab, minlength=L)
    all_counts = comms.allgather(lc)                                # (S, L)
    offs = torch.cumsum(all_counts, dim=0) - all_counts
    my_off = offs[comms.rank()]
    pos, _ = list_positions(labels, L)
    gpos = my_off[lab].to(torch.int32) + pos.to(torch.int32)
    if base is not None:
        gpos = gpos + base[lab].to(torch.int32)
    return gpos


def _fill_blocks(comms: Comms, payloads, labels, gpos, L: int, cap: int):
    """The padded list arrays, one list block at a time. ``payloads``: a list
    of (values (n_rank, ...), scatter dtype). Returns this rank's
    (L/S, cap, ...) block of each payload; its working set is one block a
    payload."""
    S = comms.size()
    Lb = L // S
    lab = labels.to(torch.int64)
    p = gpos.to(torch.int64)
    out = [None] * len(payloads)
    for b in range(S):
        rows = ((lab >= b * Lb) & (lab < (b + 1) * Lb)).nonzero().flatten()
        for j, (vals, dt) in enumerate(payloads):
            blk = torch.zeros((Lb, cap) + tuple(vals.shape[1:]), dtype=dt, device=vals.device)
            blk[lab[rows] - b * Lb, p[rows]] = vals[rows].to(dt)
            blk = comms.allreduce(blk)
            if b == comms.rank():
                out[j] = blk
    return out


def _gather_lists(comms: Comms, *blocks):
    """The owners' list blocks all-gathered into the global arrays."""
    return [comms.allgather(b, tiled=True) for b in blocks]


def _build_capacity(gcounts, extra=0) -> int:
    from ..neighbors._list_utils import round_up

    return round_up(max(int(np.asarray(gcounts.cpu() if isinstance(gcounts, torch.Tensor)
                                       else gcounts).max()) + extra, 8), 8)


def _resolve_batch_shard(params, n: int, S: int, shard_rows: int) -> int:
    """Per-rank mini-batch rows for the coarse psum-EM (0 = full EM). The
    mode and threshold rule is the single-device trainer's applied to the
    GLOBAL row count: the distributed build trains on every row, there is
    no trainset-fraction subsample here."""
    from ..cluster.kmeans_balanced import resolve_train_mode

    mode = resolve_train_mode(
        getattr(params, "kmeans_train_mode", "auto"), n,
        getattr(params, "kmeans_batch_rows", 65536))
    if mode != "minibatch":
        return 0
    batch_rows = getattr(params, "kmeans_batch_rows", 65536)
    return min(shard_rows, max(batch_rows // S, 1))


def _timed_coarse_em(fn, n_iters: int, batch_shard: int, S: int, n: int):
    """Run the coarse-EM phase with the shared build metrics (the
    assignment-pass counter, the sampled-rows gauge, the phase wall: the
    raft_tpu_build_* series of the single-device trainer, labeled
    driver="distributed")."""
    from ..obs import build as build_metrics
    from ..obs import metrics

    if not metrics._enabled:
        return fn()
    mode = "minibatch" if batch_shard else "full"
    t0 = time.perf_counter()
    out = fn()
    if out[0].is_cuda:
        torch.cuda.synchronize(out[0].device)
    build_metrics.build_phase().observe(time.perf_counter() - t0,
                                        phase="parallel.ivf/coarse_em")
    build_metrics.assignment_passes().inc(n_iters, phase="em", mode=mode,
                                          driver="distributed")
    # the two closing full passes, under the single-device driver's labels
    # (final = sharpening, fill = list-fill assignment)
    build_metrics.assignment_passes().inc(1, phase="final", mode=mode, driver="distributed")
    build_metrics.assignment_passes().inc(1, phase="fill", mode=mode, driver="distributed")
    build_metrics.sampled_rows().set(batch_shard * S if batch_shard else n, mode=mode,
                                     driver="distributed")
    return out


def _rank_rows(comms: Comms, x):
    """(this rank's block of rows on its device, its first global row)."""
    n = int(x.shape[0])
    S = comms.size()
    expects(n % S == 0, "dataset rows (%d) must divide the mesh axis (%d); pad first", n, S)
    rows = n // S
    lo = comms.rank() * rows
    return comms.put(x[lo:lo + rows]), lo


def _coarse(comms: Comms, params, x_shard, n: int, L: int, inner: bool, what: str):
    """Phase 1 of a build: the psum-EM coarse centers (seeded by
    ``params.seed``, every rank's subsample by ``(seed, rank)``)."""
    from ..distance.pairwise import _choose_tile

    S = comms.size()
    shard_rows = x_shard.shape[0]
    sub = min(max(8 * L // S, 64), shard_rows)
    tile = _choose_tile(shard_rows, L, 1, 1 << 28)
    batch_shard = _resolve_batch_shard(params, n, S, shard_rows)
    dev = x_shard.device
    g_rank = rank_generator(params.seed, comms.rank(), dev)
    g_all = torch.Generator(device=dev).manual_seed(int(params.seed))
    with tracing.range(f"parallel.ivf.{what}.coarse_kmeans"):
        out = _timed_coarse_em(lambda: _pooled_balanced_centers(
            comms, x_shard, g_rank, g_all, L, params.kmeans_n_iters, 0.25, n, sub, inner,
            tile, batch_shard=batch_shard), params.kmeans_n_iters, batch_shard, S, n)
    return out, g_rank


def _fill_flat(comms: Comms, xf, labels, ids, L: int, cap: int, base=None):
    """Phase 3 of the flat build: this rank's blocks of (rows as float32,
    ids with -1 for empty slots, norms with +inf for empty slots)."""
    gpos = _global_positions(comms, labels, L, base=base)
    data, idb, nrm = _fill_blocks(
        comms, [(xf, torch.float32), (ids + 1, torch.int32),
                ((xf * xf).sum(dim=1), torch.float32)], labels, gpos, L, cap)
    idb = idb - 1      # 0 (the sum's identity) back to the -1 empty sentinel
    return data, idb, torch.where(idb < 0, math.inf, nrm)


@instrument("parallel.ivf.build",
            items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["dataset"]),
            labels=lambda a, kw: {"size": (a[0] if a else kw["comms"]).size()})
def build(comms: Comms, params, dataset, res=None) -> IvfFlatIndex:
    """Distributed IVF-Flat build: the dataset's rows split over
    ``comms.axis``, the lists laid out as :func:`search` splits them.
    ``params`` is :class:`raft_tpu_torch.neighbors.ivf_flat.IndexParams`
    (``list_dtype`` honoured, int8 / uint8 ingestion included;
    ``split_factor`` is carried but the distributed build does not split
    hot lists). Every rank calls with the global dataset and returns the
    whole index."""
    from ..distance.types import resolve_metric
    from ..neighbors.ivf_flat import _resolve_storage

    expects(dataset.ndim == 2, "dataset must be (n, d)")
    n = int(dataset.shape[0])
    S = comms.size()
    L = params.n_lists
    x_shard, lo = _rank_rows(comms, dataset)
    expects(L % S == 0, "n_lists (%d) must divide the mesh axis (%d)", L, S)
    expects(L <= n, "n_lists > n_samples")
    mt = resolve_metric(params.metric)
    kind, x_shard, xf = _resolve_storage(params.list_dtype, x_shard, mt)
    storage = x_shard.dtype
    (centers, labels, gcounts), _ = _coarse(comms, params, x_shard, n, L,
                                            mt == DistanceType.InnerProduct, "build")
    cap = _build_capacity(gcounts)
    ids = torch.arange(lo, lo + x_shard.shape[0], dtype=torch.int32, device=xf.device)
    with tracing.range("parallel.ivf.build.fill_lists"):
        data, idb, nrm = _fill_flat(comms, xf, labels, ids, L, cap)
        data, idb, nrm = _gather_lists(comms, data.to(storage), idb, nrm)
    return IvfFlatIndex(centers=centers, list_data=data, list_ids=idb, list_norms=nrm,
                        list_sizes=gcounts, metric=mt, split_factor=params.split_factor,
                        data_kind=kind)


@instrument("parallel.ivf.extend",
            items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["new_vectors"]))
def extend(comms: Comms, index: IvfFlatIndex, new_vectors, new_ids=None) -> IvfFlatIndex:
    """Distributed IVF-Flat extend: the new rows split over the ranks are
    assigned and appended by their ranks; the old lists stay with their
    owners, padded in place to the grown capacity."""
    from ..distance.pairwise import _choose_tile
    from ..neighbors._list_utils import assign_to_lists
    from ..neighbors.brute_force import _as_signed

    S = comms.size()
    expects(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
            "vector dim mismatch")
    expects(new_vectors.shape[0] % S == 0, "new rows (%d) must divide the mesh axis "
            "(%d); pad first", new_vectors.shape[0], S)
    L = index.n_lists
    expects(L % S == 0, "index n_lists (%d) must divide the mesh axis (%d) "
            "— was it built by parallel.ivf.build?", L, S)
    x, lo = _rank_rows(comms, new_vectors)
    if index.data_kind in ("int8", "uint8"):
        expects(str(x.dtype).split(".")[-1] == index.data_kind,
                "this index stores %s vectors; got %s", index.data_kind, x.dtype)
        x = _as_signed(x)
    else:
        x = x.to(index.list_data.dtype)
    n_new = int(new_vectors.shape[0])
    if new_ids is None:
        ids = index.size + torch.arange(lo, lo + x.shape[0], dtype=torch.int32,
                                        device=x.device)
    else:
        ids = comms.put(new_ids, torch.int32)[lo:lo + x.shape[0]]
    centers = comms.put(index.centers)
    tile = _choose_tile(n_new // S, L, 1, 1 << 28)
    xa = x.to(torch.float32) if x.dtype == torch.int8 else x
    labels = assign_to_lists(xa, centers, index.metric, tile)
    new_counts = comms.allreduce(torch.bincount(labels.to(torch.int64), minlength=L))
    sizes = comms.put(index.list_sizes)
    new_sizes = (sizes.to(torch.int64) + new_counts).to(torch.int32)
    cap = _build_capacity(new_sizes)
    old_cap = index.capacity
    xf = x.to(torch.float32)
    data, idb, nrm = _fill_flat(comms, xf, labels, ids, L, cap, base=sizes)
    # graft the old lists back: slots below the old sizes hold the resident
    # rows, slots at and above them the new all-reduced ones
    od = torch.nn.functional.pad(_rank_lists(comms, index.list_data).to(torch.float32),
                                 (0, 0, 0, cap - old_cap))
    oi = torch.nn.functional.pad(_rank_lists(comms, index.list_ids), (0, cap - old_cap),
                                 value=-1)
    on = torch.nn.functional.pad(_rank_lists(comms, index.list_norms), (0, cap - old_cap),
                                 value=math.inf)
    keep_old = oi >= 0
    data = torch.where(keep_old[..., None], od, data)
    idb = torch.where(keep_old, oi, idb)
    nrm = torch.where(idb < 0, math.inf, torch.where(keep_old, on, nrm))
    data, idb, nrm = _gather_lists(comms, data.to(index.list_data.dtype), idb, nrm)
    return IvfFlatIndex(centers=centers, list_data=data, list_ids=idb, list_norms=nrm,
                        list_sizes=new_sizes, metric=index.metric,
                        split_factor=index.split_factor, data_kind=index.data_kind)


@instrument("parallel.ivf.build_pq",
            items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["dataset"]),
            labels=lambda a, kw: {"size": (a[0] if a else kw["comms"]).size()})
def build_pq(comms: Comms, params, dataset, res=None):
    """Distributed IVF-PQ build (``params`` =
    :class:`raft_tpu_torch.neighbors.ivf_pq.IndexParams`): the phases of
    :func:`build`, plus replicated codebook training on a pooled residual
    subsample between them and a per-rank encode feeding the list fill.
    Unlike the single-device build: per-subspace codebooks only ("auto"
    resolves to per_subspace without the per-cluster trial) and no sub-list
    splitting. Every rank calls with the global dataset and returns the
    whole index."""
    from ..distance.types import resolve_metric
    from ..neighbors import ivf_pq as pq_mod

    expects(dataset.ndim == 2, "dataset must be (n, d)")
    n, d = (int(s) for s in dataset.shape)
    S = comms.size()
    L = params.n_lists
    x_shard, lo = _rank_rows(comms, dataset)
    expects(L % S == 0, "n_lists (%d) must divide the mesh axis (%d)", L, S)
    mt = resolve_metric(params.metric)
    # int8 / uint8 ingestion as the single-device build: shifted into the s8
    # domain, trained and encoded on the exact float32 image
    data_kind, xf = pq_mod._resolve_pq_ingest(x_shard, mt)
    expects(params.codebook_kind in ("auto", "per_subspace"),
            "the distributed build trains per-subspace codebooks "
            "(codebook_kind=%r is single-device only)", params.codebook_kind)
    expects(not getattr(params, "residual_scale_norm", False),
            "residual_scale_norm is single-device only (the distributed "
            "build's pooled codebook training does not yet normalize "
            "per-list scales)")
    pq_dim = params.pq_dim or pq_mod._default_pq_dim(d, params.pq_bits)
    pq_len = -(-d // pq_dim)
    d_rot = pq_dim * pq_len
    n_codes = 1 << params.pq_bits
    split_pref = (params.pq8_split if params.pq8_split is not None
                  else mt != DistanceType.InnerProduct)
    split = params.pq_bits == 8 and bool(split_pref)
    inner = mt == DistanceType.InnerProduct
    dev = xf.device
    shard_rows = xf.shape[0]
    sub = min(max(8 * L // S, 64), shard_rows)

    (centers, labels, gcounts), g_rank = _coarse(comms, params, xf, n, L, inner, "build_pq")
    cap = _build_capacity(gcounts)

    # phase 2: the rotation (from the seed: equal on every rank) and
    # replicated codebook training on a pooled residual sample
    g_all = torch.Generator(device=dev).manual_seed(
        int(np.random.SeedSequence([int(params.seed), 1]).generate_state(1)[0]))
    rotation = pq_mod._make_rotation(g_all, d_rot, d, params.force_random_rotation, dev)
    with tracing.range("parallel.ivf.build_pq.train_codebooks"):
        idx = torch.randperm(shard_rows, generator=g_rank, device=dev)[:sub]
        lt = labels[idx].to(torch.int64)
        with full_f32():
            resid = (xf[idx] - centers[lt]) @ rotation.T
        pool = comms.allgather(resid, tiled=True)                 # (S*sub, d_rot)
        sub_pools = pool.reshape(pool.shape[0], pq_dim, pq_len).movedim(1, 0).contiguous()
        if split:
            codebooks = pq_mod._train_split_codebooks(sub_pools, g_all, params.kmeans_n_iters)
        else:
            codebooks = pq_mod._train_codebooks_batched(sub_pools, g_all, n_codes,
                                                        params.kmeans_n_iters)

    # phase 3: the rank's encode and the block fill
    enc_cb = pq_mod._composed_codebooks(codebooks) if split else codebooks
    consts_l2 = split and not inner
    with tracing.range("parallel.ivf.build_pq.encode_fill"):
        with full_f32():
            resid = ((xf - centers[labels.to(torch.int64)]) @ rotation.T).reshape(
                shard_rows, pq_dim, pq_len)
        codes = pq_mod._encode(resid, enc_cb, labels, per_cluster=False,
                               tile=min(shard_rows, 8192))
        del resid
        ids = torch.arange(lo, lo + shard_rows, dtype=torch.int32, device=dev)
        gpos = _global_positions(comms, labels, L)
        payloads = [(codes, torch.int32), (ids + 1, torch.int32)]
        if consts_l2:
            payloads.append((pq_mod._pq_cross_consts(codes, codebooks, labels, False),
                             torch.float32))
        out = _fill_blocks(comms, payloads, labels, gpos, L, cap)
        cbuf = (out[2] if consts_l2
                else torch.zeros((L // S, 0), dtype=torch.float32, device=dev))
        codes_arr, idb, cbuf = _gather_lists(comms, out[0].to(torch.uint8), out[1] - 1, cbuf)
    with full_f32():
        centers_rot = centers @ rotation.T
    return pq_mod.IvfPqIndex(
        centers=centers, centers_rot=centers_rot, rotation=rotation,
        codebooks=codebooks, list_codes=codes_arr, list_ids=idb,
        list_sizes=gcounts, list_consts=cbuf, metric=mt,
        codebook_kind="per_subspace", pq_bits=params.pq_bits,
        split_factor=params.split_factor, pq_split=split, data_kind=data_kind)
