"""Shared inverted-list machinery for IVF indexes.

Counterpart of raft_tpu/neighbors/_list_utils.py (reference: ivf::list,
neighbors/ivf_list.hpp): list assignment, within-list positions for the
padded scatter, the capacity policy that splits oversized lists, and the
search-time (query_tile, probe_chunk) plan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import chunked
from ..core.chunked import is_reader  # noqa: F401 - re-exported
from ..distance.fused_nn import _fused_l2_nn
from ..distance.pairwise import _choose_tile, full_f32
from ..distance.types import DistanceType
from ..matrix.ops import segment_sum
from .brute_force import _as_signed

__all__ = ["round_up", "fill_tile", "list_cap_target", "list_positions", "plan_search_tiles",
           "assign_to_lists", "split_oversized", "spatial_split_key",
           "bound_capacity", "priced_capacity", "pq_scan_bytes_per_probe_row",
           "funnel_scan_bytes_per_probe_row", "is_reader", "stream_probe",
           "stream_ingest"]


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# the most rows a per-row pass of an IVF fill (assign, norms, encode) takes
# at once: one default chunk, so a streamed pass never assembles more rows
# on the device than a chunk holds
FILL_TILE_MAX = 65536


def fill_tile(n: int, n_lists: int, budget_bytes: int) -> int:
    """The row tile of an IVF fill's per-row passes over ``n`` rows: the
    workspace's (tile, n_lists) score block, at most ``FILL_TILE_MAX`` rows.
    It depends on ``n`` and not on how the rows arrive, so a streamed fill
    tiles its rows as the in-core one does."""
    return min(_choose_tile(n, n_lists, 1, budget_bytes), FILL_TILE_MAX)


def stream_probe(dtype, d: int):
    """A zero-row tensor of a reader's device dtype: lets a build resolve
    and validate its storage type without the corpus (float64 rows land as
    float32, as in-core)."""
    return torch.zeros((0, d), dtype=chunked.torch_dtype(dtype))


def stream_ingest(kind: str, dtype):
    """Raw rows of a ``kind`` index -> ``dtype`` in its domain (uint8
    shifted by -128): the streamed twin of the in-core conversions.
    Elementwise, so it commutes with the trainset gather."""
    if kind in ("int8", "uint8"):
        return lambda v: _as_signed(v).to(dtype)
    return lambda v: v.to(dtype)


def list_cap_target(rows: int, n_lists: int, factor: float) -> int:
    """The capacity bound of :func:`bound_capacity`: lists larger than
    ``factor`` x the mean split, so allocated capacity is at most this."""
    mean = max(rows / max(n_lists, 1), 1.0)
    return round_up(max(int(mean * factor), 8), 8)


def assign_to_lists(x, centers, metric: DistanceType, tile: int):
    """Nearest list of each row under the index metric (argmax of the
    product for inner product, L2 argmin otherwise), int32; ties go to the
    lowest list."""
    if metric == DistanceType.InnerProduct:
        with full_f32():
            scores = x.to(torch.float32) @ centers.T
        return torch.argmax(scores, dim=1).to(torch.int32)
    return _fused_l2_nn(x, centers, False, tile)[1]


def list_positions(labels, n_lists: int):
    """Within-list position of each row (its rank among rows of the same
    label, in input order), by one stable sort. Returns (pos (n,) int32,
    counts (n_lists,) int32)."""
    n = labels.shape[0]
    lab = labels.to(torch.int64)
    order = torch.argsort(lab, stable=True)
    counts = torch.bincount(lab, minlength=n_lists)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=lab.device) - starts[lab[order]]
    pos = torch.empty(n, dtype=torch.int32, device=lab.device)
    pos[order] = pos_sorted.to(torch.int32)
    return pos, counts.to(torch.int32)


def split_oversized(labels, n_lists: int, cap_target: int, order_key=None):
    """Split lists larger than ``cap_target`` into sub-lists of at most
    ``cap_target`` rows. Members divide by input order, or by ``order_key``
    ((n,) float, e.g. :func:`spatial_split_key`) so that each sub-list is a
    spatially coherent slab. Returns ``(new_labels (n,) int32, rep
    (n_lists,) host int64 array)``: list ``l`` became ``rep[l]`` sub-lists;
    callers repeat per-list arrays with ``np.repeat(arr, rep, axis=0)``."""
    lab = labels.to(torch.int64)
    if order_key is None:
        pos, counts = list_positions(labels, n_lists)
        pos = pos.to(torch.int64)
    else:
        # rank within the list by (label, key): sort by key, then stably by label
        n = lab.shape[0]
        by_key = torch.argsort(order_key.to(torch.float32), stable=True)
        order = by_key[torch.argsort(lab[by_key], stable=True)]
        counts = torch.bincount(lab, minlength=n_lists)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.empty(n, dtype=torch.int64, device=lab.device)
        pos[order] = torch.arange(n, device=lab.device) - starts[lab[order]]
    counts_h = counts.cpu().numpy().astype(np.int64)
    rep = np.maximum(1, -(-counts_h // cap_target)).astype(np.int64)
    base = torch.from_numpy(np.concatenate([[0], np.cumsum(rep)[:-1]])).to(lab.device)
    return (base[lab] + pos // cap_target).to(torch.int32), rep


def spatial_split_key(x, labels, n_lists: int, n_iters: int = 3, seed: int = 0):
    """Projection of each row onto its list's principal axis (per-list
    means, then ``n_iters`` power iterations of the per-list covariance
    action from a seeded Gaussian start): the spatial order key of
    :func:`split_oversized`."""
    xf = x.to(torch.float32)
    n, d = xf.shape
    lab = labels.to(torch.int64)
    dev = xf.device
    sums = segment_sum(xf, lab, n_lists)
    counts = torch.bincount(lab, minlength=n_lists).to(torch.float32)
    xc = xf - (sums / torch.clamp_min(counts, 1.0)[:, None])[lab]
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((n_lists, d), generator=g, device=dev)
    for _ in range(n_iters):
        w = (xc * v[lab]).sum(dim=1)
        v2 = segment_sum(w[:, None] * xc, lab, n_lists)
        v = v2 / torch.clamp_min(torch.linalg.norm(v2, dim=1, keepdim=True), 1e-20)
    return (xc * v[lab]).sum(dim=1)


def _slots(sizes_h, cap: int) -> int:
    """Padded list slots of ``sizes_h`` split at capacity ``cap``."""
    return int(np.maximum(1, -(-sizes_h // cap)).sum()) * cap


def priced_capacity(sizes_h, cap_target: int) -> int:
    """The capacity a build's fill splits at (``bound_capacity(priced=
    True)``): the largest multiple of 8 up to ``cap_target`` whose split
    holds at most 1.2x the ``len(sizes_h) x cap_target`` slots
    ``obs.mem.plan()`` prices (its stated accuracy), or, where none does,
    the one with the fewest slots. ``cap_target`` itself, as in the JAX
    package, unless that split would pass 1.2x the price."""
    limit = 1.2 * len(sizes_h) * cap_target
    caps = range(cap_target, 7, -8)
    return next((c for c in caps if _slots(sizes_h, c) <= limit),
                min(caps, key=lambda c: _slots(sizes_h, c)))


def bound_capacity(labels, n_lists: int, factor: float = 1.3, x=None,
                   priced: bool = False):
    """The shared capacity policy of IVF fills: lists larger than ``factor``
    x the mean split into sub-lists (:func:`split_oversized`); otherwise the
    capacity is the largest list rounded up to 8. With ``x`` (n, d) given,
    lists at least 8x the bound split spatially along their principal axis
    (the caller then re-centres those lists' children); milder ones split by
    input order. The 8x threshold is the JAX package's measured compromise
    (raft_tpu/neighbors/_list_utils.py:172).

    ``priced=True`` (a build's fill: ``labels`` are every row, ``n_lists``
    the lists asked) splits at :func:`priced_capacity`, which
    differs from the JAX package only where its split would hold more
    than 1.2x the slots ``obs.mem.plan()`` prices.

    Returns ``(labels, rep, n_lists, capacity, spatial)``: ``rep`` is None
    when nothing split, else the host repeat counts for per-list arrays;
    ``spatial`` is None or a host bool array over the original lists marking
    those split spatially."""
    sizes = torch.bincount(labels.to(torch.int64), minlength=n_lists)
    max_size = max(int(sizes.max()), 1)
    cap_target = list_cap_target(labels.shape[0], n_lists, factor)
    if max_size <= cap_target:
        return labels, None, n_lists, round_up(max_size, 8), None
    order_key = None
    spatial = None
    sizes_h = sizes.cpu().numpy()
    severe_h = sizes_h >= 8 * cap_target
    split_cap = priced_capacity(sizes_h, cap_target) if priced else cap_target
    if x is not None and severe_h.any():
        proj = spatial_split_key(x, labels, n_lists)
        severe = torch.from_numpy(severe_h).to(labels.device)
        order_key = torch.where(severe[labels.to(torch.int64)], proj, 0.0)
        spatial = severe_h
    new_labels, rep = split_oversized(labels, n_lists, split_cap, order_key)
    return new_labels, rep, int(rep.sum()), split_cap, spatial


def pq_scan_bytes_per_probe_row(capacity: int, pq_dim: int, n_codes: int) -> int:
    """Memory model of one (query, probe) pair of the PQ scan, the JAX
    package's (codes, gathered LUT values and scores per slot, plus the LUT,
    x2 for temporaries): it sizes the search tiles, so the port keeps it
    and with it the JAX package's tile plan."""
    return 2 * (capacity * pq_dim * 9 + pq_dim * n_codes * 8)


def funnel_scan_bytes_per_probe_row(capacity: int, sig_words: int) -> int:
    """Memory model of one (query, probe) pair of the fast-scan funnel's
    signature tier, the JAX package's (the packed signatures and estimator
    scores per slot, plus the 32-entry nibble LUT, x2 for temporaries)."""
    return 2 * (capacity * (sig_words * 9 + 4) + sig_words * 32 * 8)


def plan_search_tiles(m: int, n_probes: int, k: int, capacity: int,
                      bytes_per_probe_row: int, budget_bytes: int,
                      max_query_tile: int = 256):
    """Pick (query_tile, probe_chunk) so one step's working set fits the
    workspace budget while every chunk still holds >= k candidates (the
    analogue of the reference's chooseTileSize, knn_brute_force.cuh:78,
    applied to list scans)."""
    min_chunk = -(-k // capacity)
    if min_chunk > n_probes:
        raise ValueError(
            f"k={k} exceeds the probed candidate pool "
            f"(n_probes={n_probes} x capacity={capacity})"
        )
    probe_chunk = n_probes
    query_tile = min(m, max_query_tile)

    def cost(qt, pc):
        return qt * pc * bytes_per_probe_row

    while (probe_chunk // 2 >= min_chunk and probe_chunk % 2 == 0
           and cost(query_tile, probe_chunk) > budget_bytes):
        probe_chunk //= 2
    while query_tile > 8 and cost(query_tile, probe_chunk) > budget_bytes:
        query_tile //= 2
    while n_probes % probe_chunk:
        probe_chunk -= 1
    probe_chunk = max(probe_chunk, min_chunk)
    while n_probes % probe_chunk:
        probe_chunk += 1
    return query_tile, probe_chunk
