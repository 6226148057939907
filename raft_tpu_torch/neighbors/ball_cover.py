"""Random ball cover (RBC): exact kNN with triangle-inequality pruning.

Counterpart of raft_tpu/neighbors/ball_cover.py (reference:
raft::neighbors::ball_cover, ball_cover-inl.cuh, ball_cover_types.hpp:34-110).
``sqrt(n)`` landmarks sampled from the dataset, every point in its closest
landmark's padded list (the IVF-Flat layout), each list's radius the
largest member distance. A query scans its closest landmarks' lists, then
every list whose lower bound ``d(q, L) - radius(L)`` is below its k-th
distance, two passes as in the JAX package; the answer is exact for L2 and
haversine.

Landmarks come from a ``torch.Generator`` seeded from ``seed``, so they are
not the JAX package's; :func:`from_state` builds the index around given
landmark rows (a test hands it the JAX package's). The list selects go
through ``select_k_impl``: on the card a row of 1,024 candidates or more
runs the ``topk`` kernel, where the JAX package runs ``lax.top_k``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import _choose_tile, full_f32
from ..distance.types import DistanceType, resolve_metric
from ..matrix.select_k import _select_k, select_k_impl
from ._list_utils import assign_to_lists, list_positions, plan_search_tiles, round_up

__all__ = ["BallCoverIndex", "build", "knn_query", "all_knn_query", "eps_nn_query",
           "from_state"]

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
            DistanceType.Haversine)


@dataclasses.dataclass
class BallCoverIndex:
    """Reference: BallCoverIndex (ball_cover_types.hpp:34): the landmarks,
    the points in padded per-landmark lists, and the landmark balls' radii,
    on one device."""

    landmarks: torch.Tensor   # (L, d) float32
    list_data: torch.Tensor   # (L, cap, d), the dataset's dtype
    list_ids: torch.Tensor    # (L, cap) int32, -1 padding
    list_norms: torch.Tensor  # (L, cap) float32, +inf padding
    radii: torch.Tensor       # (L,) float32: the largest member distance
    metric: DistanceType

    @property
    def device(self) -> torch.device:
        return self.landmarks.device

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def dim(self) -> int:
        return self.landmarks.shape[1]

    @property
    def capacity(self) -> int:
        return self.list_data.shape[1]


def _hav(lat1, lon1, lat2, lon2):
    """Great-circle distance of broadcastable lat / lon radians."""
    s1 = torch.sin(0.5 * (lat2 - lat1))
    s2 = torch.sin(0.5 * (lon2 - lon1))
    h = s1 * s1 + torch.cos(lat1) * torch.cos(lat2) * s2 * s2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def _true_dist(a, b, metric: DistanceType):
    """Rowwise distance in the index metric (a, b of one shape)."""
    if metric == DistanceType.Haversine:
        return _hav(a[:, 0], a[:, 1], b[:, 0], b[:, 1])
    return torch.sqrt(torch.clamp_min((a - b).square().sum(dim=-1), 0.0))


def _resolve(metric, d: int) -> DistanceType:
    mt = resolve_metric(metric)
    expects(mt in _METRICS, "ball_cover supports L2 / haversine metrics, got %s", mt.name)
    if mt == DistanceType.Haversine:
        expects(d == 2, "haversine requires (lat, lon) inputs with d == 2")
    return mt


def _index_around(x, landmarks, mt: DistanceType, res: Resources) -> BallCoverIndex:
    """Every point in its closest landmark's list (L2 assignment, as the
    JAX package assigns for every metric), each list's radius."""
    n, d = x.shape
    n_land = landmarks.shape[0]
    tile = _choose_tile(n, n_land, 1, res.workspace_bytes)
    labels = assign_to_lists(x, landmarks, DistanceType.L2Expanded, tile)
    pos, sizes = list_positions(labels, n_land)
    capacity = round_up(max(int(sizes.max()), 1), 8)
    lab, pos = labels.to(torch.int64), pos.to(torch.int64)
    dev = x.device
    data = torch.zeros((n_land, capacity, d), dtype=x.dtype, device=dev)
    data[lab, pos] = x
    ids = torch.full((n_land, capacity), -1, dtype=torch.int32, device=dev)
    ids[lab, pos] = torch.arange(n, dtype=torch.int32, device=dev)
    xf = x.to(torch.float32)
    norms = torch.full((n_land, capacity), math.inf, device=dev)
    norms[lab, pos] = (xf * xf).sum(dim=1)
    member_d = _true_dist(xf, landmarks[lab], mt)
    radii = torch.zeros(n_land, device=dev).scatter_reduce(0, lab, member_d, "amax")
    return BallCoverIndex(landmarks, data, ids, norms, radii, mt)


def build(dataset, metric="sqeuclidean", n_landmarks: int | None = None, seed: int = 0,
          res: Resources | None = None) -> BallCoverIndex:
    """Build the index (reference: rbc_build_index, spatial/knn/detail/
    ball_cover.cuh): ``n_landmarks`` (default sqrt(n)) rows drawn without
    replacement by a torch generator seeded with ``seed``, every point
    assigned to its closest landmark."""
    res = res or default_resources()
    x = res.put(dataset)
    expects(x.ndim == 2, "dataset must be (n, d)")
    n, d = x.shape
    mt = _resolve(metric, d)
    n_land = n_landmarks or max(int(math.isqrt(n)), 1)
    expects(n_land <= n, "n_landmarks > n_samples")
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    perm = torch.randperm(n, generator=g, device=x.device)[:n_land]
    return _index_around(x, x[perm].to(torch.float32), mt, res)


def from_state(dataset, landmarks, metric="sqeuclidean",
               res: Resources | None = None) -> BallCoverIndex:
    """The index :func:`build` makes around the given ``landmarks`` (L, d)
    (for example another index's, as numpy), on the handle's device."""
    res = res or default_resources()
    x = res.put(dataset)
    expects(x.ndim == 2, "dataset must be (n, d)")
    lm = res.put(landmarks, torch.float32)
    expects(lm.ndim == 2 and lm.shape[1] == x.shape[1], "landmarks must be (L, d)")
    return _index_around(x, lm, _resolve(metric, x.shape[1]), res)


def _q2l(queries, index: BallCoverIndex):
    """Query to landmark distances in the true metric (root L2 or
    haversine): the triangle inequality needs them unsquared."""
    lm = index.landmarks
    if index.metric == DistanceType.Haversine:
        return _hav(queries[:, None, 0], queries[:, None, 1], lm[None, :, 0], lm[None, :, 1])
    qn = (queries * queries).sum(dim=1)
    ln = (lm * lm).sum(dim=1)
    with full_f32():
        d2 = qn[:, None] + ln[None, :] - 2.0 * (queries @ lm.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _scan_lists(index: BallCoverIndex, queries, probes, k: int, query_tile: int,
                probe_chunk: int):
    """Scan the (m, n_probes) landmark lists: root-metric (dists, ids), as
    the IVF-Flat scan (a gather and a product a chunk, then the chunks'
    merge)."""
    m = queries.shape[0]
    n_probes = probes.shape[1]
    haversine = index.metric == DistanceType.Haversine
    dists, idx = [], []
    for t0 in range(0, m, query_tile):
        q = queries[t0:t0 + query_tile]
        pr = probes[t0:t0 + query_tile].to(torch.int64)
        t = q.shape[0]
        cvs, cis = [], []
        for c0 in range(0, n_probes, probe_chunk):
            pc = pr[:, c0:c0 + probe_chunk]
            vecs = index.list_data[pc].to(torch.float32)           # (T, pc, cap, d)
            ids = index.list_ids[pc]
            if haversine:
                scores = _hav(q[:, None, None, 0], q[:, None, None, 1],
                              vecs[..., 0], vecs[..., 1])
                scores = torch.where(ids >= 0, scores, math.inf)
            else:
                with full_f32():
                    dots = torch.einsum("td,tpcd->tpc", q, vecs)
                scores = index.list_norms[pc] - 2.0 * dots          # +inf padding stays
            v, i = select_k_impl(scores.reshape(t, -1), ids.reshape(t, -1), k, True)
            cvs.append(v)
            cis.append(i)
        v, i = select_k_impl(torch.cat(cvs, dim=1), torch.cat(cis, dim=1), k, True)
        dists.append(v)
        idx.append(i)
    dists, idx = torch.cat(dists), torch.cat(idx)
    if not haversine:
        qn = (queries * queries).sum(dim=1, keepdim=True)
        dists = torch.where(torch.isfinite(dists),
                            torch.sqrt(torch.clamp_min(dists + qn, 0.0)), dists)
    return dists, idx


def _plan(index: BallCoverIndex, m: int, n_probes: int, k: int, res: Resources):
    return plan_search_tiles(m, n_probes, k, index.capacity,
                             bytes_per_probe_row=index.capacity * index.dim * 4,
                             budget_bytes=res.workspace_bytes)


def knn_query(index: BallCoverIndex, queries, k: int, n_probes: int | None = None,
              perform_post_filtering: bool = True, res: Resources | None = None):
    """Exact kNN through the ball cover (reference: ball_cover::knn_query,
    ball_cover-inl.cuh:259). Returns (distances (m, k) float32, ids (m, k)
    int32) in the index metric (sqeuclidean squared, as the reference's L2
    variants), on the index's device."""
    res = res or default_resources()
    q = torch.as_tensor(queries).to(device=index.device, dtype=torch.float32)
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
    m = q.shape[0]
    n_land, cap = index.n_landmarks, index.capacity
    expects(0 < k <= n_land * cap, "k=%d must be in (0, %d]", k, n_land * cap)
    p1 = n_probes or min(n_land, max(2, -(-int(1.5 * k) // cap) + 1))
    while p1 * cap < k:
        p1 += 1
    p1 = min(p1, n_land)

    q2l = _q2l(q, index)                                   # (m, L) root distances
    probes = _select_k(q2l, None, p1, True)[1]
    dists, idx = _scan_lists(index, q, probes, int(k), *_plan(index, m, p1, int(k), res))

    if perform_post_filtering and n_land > p1:
        # list Lj can hold a better neighbour only if d(q, Lj) - radius(Lj)
        # is below the current k-th distance (ref perform_post_filtering_pass)
        lower = q2l - index.radii[None, :]
        flagged = lower < dists[:, -1:]
        probed = torch.zeros((m, n_land), dtype=torch.bool, device=q.device)
        probed.scatter_(1, probes.to(torch.int64), True)
        # a second pass iff a flagged list was not scanned in the first
        if bool((flagged & ~probed).any()):
            need = max(int(flagged.sum(dim=1).max()), -(-k // cap))
            p2 = min(n_land, 1 << max(need - 1, 1).bit_length())
            probes2 = _select_k(lower, None, p2, True)[1]
            d2, i2 = _scan_lists(index, q, probes2, int(k), *_plan(index, m, p2, int(k), res))
            md = torch.cat([dists, d2], dim=1)
            mi = torch.cat([idx, i2], dim=1)
            # an id found by both passes: its later copies (in distance
            # order) to +inf
            order = torch.argsort(md, dim=1, stable=True)
            mi_s = torch.gather(mi, 1, order)
            md_s = torch.gather(md, 1, order)
            w = md_s.shape[1]
            earlier = torch.ones((w, w), dtype=torch.bool, device=q.device).tril(-1)
            dup = ((mi_s[:, None, :] == mi_s[:, :, None]) & earlier).any(dim=2)
            dists, idx = _select_k(torch.where(dup, math.inf, md_s), mi_s, int(k), True)

    if index.metric in (DistanceType.L2Expanded, DistanceType.L2Unexpanded):
        dists = torch.where(torch.isfinite(dists), dists * dists, dists)
    return dists, idx


def all_knn_query(index: BallCoverIndex, k: int, res: Resources | None = None):
    """kNN of the index's points among themselves, in id order (reference:
    ball_cover::all_knn_query, ball_cover-inl.cuh:112)."""
    ids = index.list_ids.reshape(-1)
    live = ids >= 0
    x = torch.zeros((int(live.sum()), index.dim), dtype=index.list_data.dtype,
                    device=index.device)
    x[ids[live].to(torch.int64)] = index.list_data.reshape(-1, index.dim)[live]
    return knn_query(index, x, k, res=res)


def eps_nn_query(index: BallCoverIndex, queries, eps: float, res: Resources | None = None):
    """Every point within ``eps`` of each query in the index metric
    (reference: ball_cover::eps_nn, the adjacency variant). Returns (adj
    (m, n) bool over ids, vertex_degree (m + 1,) int32, the last entry the
    total); query rows go in tiles under the workspace budget."""
    res = res or default_resources()
    q = torch.as_tensor(queries).to(device=index.device, dtype=torch.float32)
    expects(q.ndim == 2 and q.shape[1] == index.dim, "query dim mismatch")
    m = q.shape[0]
    flat = index.list_data.reshape(-1, index.dim).to(torch.float32)
    ids = index.list_ids.reshape(-1)
    live = ids >= 0
    n = int(live.sum())
    fn2 = (flat * flat).sum(dim=1)
    tile = _choose_tile(m, flat.shape[0], 0, res.workspace_bytes)
    adj = torch.zeros((m, n), dtype=torch.bool, device=q.device)
    cols = ids[live].to(torch.int64)
    for t0 in range(0, m, tile):
        qb = q[t0:t0 + tile]
        if index.metric == DistanceType.Haversine:
            dist = _hav(qb[:, None, 0], qb[:, None, 1], flat[None, :, 0], flat[None, :, 1])
        else:
            with full_f32():
                d2 = (qb * qb).sum(dim=1)[:, None] + fn2[None, :] - 2.0 * (qb @ flat.T)
            dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        adj[t0:t0 + tile, cols] = (dist <= eps)[:, live]
    deg = adj.sum(dim=1, dtype=torch.int32)
    return adj, torch.cat([deg, deg.sum(dtype=torch.int32).reshape(1)])
