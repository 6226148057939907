"""Exact re-ranking of ANN candidate lists.

Counterpart of raft_tpu/neighbors/refine.py (reference: neighbors/refine.cuh,
detail/refine.cuh). Each query's candidate rows are gathered, scored
exactly, and the best k kept, ties to the lowest candidate position as
``lax.top_k``'s. Negative candidate ids are padding: they sort last
(distance ±inf) and come back as id -1.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32
from ..distance.types import DistanceType, resolve_metric
from ..ops.topk import top_k_lowest_index

__all__ = ["refine", "refine_gathered"]


def _score_candidates(cand_vecs, queries, candidates, k: int, metric: DistanceType):
    """Exact re-rank of gathered candidate rows (m, k0, d); shared by
    :func:`refine` and :func:`refine_gathered`."""
    valid = candidates >= 0
    q = queries[:, None, :].to(torch.float32)
    c = cand_vecs.to(torch.float32)
    if metric == DistanceType.InnerProduct:
        with full_f32():
            scores = torch.einsum("mkd,mod->mk", c, q)
        top_v, top_pos = top_k_lowest_index(
            torch.where(valid, scores, -torch.inf), k)
    else:
        d2 = torch.square(c - q).sum(dim=-1)
        if metric in (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded):
            d2 = torch.sqrt(torch.clamp_min(d2, 0.0))
        top_v, top_pos = top_k_lowest_index(-torch.where(valid, d2, torch.inf), k)
        top_v = -top_v
    ids = torch.where(torch.gather(valid, 1, top_pos),
                      torch.gather(candidates, 1, top_pos), -1)
    return top_v, ids.to(torch.int32)


def refine(dataset, queries, candidates, k: int, metric="sqeuclidean",
           res: Resources | None = None):
    """Re-rank ``candidates`` (m, k0) by exact distance and return the best
    ``k <= k0`` (reference: neighbors/refine.cuh, pylibraft refine.pyx):
    (distances (m, k) float32, ids (m, k) int32) on the handle's device."""
    res = res or default_resources()
    dataset = res.put(dataset)
    queries = res.put(queries)
    candidates = res.put(candidates).to(torch.int64)
    expects(candidates.ndim == 2 and candidates.shape[0] == queries.shape[0],
            "candidates must be (n_queries, k0)")
    expects(k <= candidates.shape[1], "k must be <= candidate width")
    cand_vecs = dataset[torch.clamp_min(candidates, 0)]
    return _score_candidates(cand_vecs, queries, candidates, int(k),
                             resolve_metric(metric))


def refine_gathered(cand_vecs, queries, candidates, k: int, metric="sqeuclidean",
                    res: Resources | None = None):
    """:func:`refine` over candidate rows already gathered, (m, k0, d); the
    same scoring, so the same distances. Negative ``candidates`` are padding:
    their gathered row is masked and comes back as id -1."""
    res = res or default_resources()
    queries = res.put(queries)
    cand_vecs = res.put(cand_vecs)
    candidates = res.put(candidates).to(torch.int64)
    expects(candidates.ndim == 2 and candidates.shape[0] == queries.shape[0],
            "candidates must be (n_queries, k0)")
    expects(tuple(cand_vecs.shape[:2]) == tuple(candidates.shape),
            "cand_vecs must be (n_queries, k0, d) matching candidates")
    expects(k <= candidates.shape[1], "k must be <= candidate width")
    return _score_candidates(cand_vecs, queries, candidates, int(k),
                             resolve_metric(metric))
