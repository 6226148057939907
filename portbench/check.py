"""What decides ``correct``: the program's answers against the plain reference.

Every answer the window produced is judged, once the window has closed and
the program's state is freed:

- ``unanswered``: queries or requests of the window that never got an
  answer (refused, failed, or not back a minute after the close). Limit 0.
- ``invalid``: answer rows with an id outside the rows, an id twice, a
  distance that is not finite, or distances out of ascending order.
  Limit 0.
- ``dist_gap``: the widest gap between a returned distance and the
  reference's float64 distance of the same query and id, over the size of
  the terms a float32 distance is rounded against:
  ``|d - d_ref| / (||x_id||^2 + ||q||^2)``. Measured against the terms and
  not against ``d_ref``, a near neighbour's distance that float32 takes as
  ``|x|^2 - 2 q.x + |q|^2`` (an entry of the CAGRA beam) reads as the
  rounding it is; an id that is not the distance's reads as O(1). The
  configuration guarantees the distances of the returned ids.
- ``recall_miss``: ``1 - recall@k`` of the answers to a sample of the query
  pool drawn from the seed, where a returned id counts as found when its
  exact distance is no more than the k-th exact distance (ties count, as in
  big-ann-benchmarks). Valid ids with their own exact distances that are not
  the near neighbours read here, and nowhere else. A run whose answers reach
  no query of the sample reads 1.

The configuration's file holds each limit and the readings it was set from.
The recall is also the end-to-end metric ``recall_at_10``.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import reference

__all__ = ["Answers", "Verdict", "judge", "recall_sample"]

_ROWS = 1 << 16


@dataclasses.dataclass
class Answers:
    """The window's answers: row r answers pool query ``qidx[r]``."""

    qidx: torch.Tensor        # (N,) int64
    dist: torch.Tensor        # (N, k) float32
    ids: torch.Tensor         # (N, k) int64
    unanswered: int = 0


@dataclasses.dataclass
class Verdict:
    numbers: dict             # name -> (value, limit)
    recall: float | None
    checked_rows: int

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


def recall_sample(pool_size: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` distinct pool indices drawn from the seed, ascending."""
    g = torch.Generator(device="cpu").manual_seed(seed % (1 << 63) ^ 0x5EED)
    pick = torch.randperm(pool_size, generator=g)[:min(count, pool_size)]
    return torch.sort(pick).values.to(device)


def _invalid_rows(d, ids, n: int) -> torch.Tensor:
    bad = ((ids < 0) | (ids >= n)).any(dim=1) | (~torch.isfinite(d)).any(dim=1)
    srt = torch.sort(ids, dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    bad |= (d[:, 1:] < d[:, :-1]).any(dim=1)
    return bad


def judge(x, pool, ans: Answers, k: int, limits: dict, sample=None) -> Verdict:
    """Judge ``ans`` against the reference over the rows ``x`` and the query
    pool ``pool``; ``sample`` (pool indices) adds ``recall_miss``, judged on
    the answers to those queries."""
    n, dev = x.shape[0], pool.device
    invalid = 0
    gap = 0.0
    for s in range(0, ans.ids.shape[0], _ROWS):
        d = ans.dist[s:s + _ROWS].to(dev)
        ids = ans.ids[s:s + _ROWS].to(dev)
        q = pool[ans.qidx[s:s + _ROWS].to(dev)]
        invalid += int(_invalid_rows(d, ids, n).sum())
        ref, terms = reference.distances(x, q, ids, scale=True)
        ok = torch.isfinite(ref)
        rel = (d.to(torch.float64) - ref).abs() / terms.clamp_min(1e-300)
        rel = torch.where(ok & (ref == d.to(torch.float64)), 0.0, rel)
        if ok.any():
            gap = max(gap, float(rel[ok].max()))
    numbers = {"unanswered": (float(ans.unanswered), float(limits.get("unanswered", 0))),
               "invalid": (float(invalid), float(limits.get("invalid", 0))),
               "dist_gap": (gap, float(limits["dist_gap"]))}
    recall = None
    if sample is not None:
        recall = _recall(x, pool, ans, k, sample) if ans.ids.shape[0] else None
        numbers["recall_miss"] = (1.0 - (recall or 0.0), float(limits["recall_miss"]))
    return Verdict(numbers, recall, int(ans.ids.shape[0]))


def _recall(x, pool, ans: Answers, k: int, sample) -> float | None:
    dev = pool.device
    slot = torch.full((pool.shape[0],), -1, dtype=torch.int64, device=dev)
    slot[sample] = torch.arange(sample.shape[0], device=dev)
    true_d, _ = reference.exact_knn(x, pool[sample], k)
    kth = true_d[:, k - 1]
    hits, rows = 0, 0
    for s in range(0, ans.ids.shape[0], _ROWS):
        pos = slot[ans.qidx[s:s + _ROWS].to(dev)]
        keep = pos >= 0
        if not keep.any():
            continue
        ids = ans.ids[s:s + _ROWS].to(dev)[keep][:, :k]
        q = pool[ans.qidx[s:s + _ROWS].to(dev)[keep]]
        d = reference.distances(x, q, ids)
        hits += int((d <= kth[pos[keep]][:, None]).sum(dim=1).clamp_max(k).sum())
        rows += int(keep.sum())
    return hits / (rows * k) if rows else None
