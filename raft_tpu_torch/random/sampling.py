"""Permutation and sampling.

Counterpart of raft_tpu/random/sampling.py (reference: random/permute.cuh,
random/sample_without_replacement.cuh). The weighted draw is a Gumbel
top-k: it goes through ``matrix.select_k.select_k_impl``, so on a card a
population of 1,024 or more runs the ``topk`` kernel; ties go to the
lowest index, as ``lax.top_k``'s do.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..matrix.select_k import select_k_impl
from .rng import _draw, gumbel

__all__ = ["permute", "sample_without_replacement", "excess_subsample"]


def permute(rng, x, res: Resources | None = None):
    """Random row permutation; returns (permuted rows, the permutation
    int32) (reference: random/permute.cuh)."""
    g, dev = _draw(rng, res)
    x = (res or default_resources()).put(x)
    perm = torch.randperm(x.shape[0], generator=g, device=dev)
    return x[perm], perm.to(torch.int32)


def sample_without_replacement(rng, n_population: int, n_samples: int, weights=None,
                               res: Resources | None = None):
    """``n_samples`` distinct indices of ``range(n_population)``, int32;
    with ``weights``, drawn proportionally to them (a zero weight is never
    drawn while positive weights remain): Gumbel noise plus
    ``log(max(w, 1e-30))``, the top ``n_samples``."""
    expects(n_samples <= n_population, "cannot sample %d from %d", n_samples, n_population)
    res = res or default_resources()
    if weights is None:
        g, dev = _draw(rng, res)
        return torch.randperm(n_population, generator=g, device=dev)[:n_samples].to(torch.int32)
    w = torch.clamp_min(res.put(weights, torch.float32), 0.0)
    key = gumbel(rng, (n_population,), res=res) + torch.log(torch.clamp_min(w, 1e-30))
    return select_k_impl(key[None, :], None, int(n_samples), select_min=False)[1][0]


def excess_subsample(rng, n_population: int, n_samples: int, res: Resources | None = None):
    """A uniform subsample of row ids, sorted ascending (the dataset subset
    the IVF builds train on)."""
    idx = sample_without_replacement(rng, n_population, n_samples, res=res)
    return torch.sort(idx).values
