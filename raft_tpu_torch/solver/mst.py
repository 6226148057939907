"""Minimum spanning tree / forest: Borůvka, batch-synchronous.

Counterpart of raft_tpu/solver/mst.py (reference: raft/sparse/solver/
mst_solver.cuh, detail/mst_{solver_inl,kernels,utils}.cuh). The JAX design,
kept so that the result is a function of the COO alone, on any device:

1. every edge gets one global (weight, id) rank from a single stable
   argsort, so each component's cheapest edge is a scatter-min of int32
   ranks, and both endpoints' components agree on it;
2. winner edges hook the larger color onto the smaller (colors only fall,
   so no cycle forms) and colors settle by pointer jumping (ceil(log2 n) +
   1 fixed steps);
3. rounds stop when no edge crosses two components (a spanning forest if
   the graph is disconnected).

The JAX ``lax.while_loop`` is a host loop here that reads its ``again``
flag back once a round: log-many reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.errors import expects
from ..sparse.convert import csr_to_coo
from ..sparse.types import CsrMatrix

__all__ = ["MstOutput", "mst"]

_i32 = torch.int32
_BIG = 2**31 - 1


class MstOutput(NamedTuple):
    """Reference: Graph_COO output of mst_solver (mst_solver.cuh)."""

    src: torch.Tensor       # (cap,) int32, padding = n
    dst: torch.Tensor       # (cap,) int32
    weights: torch.Tensor   # (cap,) float32, padding = +inf
    n_edges: torch.Tensor   # int32 0-d
    colors: torch.Tensor    # (n,) int32 final component labels


def _boruvka(rows, cols, weights, valid, n: int, jump_steps: int):
    """The rounds; returns (MstOutput, rounds run)."""
    cap = rows.shape[0]
    dev = rows.device
    order = torch.argsort(torch.where(valid, weights, torch.inf), stable=True)
    rank = torch.empty((cap,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(cap, device=dev)
    r = torch.clamp_max(rows, n - 1).to(torch.int64)
    c = torch.clamp_max(cols, n - 1).to(torch.int64)
    color = torch.arange(n, dtype=torch.int64, device=dev)
    mst_mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
    drop = torch.full((cap,), n, dtype=torch.int64, device=dev)
    rounds = 0
    while True:
        rounds += 1
        cu, cv = color[r], color[c]
        cand = valid & (cu != cv)
        key = torch.where(cand, rank, _BIG)
        # each component's least outgoing rank, from both endpoints
        best = torch.full((n + 1,), _BIG, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, torch.where(cand, cu, drop), key, "amin")
        best.scatter_reduce_(0, torch.where(cand, cv, drop), key, "amin")
        winner = cand & ((rank == best[cu]) | (rank == best[cv]))
        mst_mask |= winner
        parent = torch.arange(n + 1, dtype=torch.int64, device=dev)
        parent.scatter_reduce_(0, torch.where(winner, torch.maximum(cu, cv), drop),
                               torch.minimum(cu, cv), "amin")
        parent = parent[:n]
        for _ in range(jump_steps):
            parent = parent[parent]
        color = parent[color]
        if not bool(cand.any()):
            break
    # MST edges compacted to the front, by weight (the single-linkage
    # reference sorts its MST output, cluster/detail/mst.cuh)
    out_order = torch.argsort(torch.where(mst_mask, weights, torch.inf), stable=True)
    kept = mst_mask[out_order]
    src = torch.where(kept, rows[out_order], n)
    dst = torch.where(kept, cols[out_order], n)
    w = torch.where(kept, weights[out_order], torch.inf)
    return MstOutput(src, dst, w, mst_mask.sum().to(_i32), color.to(_i32)), rounds


def mst(graph, n_vertices: int | None = None) -> MstOutput:
    """Minimum spanning forest of an undirected weighted graph, on the
    graph's device (reference: raft::sparse::solver::mst).

    ``graph`` is a CooMatrix or CsrMatrix of (symmetric) edge weights; one
    direction of each pair (row < col) is kept. Returns its edges sorted by
    weight, padding rows = n.
    """
    return _mst(graph, n_vertices)[0]


def _mst(graph, n_vertices: int | None = None):
    """:func:`mst` and the rounds it ran."""
    if isinstance(graph, CsrMatrix):
        graph = csr_to_coo(graph)
    expects(graph.shape[0] == graph.shape[1], "graph must be square")
    n = graph.shape[0] if n_vertices is None else int(n_vertices)
    expects(n >= graph.shape[0], "n_vertices=%d < graph dimension %d", n, graph.shape[0])
    keep = graph.valid_mask() & (graph.rows < graph.cols)
    jump = max(int(math.ceil(math.log2(max(n, 2)))) + 1, 1)
    return _boruvka(graph.rows, graph.cols, graph.vals.to(torch.float32), keep, n, jump)
