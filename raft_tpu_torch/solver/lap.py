"""Linear assignment problem (LAP), batched.

Counterpart of raft_tpu/solver/lap.py (reference: raft/solver/
linear_assignment.cuh, ``LinearAssignmentProblem``, the Date-Nagi GPU
Hungarian algorithm). The JAX design: Bertsekas' auction with ε-scaling,
whose bidding is a batched top-2 over the value matrix and whose
assignment is two scatters. Each round every unassigned row bids for its
best column with increment (v₁ - v₂ + ε); once every row is assigned at
the final ε the assignment is within n·ε of optimal (exact for integer
costs at the default 1/(n+1)). Prices are the column duals, row duals the
residual max.

A batch (b, n, n) runs as one: each problem is frozen once it finishes (or
reaches ``max_iter``), as ``vmap`` of the JAX ``while_loop`` freezes it. The
JAX loop tests its stop flag every round; here the host reads it once
every :data:`ROUNDS_PER_READ` rounds (capped at ``max_iter``). A frozen
problem does not change, so the answers are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..ops.topk import top_k_lowest_index

__all__ = ["LapOutput", "lap_solve"]

_f32 = torch.float32
_i32 = torch.int32
ROUNDS_PER_READ = 32


class LapOutput(NamedTuple):
    """Reference accessors: getAssignmentVector / getRowAssignments (solve),
    getRowDualVector :150, getColDualVector :160, getPrimalObjectiveValue
    :170."""

    row_assignment: torch.Tensor   # (..., n) int32: column assigned to each row
    col_assignment: torch.Tensor   # (..., n) int32: row assigned to each column
    objective: torch.Tensor        # (...,) cost-sense objective
    row_duals: torch.Tensor        # (..., n) float32
    col_duals: torch.Tensor        # (..., n) float32
    converged: torch.Tensor        # (...,) bool: every row assigned within max_iter


def _auction(benefit, eps_final: float, max_iter: int):
    """Auctions over benefit (b, n, n). Returns (row_assign, col_owner,
    prices, row_duals, done, rounds, reads)."""
    b, n, _ = benefit.shape
    dev = benefit.device
    ninf = torch.tensor(float("-inf"), dtype=_f32, device=dev)
    eps_final_t = torch.tensor(eps_final, dtype=_f32, device=dev)
    flat = benefit.reshape(b, -1)
    rng = torch.clamp_min(flat.amax(1) - flat.amin(1), 1.0)
    eps = torch.maximum(rng / 2.0, eps_final_t)
    prices = torch.zeros((b, n), dtype=_f32, device=dev)
    row_assign = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    col_owner = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = torch.zeros((b,), dtype=torch.int64, device=dev)
    people = torch.arange(n, device=dev).expand(b, n)
    drop = torch.full((b, n), n, dtype=torch.int64, device=dev)

    def round_():
        nonlocal prices, row_assign, col_owner, eps, done, it
        live = ~done & (it < max_iter)
        unassigned = row_assign < 0
        values = benefit - prices[:, None, :]
        top2_v, top2_i = top_k_lowest_index(values.reshape(b * n, n), 2)
        top2_v, jstar = top2_v.reshape(b, n, 2), top2_i.reshape(b, n, 2)[..., 0]
        new_price = torch.gather(benefit, 2, jstar[..., None])[..., 0] - top2_v[..., 1] + eps[:, None]
        bid_to = torch.where(unassigned, jstar, drop)
        colmax = torch.full((b, n + 1), float("-inf"), dtype=_f32, device=dev)
        colmax.scatter_reduce_(1, bid_to, torch.where(unassigned, new_price, ninf), "amax")
        colmax = colmax[:, :n]
        bided = colmax > ninf
        is_winner = unassigned & (new_price >= torch.gather(colmax, 1, jstar))
        winner = torch.full((b, n + 1), n, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(1, bid_to, torch.where(is_winner, people, drop), "amin")
        winner = winner[:, :n]
        # evict the previous owners of columns that took bids, then assign
        evicted = (row_assign >= 0) & torch.gather(bided, 1, torch.clamp_max(row_assign, n - 1)
                                                   .clamp_min(0))
        ra = torch.where(evicted, -1, row_assign)
        co = torch.where(bided, winner, col_owner)
        ra_buf = torch.cat([ra, ra.new_zeros((b, 1))], 1)
        ra_buf.scatter_(1, torch.where(bided, winner, drop), people)
        ra = ra_buf[:, :n]
        pr = torch.where(bided, colmax, prices)
        all_assigned = (ra >= 0).all(1)
        at_final = eps <= eps_final_t
        dn = all_assigned & at_final
        # ε-scaling: a finished scale tightens ε and starts the assignment
        # again, keeping the prices
        rescale = all_assigned & ~at_final
        ep = torch.where(rescale, torch.maximum(eps / 4.0, eps_final_t), eps)
        ra = torch.where(rescale[:, None], -1, ra)
        co = torch.where(rescale[:, None], -1, co)
        keep = live[:, None]
        prices = torch.where(keep, pr, prices)
        row_assign = torch.where(keep, ra, row_assign)
        col_owner = torch.where(keep, co, col_owner)
        eps = torch.where(live, ep, eps)
        done = torch.where(live, dn, done)
        it = it + live.to(torch.int64)

    rounds = reads = 0
    while rounds < max_iter:
        for _ in range(min(ROUNDS_PER_READ, max_iter - rounds)):
            round_()
            rounds += 1
        reads += 1
        if not bool((~done & (it < max_iter)).any()):
            break
    row_duals = (benefit - prices[:, None, :]).amax(2)
    return row_assign, col_owner, prices, row_duals, done, int(it.max()), reads


def lap_solve(cost, eps: float | None = None, maximize: bool = False,
              max_iter: int | None = None, res: Resources | None = None) -> LapOutput:
    """Solve square assignment problems (reference: linear_assignment.cuh:119).

    ``cost`` is (n, n) or a batch (b, n, n); a tensor runs on its device,
    an array on ``res``'s (``cuda`` by default). Minimises by default.
    ``eps`` is the final auction ε: the objective is within n·ε of optimal,
    and exact for integer costs at the default 1/(n+1). ``converged`` is
    False where ``max_iter`` rounds ended before every row was assigned (a
    partial assignment, -1 rows).
    """
    return _lap(cost, eps, maximize, max_iter, res)[0]


def _lap(cost, eps, maximize, max_iter, res):
    """:func:`lap_solve` and its loop's counts: {"rounds": the most any
    problem ran, "reads": stop-flag read-backs}."""
    if isinstance(cost, torch.Tensor):
        if res is not None:
            res.check_holds(cost.device, "the cost matrix")
        cost = cost.to(_f32)
    else:
        cost = (res or default_resources()).put(np.asarray(cost), _f32)
    expects(cost.ndim in (2, 3), "cost must be (n,n) or (b,n,n), got %dd", cost.ndim)
    n = cost.shape[-1]
    expects(cost.shape[-2] == n, "cost matrices must be square")
    batch = cost.shape[:-2]
    if n == 1:
        zero = torch.zeros(batch + (1,), dtype=_i32, device=cost.device)
        fz = torch.zeros(batch + (1,), dtype=_f32, device=cost.device)
        return LapOutput(zero, zero, cost[..., 0, 0], fz, fz,
                         torch.ones(batch, dtype=torch.bool, device=cost.device)), {
                             "rounds": 0, "reads": 0}
    if eps is None:
        eps = 1.0 / (n + 1)
    if max_iter is None:
        # each round raises a price by at least ε and prices are bounded
        max_iter = 2000 * n + 20_000
    c = cost.reshape(-1, n, n)
    benefit = c if maximize else -c
    ra, ca, prices, rd, done, rounds, reads = _auction(benefit, float(eps), int(max_iter))
    # unassigned rows (only where not converged) contribute 0
    picked = torch.gather(c, 2, ra.clamp_min(0)[..., None])[..., 0]
    obj = torch.where(ra >= 0, picked, torch.zeros_like(picked)).sum(1)
    if not maximize:
        prices, rd = -prices, -rd
    return LapOutput(ra.to(_i32).reshape(batch + (n,)), ca.to(_i32).reshape(batch + (n,)),
                     obj.reshape(batch), rd.reshape(batch + (n,)),
                     prices.reshape(batch + (n,)), done.reshape(batch)), {
                         "rounds": rounds, "reads": reads}
