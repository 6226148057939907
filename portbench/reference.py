"""The plain reference: exact k nearest neighbours by squared L2 distance.

Plain PyTorch over the raw generated rows; it imports nothing of
``raft_tpu_torch`` and takes nothing the program made (no centres, codes,
graph or distances). It runs in blocks, so that it fits beside the rows on
the card once the program's state is freed.

- :func:`exact_knn`: a float32 screen (``|x|^2 - 2 q.x`` with TF32 off)
  keeps ``screen`` candidates a query, whose distances are then taken again
  exactly in float64 by direct differences; the best ``k`` of those are the
  answer. For uint8 rows the float32 screen is exact already (every product
  and every partial sum is an integer below 2^24).
- :func:`distances`: the float64 distance of each (query, id) pair.
- :func:`knn_lower`: the same search computed in bfloat16, the precision
  below the configuration's float32 distances: the control, put in the
  program's place.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["exact_knn", "distances", "knn_lower", "full_f32"]

_Q_BLOCK = 2048
_ROW_BLOCK = 1 << 20
_PAIR_BLOCK = 1 << 17


@contextlib.contextmanager
def full_f32():
    """float32 products in float32: TF32 off for the block, as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def distances(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, scale: bool = False):
    """float64 ``||x[ids[i, j]] - q[i]||^2``, (m, k); ids outside ``[0, n)``
    read +inf. With ``scale``, also ``||x[ids[i, j]]||^2 + ||q[i]||^2``, the
    size of the terms a float32 distance is rounded against."""
    n = x.shape[0]
    m, k = ids.shape
    out = torch.empty((m, k), dtype=torch.float64, device=q.device)
    norms = torch.empty((m, k), dtype=torch.float64, device=q.device) if scale else None
    rows_a_block = max(1, _PAIR_BLOCK // max(k, 1))
    for s in range(0, m, rows_a_block):
        idb = ids[s:s + rows_a_block].to(torch.int64)
        ok = (idb >= 0) & (idb < n)
        rows = x[idb.clamp(0, n - 1)].to(torch.float64)
        qb = q[s:s + rows_a_block].to(torch.float64)
        diff = rows - qb[:, None, :]
        d = (diff * diff).sum(dim=-1)
        out[s:s + rows_a_block] = torch.where(ok, d, torch.inf)
        if scale:
            norms[s:s + rows_a_block] = (rows * rows).sum(dim=-1) + (qb * qb).sum(dim=-1)[:, None]
    return (out, norms) if scale else out


def _screen(x, q, width: int, dtype):
    """The ``width`` smallest ``|x|^2 - 2 q.x`` of each query, computed in
    ``dtype``, over row blocks: (values float32, ids int64)."""
    m = q.shape[0]
    qd = q.to(dtype)
    best_v = torch.full((m, 0), torch.inf, device=q.device)
    best_i = torch.zeros((m, 0), dtype=torch.int64, device=q.device)
    for r0 in range(0, x.shape[0], _ROW_BLOCK):
        xb = x[r0:r0 + _ROW_BLOCK].to(dtype)
        xn = (xb * xb).sum(dim=1, dtype=dtype)
        s = (xn[None, :] - 2 * (qd @ xb.T)).to(torch.float32)
        w = min(width, s.shape[1])
        v, i = torch.topk(s, w, dim=1, largest=False)
        best_v = torch.cat([best_v, v], dim=1)
        best_i = torch.cat([best_i, i + r0], dim=1)
        if best_v.shape[1] > width:
            best_v, pos = torch.topk(best_v, width, dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pos)
    return best_v, best_i


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int, screen: int = 64):
    """Exact k nearest rows of ``x`` to each query: (distances float64 (m, k)
    ascending, ids int64 (m, k))."""
    out_d, out_i = [], []
    with full_f32():
        for s in range(0, q.shape[0], _Q_BLOCK):
            qb = q[s:s + _Q_BLOCK]
            _, cand = _screen(x, qb, max(screen, k), torch.float32)
            d = distances(x, qb, cand)
            d, pos = torch.sort(d, dim=1, stable=True)
            out_d.append(d[:, :k])
            out_i.append(torch.gather(cand, 1, pos[:, :k]))
    return torch.cat(out_d), torch.cat(out_i)


def knn_lower(x: torch.Tensor, q: torch.Tensor, k: int):
    """The control: the same k-nearest search with rows, queries, products
    and distances in bfloat16. Returns (distances float32 (m, k), ids
    int64), both as the bfloat16 arithmetic gives them."""
    out_d, out_i = [], []
    for s in range(0, q.shape[0], _Q_BLOCK):
        qb = q[s:s + _Q_BLOCK]
        v, i = _screen(x, qb, k, torch.bfloat16)
        qn = (qb.to(torch.bfloat16) ** 2).sum(dim=1, dtype=torch.bfloat16)
        out_d.append((v.to(torch.bfloat16) + qn[:, None]).to(torch.float32))
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)
