"""Multi-device exact kNN: shard the dataset, search locally, merge globally.

Counterpart of raft_tpu/parallel/knn.py. The reference leaves multi-GPU kNN
to users composing raft::comms + per-shard search + knn_merge_parts
(docs/source/using_comms.rst). Here every rank takes its block of the
dataset's rows, runs the local brute-force search on it (the ``fused_knn``
kernel where :func:`~raft_tpu_torch.neighbors.brute_force._fused_eligible`
allows, the GEMM + routed top-k otherwise), and one all-gather of the
(m, k) candidates + ``_select_k`` over (m, S·k) in rank order gives every
rank the global result (detail/knn_merge_parts.cuh): candidates cross the
ranks, never the distance matrix. Rank order is global-id order, so ties go
to the lowest global id, as each shard's do.

A non-divisible dataset pads itself: the tail shard's extra rows are
masked, so callers never see the divisibility invariant. A rank slices its
block on every call (a view when the dataset is on its device and n divides
S), so a dataset changed in place is searched as it is now.
"""

from __future__ import annotations

import torch

from ..comms.comms import Comms
from ..core import tracing
from ..core.errors import expects
from ..distance.types import DistanceType, resolve_metric
from ..matrix.select_k import _select_k
from ..neighbors.brute_force import _bf_knn, _bf_knn_fused, _fused_eligible
from ..obs.instrument import instrument, nrows

__all__ = ["knn"]

_KEPT = (torch.float32, torch.bfloat16, torch.float16)


def _local_block(comms: Comms, dataset, n: int, n_pad: int, shard_rows: int):
    """This rank's rows of ``dataset`` padded to ``shard_rows`` on its device,
    and their keep mask (None when nothing is padded)."""
    lo = comms.rank() * shard_rows
    hi = min(lo + shard_rows, n)
    rows = dataset[lo:hi] if lo < n else dataset[:0]
    x = comms.put(rows)
    if x.dtype not in _KEPT:
        x = x.to(torch.float32)
    if n_pad == n:
        return x.contiguous(), None
    pad = shard_rows - x.shape[0]
    x = torch.cat([x, torch.zeros((pad, x.shape[1]), dtype=x.dtype, device=x.device)])
    keep = torch.arange(lo, lo + shard_rows, device=x.device) < n
    return x, keep


def _merge(comms: Comms, d_loc, i_loc, k: int, select_min: bool, offset: int,
           what: str = "knn"):
    """Global ids (local + ``offset``; -1 stays), one all-gather each of
    distances and ids, and the (m, S·k) select in rank order."""
    with tracing.range(f"parallel.{what}.merge"):
        i_glob = torch.where(i_loc >= 0, i_loc + offset, -1).to(torch.int32)
        d_all = comms.allgather(d_loc)
        i_all = comms.allgather(i_glob)
        m = d_loc.shape[0]
        size = comms.size()
        d_flat = d_all.movedim(0, 1).reshape(m, size * k)
        i_flat = i_all.movedim(0, 1).reshape(m, size * k)
        return _select_k(d_flat, i_flat, k, select_min)


@instrument("parallel.knn",
            items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["queries"]),
            labels=lambda a, kw: {"k": a[3] if len(a) > 3 else kw["k"],
                                  "size": (a[0] if a else kw["comms"]).size()})
def knn(comms: Comms, dataset, queries, k: int, metric="sqeuclidean", metric_arg: float = 2.0,
        tile: int = 2048, inner_tile: int = 512, compute: str = "float32"):
    """Distributed exact kNN (multi-device analogue of brute_force.knn).

    Every rank of ``comms`` calls with the global ``dataset`` (n, d) and
    ``queries`` (m, d); rank r searches rows [r·n/S, (r+1)·n/S) (a
    non-divisible n is padded with masked rows). ``compute`` selects the
    local kernel's contraction mode ("float32" | "float32x3" | "bfloat16",
    as brute_force.knn). Returns (distances (m, k), global indices (m, k)),
    equal on every rank, on the rank's device. ``k`` must fit one shard's
    rows (the per-shard candidate width of the merge).
    """
    n, d = (int(s) for s in dataset.shape)
    size = comms.size()
    n_pad = -(-n // size) * size
    shard_rows = n_pad // size
    expects(0 < k <= shard_rows,
            "k=%d must be <= per-shard rows (%d rows over %d shards)",
            k, shard_rows, size)
    mt = resolve_metric(metric)
    x_shard, keep = _local_block(comms, dataset, n, n_pad, shard_rows)
    q = comms.put(queries)
    if q.dtype not in _KEPT:
        q = q.to(torch.float32)
    with tracing.range("parallel.knn.local_search"):
        if _fused_eligible(mt, int(k), shard_rows, d, "exact", compute):
            d_loc, i_loc = _bf_knn_fused(x_shard, q, int(k), mt, compute, keep)
        else:
            comp = "float32" if compute == "float32x3" else compute
            d_loc, i_loc = _bf_knn(x_shard, q, int(k), mt, float(metric_arg),
                                   min(tile, q.shape[0]), inner_tile, keep, compute=comp)
    return _merge(comms, d_loc, i_loc, int(k), mt != DistanceType.InnerProduct,
                  comms.rank() * shard_rows)
