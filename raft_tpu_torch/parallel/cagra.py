"""Multi-device CAGRA: one graph index per dataset shard, beam searches run
shard-local, candidates merge across the ranks.

Counterpart of raft_tpu/parallel/cagra.py. A CAGRA graph cannot be
row-sharded naively (pruned edges cross arbitrary rows, so a beam on one
device would keep dereferencing rows on another). The multi-GPU pattern of
the reference's ecosystem (per-GPU indexes over dataset partitions, query
fan-out, heap merge: raft::comms + knn_merge_parts) maps onto the ranks:
each shard owns an independent CAGRA graph over its rows (each rank builds
its own), searches run every query against every shard's graph, one rank
a shard, and one all-gather + ``_select_k`` gives the global top-k. The
merged result's recall is at least the per-shard recall: every shard
contributes its own local top-k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..comms.comms import Comms
from ..core import tracing
from ..core.errors import expects
from ..distance.types import DistanceType, resolve_metric
from ..neighbors.cagra import (CagraIndex, IndexParams, SearchParams, _cagra_search,
                               estimate_seed_pool, resolve_hop_impl,
                               resolve_max_iterations, resolve_seed_pool)
from ..neighbors.cagra import build as build_single
from ..obs.instrument import instrument, nrows
from ._progcache import ProgramCache, memo
from .knn import _merge

__all__ = ["ShardedCagraIndex", "from_state", "build", "build_merged", "merged_builder",
           "search"]

# the ranks' memoized shard slices, releasable per communicator
# (parallel.release_programs)
_PROGRAMS = ProgramCache(maxsize=256)


@dataclasses.dataclass
class ShardedCagraIndex:
    """Stacked per-shard CAGRA indexes: shard s owns dataset rows
    [s*rows_per_shard, (s+1)*rows_per_shard) of the original order."""

    dataset: torch.Tensor   # (S, n/S, d): float32, or int8 for byte datasets
    graph: torch.Tensor     # (S, n/S, graph_degree) int32, shard-local ids
    metric: DistanceType = DistanceType.L2Expanded
    # "float32" | "int8" | "uint8": the contract of CagraIndex.data_kind
    data_kind: str = "float32"

    @property
    def n_shards(self) -> int:
        return self.dataset.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.dataset.shape[1]

    @property
    def dim(self) -> int:
        return self.dataset.shape[2]


def from_state(arrays: dict, device="cuda", **meta) -> ShardedCagraIndex:
    """A :class:`ShardedCagraIndex` from another index's state: its
    ``dataset`` (S, n/S, d) and ``graph`` (S, n/S, degree) as numpy arrays,
    and its ``metric`` and ``data_kind`` as keywords, placed on ``device``."""
    expects(set(arrays) == {"dataset", "graph"},
            "from_state: expected arrays {'dataset', 'graph'}, got %s", sorted(arrays))
    if "metric" in meta:
        m = meta["metric"]
        meta["metric"] = (DistanceType(int(m)) if isinstance(m, (int, np.integer))
                          else resolve_metric(m))
    dev = torch.device(device)
    return ShardedCagraIndex(
        dataset=torch.from_numpy(np.ascontiguousarray(arrays["dataset"])).to(dev),
        graph=torch.from_numpy(np.ascontiguousarray(arrays["graph"], np.int32)).to(dev),
        **meta)


def _shard_res(comms: Comms, res):
    from ..core.resources import Resources

    return res if res is not None else Resources(device=comms.device)


@instrument("parallel.cagra.build",
            items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["dataset"]),
            labels=lambda a, kw: {"size": (a[0] if a else kw["comms"]).size()})
def build(comms: Comms, params: IndexParams, dataset, res=None) -> ShardedCagraIndex:
    """Build one CAGRA graph per shard: rank r builds shard r on its device
    (``res``, by default the rank's), and the shards are all-gathered, so
    every rank returns the whole stacked index."""
    n = int(dataset.shape[0])
    size = comms.size()
    expects(n % size == 0, "dataset rows (%d) must divide the mesh axis (%d); pad first",
            n, size)
    rows = n // size
    expects(params.graph_degree < rows, "graph_degree must be < rows per shard (%d)", rows)
    lo = comms.rank() * rows
    with tracing.range("parallel.cagra.build.shards"):
        shard = build_single(params, dataset[lo:lo + rows], res=_shard_res(comms, res))
    return ShardedCagraIndex(
        dataset=comms.allgather(shard.dataset),
        graph=comms.allgather(shard.graph),
        metric=shard.metric,
        data_kind=shard.data_kind,
    )


def _shard_bounds(n: int, size: int) -> list[tuple[int, int]]:
    """Contiguous near-equal shard row ranges; the first ``n % size`` shards
    carry one extra row. No divisibility requirement: uneven live-row
    counts (the compaction-rebuild case) need no padding."""
    base, extra = divmod(n, size)
    bounds, lo = [], 0
    for s in range(size):
        hi = lo + base + (1 if s < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _gather_uneven(comms: Comms, t, bounds):
    """Every rank's ``t`` (its bound's rows) concatenated in rank order:
    padded to the longest part for the all-gather, then trimmed."""
    longest = max(hi - lo for lo, hi in bounds)
    pad = longest - t.shape[0]
    if pad:
        t = torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                                      device=t.device)])
    parts = comms.allgather(t)
    return torch.cat([parts[s, :hi - lo] for s, (lo, hi) in enumerate(bounds)])


@instrument("parallel.cagra.build_merged",
            items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["dataset"]),
            labels=lambda a, kw: {"size": (a[0] if a else kw["comms"]).size()})
def build_merged(comms: Comms, params: IndexParams, dataset, res=None) -> CagraIndex:
    """Sharded CAGRA build merged into ONE plain :class:`CagraIndex`.

    Each of the S ranks builds an independent graph over its contiguous row
    range (in parallel across the ranks), then the per-shard graphs
    concatenate, edge ids offset to global, into one index over the whole
    dataset that every single-device consumer (``cagra.search``, the serve
    hooks, ``stream.MutableIndex``, save / load) takes unchanged. It is a
    build-speed lever: the build's dominant cost, the IVF-PQ self-search,
    grows faster than linearly with the rows it searches.

    Recall: the merged graph has no cross-shard edges, so ONE beam over it
    splits across S disconnected subgraphs; widen itopk by ~S/2-S/4 to hold
    the single-graph operating point, or search the per-shard composition
    (:func:`search` over :func:`build`'s ShardedCagraIndex). Keep shards
    above ~4k rows.
    """
    n = int(dataset.shape[0])
    size = comms.size()
    bounds = _shard_bounds(n, size)
    min_rows = min(hi - lo for lo, hi in bounds)
    expects(params.graph_degree < min_rows,
            "graph_degree (%d) must be < rows per shard (%d)",
            params.graph_degree, min_rows)
    lo, hi = bounds[comms.rank()]
    res = _shard_res(comms, res)
    with tracing.range("parallel.cagra.build_merged.shards"):
        shard = build_single(params, dataset[lo:hi], res=res)
    graph = _gather_uneven(comms, shard.graph + lo, bounds)
    merged = _gather_uneven(comms, shard.dataset, bounds)
    # the seed-pool hint re-estimated over the MERGED graph: local-mode
    # counts add across shards, so per-shard hints undercount by up to S x
    hint = estimate_seed_pool(merged, graph, seed=params.seed, res=res)
    return CagraIndex(dataset=merged, graph=graph, metric=shard.metric,
                      data_kind=shard.data_kind, seed_pool_hint=hint)


def merged_builder(comms: Comms, params: IndexParams):
    """A ``builder=`` callable for :class:`raft_tpu_torch.stream.MutableIndex`:
    a rebuild compaction constructs its successor with :func:`build_merged`.
    Every rank of ``comms`` must fold at the same time (the build is
    collective)."""
    def build_fn(dataset, res=None):
        return build_merged(comms, params, dataset, res=res)

    return build_fn


def _local_shard(comms: Comms, index: ShardedCagraIndex) -> CagraIndex:
    r = comms.rank()
    return CagraIndex(dataset=comms.put(index.dataset[r]).contiguous(),
                      graph=comms.put(index.graph[r]).contiguous(), metric=index.metric,
                      data_kind=index.data_kind)


def _search(comms: Comms, params: SearchParams, index: ShardedCagraIndex, queries, k: int,
            pool_ids=None):
    """:func:`search`; ``pool_ids`` hands every shard's beam the same entry
    pool (``cagra._cagra_search``'s override of its random draw)."""
    from ..neighbors.brute_force import _coerce_queries

    size = comms.size()
    expects(index.n_shards == size, "index has %d shards but mesh axis is %d",
            index.n_shards, size)
    queries = comms.put(queries)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "query dim mismatch")
    expects(k <= params.itopk_size, "k must be <= itopk_size")
    expects(isinstance(params.seed, (int, np.integer)),
            "SearchParams.seed must be an int here, got %r", params.seed)
    queries = _coerce_queries(index.data_kind, queries)
    shard = memo(_PROGRAMS, comms, "cagra", index, lambda: _local_shard(comms, index))
    # the single-device resolution: -1 (auto) must not reach _cagra_search
    # (per-shard indexes carry no seed_pool_hint, so auto takes the
    # default), and hop_impl takes the cagra_hop kernel where eligible
    seed_pool = resolve_seed_pool(params)
    hop_impl = resolve_hop_impl(params, shard.graph_degree, shard.dim)
    sqrt_out = index.metric in (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
    with tracing.range("parallel.cagra.local_search"):
        d_loc, i_loc = _cagra_search(shard, queries, int(k), int(params.itopk_size),
                                     int(resolve_max_iterations(params)),
                                     int(params.search_width), sqrt_out, seed_pool, hop_impl,
                                     seed=int(params.seed), pool_ids=pool_ids)
    return _merge(comms, d_loc, i_loc, int(k), index.metric != DistanceType.InnerProduct,
                  comms.rank() * index.rows_per_shard, "cagra")


@instrument("parallel.cagra.search",
            items=lambda a, kw: nrows(a[3] if len(a) > 3 else kw["queries"]),
            labels=lambda a, kw: {"k": a[4] if len(a) > 4 else kw["k"],
                                  "size": (a[0] if a else kw["comms"]).size()})
def search(comms: Comms, params: SearchParams, index: ShardedCagraIndex, queries, k: int):
    """Distributed CAGRA search: rank r runs the beam search over shard r
    (the ``cagra_hop`` kernel on the card), then the all-gather + select
    merge. Returns (distances (m, k), global ids (m, k)), equal on every
    rank; ids refer to the original (pre-sharding) row order."""
    return _search(comms, params, index, queries, k)
