"""CAGRA: graph-based approximate nearest neighbours.

Counterpart of raft_tpu/neighbors/cagra.py (reference:
cpp/include/raft/neighbors/cagra.cuh; build detail/cagra/cagra_build.cuh,
graph_core.cuh; search detail/cagra/search_plan.cuh). The same index and the
same algorithm:

- **Build**: an IVF-PQ index over the dataset, searched with the dataset as
  its queries (k = intermediate_graph_degree * refine_rate + 1), an exact
  refine to intermediate_graph_degree + 1 and the self-edge dropped: the knn
  graph, in chunks of ``build_chunk`` rows, with the JAX package's measured
  probe autotune. Then detour-count pruning (a batched membership test over
  neighbour lists), the reverse-edge merge, and the seed-pool estimate from
  the knn graph's neighbour-distance jumps.
- **Search**: a beam search over the whole query batch in lockstep. Each hop
  expands the best ``search_width`` unvisited beam entries, reads their
  graph rows, scores the candidates exactly and merges them into the beam.
  ``hop_impl="xla"`` runs the hop as plain PyTorch (gather, batched product,
  two-sort dedup); the ``fused*`` impls (and "auto" where the shape is
  eligible) run one ``cagra_hop`` kernel launch per hop (ops/cagra_hop.py),
  which on a CPU tensor runs its plain version. The loop's exit test reads
  one flag per hop back to the host.

Entry points run on the handle's device ("cuda" unless the caller passes
``Resources(device="cpu")``); an index lives on its dataset's device. Files
are the JAX package's ``cagra`` section of ``raft_tpu/13``, byte for byte,
and :func:`from_state` takes a JAX index's arrays as numpy. The search's
entry pool is drawn by a ``torch.Generator`` seeded from
``SearchParams.seed``: the same seed gives bitwise the same results on one
device, but not the JAX package's pool.

An int8 / uint8 dataset builds on its float32 image and is stored and
searched as signed bytes (``cagra_hop`` reads int8 rows).

A chunked reader (:mod:`raft_tpu_torch.core.chunked`) builds out of core: the
corpus streams onto the device through the staged chunks, then the graph
builds as in-core. Armed memory budgets gate the build on ``obs.mem.plan()``.

An index with a tune decision attached (``index.tuned``) serves its pinned
operating point through ``batched_searcher`` (:mod:`raft_tpu_torch.tune.apply`).
The distributed CAGRA build waits for ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time

import numpy as np
import torch

from ..config import auto_convert_output
from ..core import chunked, tracing
from ..core.chunked import is_reader
from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..core.serialize import (atomic_write, check_header, deserialize_mdspan,
                              deserialize_scalar, deserialize_tuned, serialize_header,
                              serialize_mdspan, serialize_scalar, serialize_tuned)
from ..distance.pairwise import full_f32
from ..distance.types import DistanceType, resolve_metric
from ..matrix.select_k import _select_k, select_k_impl
from ..obs import build as obs_build
from ..obs import mem as obs_mem
from ..obs import metrics as obs_metrics
from ..obs.instrument import dtype_of, instrument, nrows
from . import ivf_pq as ivf_pq_mod
from .ivf_pq import _L2_METRICS, _SQRT_METRICS
from .refine import refine

__all__ = ["IndexParams", "SearchParams", "CagraIndex", "build", "search",
           "build_knn_graph", "optimize", "estimate_seed_pool", "save", "load",
           "write_index", "read_index", "from_state", "batched_searcher"]

logger = logging.getLogger("raft_tpu_torch")

_HOP_IMPLS = ("auto", "xla", "fused", "fused_arena", "fused_arena_smem")
_MERGE_OF = {"fused": "extract", "fused_arena": "arena", "fused_arena_smem": "arena_smem"}


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Reference: cagra::index_params (cagra_types.hpp:48-64); the JAX
    package's fields and defaults (raft_tpu/neighbors/cagra.py:60)."""

    intermediate_graph_degree: int = 64
    graph_degree: int = 32
    metric: str | DistanceType = "sqeuclidean"
    build_pq_bits: int = 0        # 0: 4 where the default pq_dim >= 32, else 8
    build_n_lists: int = 0        # 0: sqrt(n)
    build_n_probes: int = 0       # 0: the measured autotune (32, then 8 / 16 / 32)
    refine_rate: float = 3.0
    build_chunk: int = 16384
    build_select_impl: str = "auto"
    build_kmeans_train_mode: str = "auto"
    build_kmeans_batch_rows: int = 65536
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Reference: cagra::search_params (cagra_types.hpp:66-120); the JAX
    package's fields and defaults (raft_tpu/neighbors/cagra.py:129).

    ``seed_pool``: -1 the index's hint (else 16,384), 0 random entries, > 0
    a scored pool of that size. ``hop_impl``: "auto" ("fused_arena" where
    :func:`~raft_tpu_torch.ops.cagra_hop.hop_shapes_eligible` holds, else
    "xla"), "fused_arena", "fused_arena_smem" (runs as "fused_arena"),
    "fused" (the extract merge) or "xla". ``seed``: an int; the same seed
    searches the same entry pool."""

    itopk_size: int = 64
    max_iterations: int = 0
    search_width: int = 1
    seed_pool: int = -1
    hop_impl: str = "auto"
    seed: int = 0


@dataclasses.dataclass
class CagraIndex:
    """Reference: cagra::index (cagra_types.hpp:123-220): the dataset (n, d)
    float32, or int8 for byte datasets (uint8 held shifted by -128), and the
    fixed-degree graph (n, graph_degree) int32, on one device."""

    dataset: torch.Tensor
    graph: torch.Tensor
    metric: DistanceType = DistanceType.L2Expanded
    data_kind: str = "float32"    # "float32" | "int8" | "uint8"
    seed_pool_hint: int = 0       # measured at build; 0: no clump structure seen
    tuned: dict | None = None

    @property
    def device(self) -> torch.device:
        return self.dataset.device

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]


def from_state(arrays: dict, res: Resources | None = None, **meta) -> CagraIndex:
    """A :class:`CagraIndex` from another index's state: its ``dataset`` and
    ``graph`` as numpy arrays, and its ``metric``, ``data_kind``,
    ``seed_pool_hint`` and ``tuned`` as keywords. Placed on the handle's
    device; searches answer as the index that gave the state does."""
    res = res or default_resources()
    expects(set(arrays) == {"dataset", "graph"},
            "from_state: expected arrays {'dataset', 'graph'}, got %s", sorted(arrays))
    if "metric" in meta:
        m = meta["metric"]
        meta["metric"] = (DistanceType(int(m)) if isinstance(m, (int, np.integer))
                          else resolve_metric(m))
    return CagraIndex(dataset=res.put(arrays["dataset"]),
                      graph=res.put(arrays["graph"], torch.int32), **meta)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def knn_build_plan(params: IndexParams, n: int, d: int):
    """(k, gpu_top_k, n_lists, pq_bits) of the knn-graph build."""
    k = params.intermediate_graph_degree
    gpu_top_k = min(int(k * params.refine_rate), n - 1)
    n_lists = params.build_n_lists or max(int(n ** 0.5), 8)
    n_lists = min(n_lists, n // 4 if n >= 32 else n)
    pq_bits = params.build_pq_bits or (
        4 if ivf_pq_mod._default_pq_dim(d, 8) >= 32 else 8)
    return k, gpu_top_k, n_lists, pq_bits


def _build_chunk_step(x, pq, xb, rows, n_probes: int, gpu_top_k: int, k: int, metric,
                      res: Resources, select_impl: str = "auto"):
    """One knn-graph chunk: PQ search at gpu_top_k + 1, exact refine to
    k + 1, then the row's own id dropped (the first k other ids, in rank
    order)."""
    sp = ivf_pq_mod.SearchParams(n_probes=n_probes, select_impl=select_impl)
    _, cand = ivf_pq_mod.search.native(sp, pq, xb, gpu_top_k + 1, res=res)
    _, refined = refine(x, xb, cand, k + 1, metric=metric, res=res)
    rank = torch.arange(k + 1, device=refined.device).expand_as(refined)
    big = torch.where(refined == rows[:, None], torch.iinfo(torch.int32).max, rank)
    order = torch.argsort(big, dim=1, stable=True)[:, :k]
    return torch.gather(refined, 1, order)


def build_knn_graph(params: IndexParams, dataset, res: Resources | None = None):
    """Stage 1 (reference: build_knn_graph, cagra_build.cuh:42): IVF-PQ over
    the dataset, searched with queries = dataset in chunks, exact refine.
    Returns (n, intermediate_graph_degree) int32 on the handle's device.

    ``build_n_probes=0`` measures: chunk 0 runs at 32 probes; on 2,048 rows
    drawn uniformly (``np.random.default_rng(params.seed)``, as the JAX
    package draws them) 8 and then 16 probes are tried, and the first whose
    refined edge lists overlap the 32-probe lists >= 95% serves the other
    chunks."""
    res = res or default_resources()
    x = res.put(dataset, torch.float32)
    n, d = x.shape
    k, gpu_top_k, n_lists, pq_bits = knn_build_plan(params, n, d)
    pq = ivf_pq_mod.build(
        ivf_pq_mod.IndexParams(
            n_lists=n_lists, metric=params.metric, pq_bits=pq_bits,
            kmeans_train_mode=params.build_kmeans_train_mode,
            kmeans_batch_rows=params.build_kmeans_batch_rows, seed=params.seed),
        x, res=res)
    chunk = max(int(params.build_chunk), 1)
    mt = resolve_metric(params.metric)

    def step(rows, probes):
        return _build_chunk_step(x, pq, x[rows.to(torch.int64)], rows, probes, int(gpu_top_k),
                                 int(k), mt, res, params.build_select_impl)

    def span(s):
        return torch.arange(s, min(s + chunk, n), dtype=torch.int32, device=x.device)

    probes = int(params.build_n_probes)
    parts = []
    if probes == 0:
        probes = 32
        parts.append(step(span(0), 32))
        if n > chunk:
            t_rows = min(2048, chunk, n)
            rng = np.random.default_rng(params.seed)
            sample = np.sort(rng.choice(n, size=t_rows, replace=False))
            rt = torch.from_numpy(sample.astype(np.int32)).to(x.device)
            wide = step(rt, 32).cpu().tolist()
            for p_try in (8, 16):
                trial = step(rt, p_try).cpu().tolist()
                overlap = float(np.mean([len(set(a) & set(b)) / len(a)
                                         for a, b in zip(trial, wide)]))
                if overlap >= 0.95:
                    probes = p_try
                    logger.info("cagra build_n_probes auto: p=%d edge lists overlap p=32 at "
                                "%.3f; using %d probes for the remaining chunks",
                                p_try, overlap, p_try)
                    break
            else:
                logger.info("cagra build_n_probes auto: keeping 32 probes (cheaper settings "
                            "overlapped < 0.95)")
    for s in range(chunk if parts else 0, n, chunk):
        parts.append(step(span(s), probes))
    return (torch.cat(parts) if len(parts) > 1 else parts[0]).to(torch.int32)


def _prune_graph(graph, out_degree: int, tile: int):
    """Stage 2 (reference: optimize / kern_prune, graph_core.cuh:128). Edge
    u -> v_j is detourable through each higher-ranked neighbour w_i (i < j)
    that also lists v_j; keep the out_degree edges of fewest detours, ties
    by rank, in rank order. The (tile, k, k, k) membership test runs per
    tile of rows."""
    n, k = graph.shape
    g64 = graph.to(torch.int64)
    rank_lt = torch.ones((k, k), dtype=torch.bool, device=graph.device).tril(-1).T
    rank = torch.arange(k, device=graph.device)
    out = []
    for t0 in range(0, n, tile):
        g = g64[t0:t0 + tile]                                  # (t, k)
        hit = (g[:, None, :, None] == g64[g][:, :, None, :]).any(-1)  # [u, i, j]
        detours = (hit & rank_lt).sum(dim=1)                   # (t, k)
        keep = torch.argsort(detours * k + rank, dim=1)[:, :out_degree]
        out.append(torch.gather(g, 1, torch.sort(keep, dim=1).values))
    return torch.cat(out).to(torch.int32)


def _reverse_merge(graph, out_degree: int):
    """Reverse-edge merge (reference: graph_core.cuh optimize tail): the
    first half of each row keeps the pruned forward edges, the second half
    takes the node's strongest incoming edges (lowest rank in the source's
    list), found by one stable sort of edges by destination * degree + rank
    and a binary search per node; slots short of reverse edges fall back to
    the remaining forward edges."""
    n, k = graph.shape
    fwd_keep = out_degree - out_degree // 2
    rev_keep = out_degree // 2
    expects(n * k < 2 ** 31, "reverse merge packs dst*degree+rank into int32; "
            "n*degree=%d overflows — shard the graph first", n * k)
    dev = graph.device
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    key = (graph.reshape(-1).to(torch.int32) * k
           + torch.arange(k, dtype=torch.int32, device=dev).repeat(n))
    s_key, order = torch.sort(key, stable=True)
    s_src = src[order]
    starts = torch.searchsorted(s_key, torch.arange(n, dtype=torch.int32, device=dev) * k,
                                right=False)
    ends = torch.cat([starts[1:], torch.tensor([n * k], dtype=starts.dtype, device=dev)])
    take = starts[:, None] + torch.arange(rev_keep, device=dev)[None, :]
    rev = torch.where(take < ends[:, None], s_src[take.clamp_max(n * k - 1)], -1)
    fill = graph[:, fwd_keep:fwd_keep + rev_keep]
    if fill.shape[1] < rev_keep:
        fill = torch.nn.functional.pad(fill, (0, rev_keep - fill.shape[1]), value=-1)
    tail = torch.where(rev >= 0, rev, fill)
    tail = torch.where(tail >= 0, tail, graph[:, :rev_keep])
    return torch.cat([graph[:, :fwd_keep], tail], dim=1).to(torch.int32)


def optimize(knn_graph, out_degree: int, res: Resources | None = None):
    """Prune + reverse merge (reference: cagra::optimize -> graph_core.cuh).
    Integer only: on the same knn graph it equals the JAX package's."""
    res = res or default_resources()
    g = res.put(knn_graph, torch.int32)
    expects(out_degree <= g.shape[1], "out_degree must be <= input degree")
    k = g.shape[1]
    tile = max(min(g.shape[0], res.workspace_bytes // max(k * k * k, 1)), 8)
    return _reverse_merge(_prune_graph(g, out_degree, min(tile, 4096)), out_degree)


def _neighbor_dist_profile(x, knn_graph, sample_ids):
    """Sorted squared L2 from sampled rows to their knn-graph neighbours."""
    xs = x[sample_ids].to(torch.float32)
    vecs = x[knn_graph[sample_ids].to(torch.int64)].to(torch.float32)
    return torch.sort(((vecs - xs[:, None, :]) ** 2).sum(dim=-1), dim=1).values


# the neighbour-distance jump (squared-distance ratio) that marks a clump
# boundary; calibrated in the JAX package (estimate_seed_pool's docstring)
_SEED_JUMP_RATIO = 2.0


def estimate_seed_pool(dataset, knn_graph, seed: int = 0,
                       res: Resources | None = None) -> int:
    """Measured seed-pool size (the JAX package's rule): on 2,048 sampled
    rows, the largest ratio between consecutive sorted neighbour distances
    marks a clump boundary when it is >= 2; if half the rows show one, the
    median position gives the clump size s, n / s the number of local modes
    M, and the hint is the power of two >= 2M (capped at 131,072), or 0
    where the default pool of 16,384 already covers them. Runs on the
    handle's device."""
    res = res or default_resources()
    x = res.put(dataset)
    g = res.put(knn_graph)
    n = x.shape[0]
    if n < 4096 or g.shape[1] < 8:
        return 0
    t = min(2048, n)
    rng = np.random.default_rng(seed)
    sample = torch.from_numpy(np.sort(rng.choice(n, size=t, replace=False))).to(x.device)
    d2 = _neighbor_dist_profile(x, g, sample).cpu().numpy()
    floor = max(float(np.median(d2[:, -1])), 1e-30) * 1e-6
    d2 = np.maximum(d2, floor)
    ratios = d2[:, 1:] / d2[:, :-1]
    jump = ratios.max(axis=1)
    pos = ratios.argmax(axis=1) + 1
    clumpy = jump >= _SEED_JUMP_RATIO
    frac = float(np.mean(clumpy))
    if frac < 0.5:
        logger.info("cagra seed_pool auto: no clump structure (%.0f%% of sampled rows show "
                    "a >=%.0fx neighbor-distance jump; median max-ratio %.2f); default pool",
                    frac * 100, _SEED_JUMP_RATIO, float(np.median(jump)))
        return 0
    s = float(np.median(pos[clumpy])) + 1.0
    modes = n / s
    pool = 1 << int(np.ceil(np.log2(max(2.0 * modes, 1.0))))
    pool = int(min(max(pool, 0), 131072))
    if pool <= 16384:
        logger.info("cagra seed_pool auto: clump size ~%.0f -> ~%.0f modes; default pool "
                    "covers them", s, modes)
        return 0
    logger.info("cagra seed_pool auto: %.0f%% of rows jump >=%.0fx at median position %.0f "
                "-> ~%.0f local modes -> seed_pool_hint=%d",
                frac * 100, _SEED_JUMP_RATIO, s, modes, pool)
    return pool


def _phase_seconds(phase: str, t0: float, out) -> None:
    """Observe ``raft_tpu_build_phase_seconds{phase=...}`` since ``t0``
    (``time.perf_counter``), after the device has finished ``out``; nothing
    while metrics are off."""
    if obs_metrics.enabled():
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        obs_build.build_phase().observe(time.perf_counter() - t0, phase=phase)


@instrument("cagra.build",
            items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["dataset"]),
            labels=lambda a, kw: {
                "dtype": dtype_of(a[1] if len(a) > 1 else kw["dataset"])})
def build(params: IndexParams, dataset, res: Resources | None = None) -> CagraIndex:
    """Full CAGRA build (reference: cagra::build, cagra.cuh) on the
    handle's device: knn graph, seed-pool estimate, then optimize to
    ``graph_degree``. An int8 / uint8 dataset is stored as signed bytes
    (uint8 shifted by -128) and searched over them; the graph is built on
    its float32 image, as the JAX package builds it. A chunked reader
    (:mod:`raft_tpu_torch.core.chunked`) streams onto the device and then
    builds as in-core, to the same dataset and graph bit for bit."""
    res = res or default_resources()
    stream = is_reader(dataset)
    if stream:
        # out-of-core ingest: the streamed upload priced against both
        # budgets, then the corpus lands on the device whole through the
        # staged chunk pipeline (the graph build runs in-core: the dataset
        # is CAGRA's scan operand)
        n, d = (int(s) for s in dataset.shape)
        dt = chunked.device_dtype(dataset.dtype)
        pl = obs_mem.plan("cagra", params, n, d,
                          dtype=str(dt) if dt in (np.int8, np.uint8) else "float32",
                          streamed=True, chunk_rows=dataset.chunk_rows)
        obs_mem.gate(res, pl["build_peak_bytes"], site="build_stream",
                     host_bytes=pl["host_peak_bytes"], detail=f"cagra {n}x{d} streamed")
        dataset = chunked.device_materialize(dataset, kind="cagra", device=res.torch_device)
    x = res.put(dataset)
    expects(x.ndim == 2, "dataset must be (n, d)")
    expects(params.graph_degree <= params.intermediate_graph_degree,
            "graph_degree must be <= intermediate_graph_degree")
    mt = resolve_metric(params.metric)
    expects(mt in _L2_METRICS, "cagra supports L2 metrics (reference parity), got %s", mt.name)
    kind = "float32"
    if x.dtype in (torch.int8, torch.uint8):
        from .brute_force import _as_signed, _dtype_name

        kind = _dtype_name(x)
        x = _as_signed(x).contiguous()      # stored (and scored) in the signed domain
        xf = x.to(torch.float32)
    else:
        x = xf = x.to(torch.float32).contiguous()
    # memory-budget admission, before the knn-graph self-search spends
    # anything (the streamed gate above priced the chunked upload)
    if not stream:
        obs_mem.gate(res, lambda: obs_mem.plan("cagra", params, x.shape[0], x.shape[1],
                                               dtype=kind)["index_bytes"],
                     site="build", detail=f"cagra {x.shape[0]}x{x.shape[1]}")
    with tracing.range("cagra.build.knn_graph"):
        t0 = time.perf_counter()
        knn_graph = build_knn_graph(params, xf, res=res)
        _phase_seconds("cagra/knn_graph", t0, knn_graph)
    with tracing.range("cagra.build.seed_pool"):
        hint = estimate_seed_pool(xf, knn_graph, seed=params.seed, res=res)
    del xf
    with tracing.range("cagra.build.optimize"):
        t0 = time.perf_counter()
        graph = optimize(knn_graph, params.graph_degree, res=res)
        _phase_seconds("cagra/optimize", t0, graph)
    return CagraIndex(dataset=x, graph=graph, metric=mt, data_kind=kind, seed_pool_hint=hint)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def resolve_max_iterations(params: SearchParams) -> int:
    """Default hop budget (reference: adjust_search_params)."""
    return params.max_iterations or (params.itopk_size // max(params.search_width, 1) + 10)


def resolve_seed_pool(params: SearchParams, hint: int = 0) -> int:
    """seed_pool=-1 resolves to the index's hint, else 16,384."""
    pool = int(params.seed_pool)
    if pool < 0:
        pool = int(hint) or 16384
    return pool


def resolve_hop_impl(params: SearchParams, graph_degree: int, dim: int) -> str:
    """Validate and resolve ``params.hop_impl``. Unlike the JAX package it
    asks for no backend: the kernel's wrapper runs its plain version on a CPU
    tensor."""
    from ..ops.cagra_hop import MAX_D, hop_shapes_eligible

    expects(params.hop_impl in _HOP_IMPLS,
            "hop_impl must be 'auto', 'xla', 'fused', 'fused_arena' or "
            "'fused_arena_smem', got %r", params.hop_impl)
    eligible = hop_shapes_eligible(params.itopk_size, graph_degree, params.search_width, dim)
    if params.hop_impl == "auto":
        return "fused_arena" if eligible else "xla"
    if params.hop_impl in _MERGE_OF:
        expects(eligible, "hop_impl='fused' needs itopk + search_width*graph_degree <= 128 "
                "and d <= %d (the kernel's shared memory per block); got itopk=%d width=%d "
                "degree=%d d=%d", MAX_D, params.itopk_size, params.search_width,
                graph_degree, dim)
    return params.hop_impl


def _dedup_sort(ids, dists, visited):
    """Distance-sorted beam with duplicate ids killed (the closest copy
    kept): a stable (id, dist) lexsort, duplicates and negative ids to +inf,
    then a stable sort by distance, as the JAX package's two lax.sorts."""
    o = torch.sort(dists, dim=1, stable=True).indices
    ids, dists, visited = (torch.gather(a, 1, o) for a in (ids, dists, visited))
    o = torch.sort(ids, dim=1, stable=True).indices
    ids, dists, visited = (torch.gather(a, 1, o) for a in (ids, dists, visited))
    dup = torch.zeros_like(visited)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    dists = torch.where(dup | (ids < 0), math.inf, dists)
    o = torch.sort(dists, dim=1, stable=True).indices
    return tuple(torch.gather(a, 1, o) for a in (ids, dists, visited))


def _dist_to(data, dn2, qf, ids):
    """Squared L2 without |q|^2 from each query row of ``qf`` to the dataset
    rows ``ids`` (m, e): ``|v|^2 - 2 q.v``, the product in full float32."""
    ids = ids.to(torch.int64)
    with full_f32():
        dots = torch.bmm(data[ids].to(torch.float32), qf[:, :, None])[..., 0]
    return dn2[ids] - 2.0 * dots


def _xla_hop(data, dn2, qf, graph, beam_ids, beam_d, visited, itopk: int, width: int,
             keep_mask=None):
    """One hop of ``hop_impl="xla"``: pick the best ``width`` unvisited
    entries of the itopk window (stable argsort), gather their graph rows,
    score the candidates (:func:`_dist_to`), put them in the beam's tail and
    re-sort with :func:`_dedup_sort`. Returns the new (ids, dists, visited)
    and each row's no-candidate flag."""
    m = beam_ids.shape[0]
    deg = graph.shape[1]
    cand_d = torch.where(visited[:, :itopk], math.inf, beam_d[:, :itopk])
    pick = torch.argsort(cand_d, dim=1, stable=True)[:, :width]
    pick_ids = torch.gather(beam_ids, 1, pick)
    no_cand = torch.isinf(torch.gather(cand_d, 1, pick)).all(dim=1)
    visited = visited.scatter(1, pick, True)
    nbrs = graph[pick_ids.to(torch.int64).clamp_min(0)].reshape(m, width * deg)
    nbrs = torch.where(pick_ids.repeat_interleave(deg, dim=1) >= 0, nbrs, -1)
    ok = nbrs >= 0
    if keep_mask is not None:
        ok = ok & keep_mask[nbrs.to(torch.int64).clamp_min(0)]
    nd = torch.where(ok, _dist_to(data, dn2, qf, nbrs.clamp_min(0)), math.inf)
    beam_ids = torch.cat([beam_ids[:, :itopk], nbrs], 1)
    beam_d = torch.cat([beam_d[:, :itopk], nd], 1)
    visited = torch.cat([visited[:, :itopk], torch.zeros_like(ok)], 1)
    return (*_dedup_sort(beam_ids, beam_d, visited), no_cand)


def _cagra_search(index: CagraIndex, queries, k: int, itopk: int, max_iter: int,
                  search_width: int, sqrt_out: bool, seed_pool: int = 16384,
                  hop_impl: str = "xla", keep_mask=None, seed: int = 0, pool_ids=None):
    """The batch-synchronous beam search (the JAX package's
    ``_cagra_search``). ``pool_ids`` overrides the random draw: the scored
    entry pool (``seed_pool`` ids) where the pool is larger than the beam's
    entries, else the shared random entries; a test hands it the JAX
    package's draw.

    Spans (:mod:`raft_tpu_torch.core.tracing`): ``cagra.search`` over the
    call, with ``queries``, ``hops`` (loop iterations that launched a hop)
    and ``stop`` ("converged" where the flag ended the loop, else
    "max_iter"); under it ``cagra.search.entry``, ``cagra.search.hops`` (one
    ``cagra.hop`` an iteration, each with a ``cagra.hop.flag_read`` around
    the flag's device read) and ``cagra.search.finish``."""
    with tracing.range("cagra.search") as span:
        span.set("queries", queries.shape[0])
        qf = queries.to(torch.float32)
        with tracing.range("cagra.search.entry"):
            beam_ids, beam_d, visited = _entry_beam(index, qf, itopk, search_width, seed_pool,
                                                    keep_mask, seed, pool_ids)
        if hop_impl in _MERGE_OF:
            return _fused_loop(index, qf, beam_ids, beam_d, visited, k, itopk, max_iter,
                               search_width, sqrt_out, _MERGE_OF[hop_impl], keep_mask, span)
        data = index.dataset
        with tracing.range("cagra.search.hops"):
            dn2 = data.to(torch.float32).square().sum(dim=1)   # the hops reach rows anywhere
            hops, stop = 0, "max_iter"
            for _ in range(max_iter):
                with tracing.range("cagra.hop"):
                    beam_ids, beam_d, visited, no_cand = _xla_hop(
                        data, dn2, qf, index.graph, beam_ids, beam_d, visited, itopk,
                        search_width, keep_mask)
                    hops += 1
                    done = no_cand.all()
                    with tracing.range("cagra.hop.flag_read"):
                        done = bool(done)
                if done:
                    stop = "converged"
                    break
        span.set("hops", hops)
        span.set("stop", stop)
        with tracing.range("cagra.search.finish"):
            out_d = (beam_d[:, :k] + (qf * qf).sum(dim=1, keepdim=True)).clamp_min(0.0)
            if sqrt_out:
                out_d = torch.sqrt(out_d)
            return out_d, torch.where(torch.isinf(out_d), -1, beam_ids[:, :k])


def _entry_beam(index: CagraIndex, qf, itopk: int, width: int, seed_pool: int,
                keep_mask, seed: int, pool_ids):
    """The search's first beam for the float32 queries ``qf`` (ids,
    distances without |q|^2, visited), in ``_dedup_sort``'s order: the best
    entries of a scored pool, or shared random entries."""
    data = index.dataset
    n = data.shape[0]
    dev = data.device
    m = qf.shape[0]
    exp_per_hop = width * index.graph_degree

    n_init = min(max(itopk, exp_per_hop), n)
    pool = min(int(seed_pool), n)
    if pool_ids is None:
        g = torch.Generator(device=dev).manual_seed(int(seed))
        pool_ids = torch.randperm(n, generator=g, device=dev)[:max(pool, n_init)]
    pool_ids = torch.as_tensor(pool_ids).to(device=dev, dtype=torch.int64)
    # the entries: the best n_init of a scored pool, or n_init shared random
    # ids; either way only those rows' norms are taken
    scored = pool > n_init
    if scored:
        expects(pool_ids.shape == (pool,), "pool_ids must hold %d ids", pool)
    else:
        expects(pool_ids.shape[0] >= n_init, "pool_ids must hold %d ids", n_init)
        pool_ids = pool_ids[:n_init]
    px = data[pool_ids].to(torch.float32)
    with full_f32():
        init_d = px.square().sum(dim=1)[None, :] - 2.0 * (qf @ px.T)
    if keep_mask is not None:
        init_d = torch.where(keep_mask[pool_ids][None, :], init_d, math.inf)
    if scored:
        # the wide-select rule routes this (m, pool) select like any other
        init_d, best = select_k_impl(init_d, None, n_init, True, impl="auto")
        init_ids = pool_ids[best.to(torch.int64)]
    else:
        init_ids = pool_ids[None, :].expand(m, n_init)

    beam_w = itopk + exp_per_hop
    pad = beam_w - n_init
    beam_ids = torch.cat([init_ids.to(torch.int32),
                          torch.full((m, pad), -1, dtype=torch.int32, device=dev)], 1)
    beam_d = torch.cat([init_d, torch.full((m, pad), math.inf, device=dev)], 1)
    visited = torch.zeros((m, beam_w), dtype=torch.bool, device=dev)
    return _dedup_sort(beam_ids, beam_d, visited)


def _fused_loop(index, qf, beam_ids, beam_d, visited, k, itopk, max_iter, width, sqrt_out,
                merge, keep_mask, span):
    """The hop loop through ops.cagra_hop: one launch per hop, beam state
    (m, 128) with the full ||v - q||^2; one flag read back per hop. Sets
    ``hops`` and ``stop`` on the caller's ``cagra.search`` span."""
    from ..ops.cagra_hop import POOL, cagra_hop

    data, graph = index.dataset, index.graph
    n, deg = data.shape[0], index.graph_degree
    m, dev = qf.shape[0], qf.device
    with tracing.range("cagra.search.hops"):
        qn = (qf * qf).sum(dim=1, keepdim=True)
        bd = torch.full((m, POOL), math.inf, device=dev)
        bd[:, :itopk] = (beam_d[:, :itopk] + qn).clamp_min(0.0)
        bi = torch.full((m, POOL), -1, dtype=torch.int32, device=dev)
        bi[:, :itopk] = beam_ids[:, :itopk]
        bv = torch.ones((m, POOL), dtype=torch.int32, device=dev)
        bv[:, :itopk] = visited[:, :itopk].to(torch.int32)
        cw = width * deg
        qf = qf.contiguous()
        # prime: every candidate masked, so the merge only restates the beam
        # and the kernel emits the first hop's picks
        bd, bi, bv, pick, nocand = cagra_hop(
            qf, bd, bi, bv, torch.full((m, cw), -1, dtype=torch.int32, device=dev), data,
            torch.zeros((m, cw), dtype=torch.int32, device=dev), itopk, width, merge=merge)
        hops, stop = 0, "max_iter"
        for _ in range(max_iter):
            with tracing.range("cagra.hop"):
                # a row is done when its first pick found nothing unvisited
                done = (nocand[:, 0] > 0).all()
                with tracing.range("cagra.hop.flag_read"):
                    done = bool(done)
                if done:
                    stop = "converged"
                    break
                nbrs = graph[pick.to(torch.int64).clamp_max(n - 1)].reshape(m, cw)
                valid = (1 - nocand).repeat_interleave(deg, dim=1)
                if keep_mask is not None:
                    valid = valid * keep_mask[nbrs.to(torch.int64).clamp_min(0)].to(torch.int32)
                bd, bi, bv, pick, nocand = cagra_hop(qf, bd, bi, bv, nbrs.contiguous(), data,
                                                     valid.contiguous(), itopk, width,
                                                     merge=merge)
                hops += 1
    span.set("hops", hops)
    span.set("stop", stop)
    with tracing.range("cagra.search.finish"):
        if merge != "extract":
            bd, bi = _select_k(bd, bi, itopk, True)      # the arena is unsorted
        out_d = bd[:, :k].clamp_min(0.0)
        if sqrt_out:
            out_d = torch.sqrt(out_d)
        return out_d, torch.where(torch.isinf(out_d), -1, bi[:, :k])


@auto_convert_output
@instrument(
    "cagra.search",
    items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["queries"]),
    labels=lambda a, kw: {"k": a[3] if len(a) > 3 else kw["k"],
                          "itopk": (a[0] if a else kw["params"]).itopk_size},
)
def search(params: SearchParams, index: CagraIndex, queries, k: int, sample_filter=None,
           res: Resources | None = None):
    """Batch beam search (reference: cagra::search, cagra_search.cuh:70).
    Runs on the index's device and returns (distances (m, k) float32, ids
    (m, k) int32) there; a handle ``res`` that names another device raises.
    ``sample_filter`` (a keep-mask or BitsetFilter over dataset
    rows): filtered candidates score +inf before the beam merge and are not
    expanded; slots the beam cannot fill read id -1 at +inf."""
    from .brute_force import _coerce_queries
    from .sample_filter import resolve_filter, validate_filter_covers

    if res is not None:
        res.check_holds(index.device, "the cagra index")
    queries = torch.as_tensor(queries).to(index.device)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "query dim mismatch")
    expects(k <= params.itopk_size, "k must be <= itopk_size (ref cagra_types.hpp:66)")
    expects(isinstance(params.seed, (int, np.integer)),
            "SearchParams.seed must be an int here, got %r", params.seed)
    queries = _coerce_queries(index.data_kind, queries)
    impl = resolve_hop_impl(params, index.graph_degree, index.dim)
    keep_mask = resolve_filter(sample_filter, index.device)
    if keep_mask is not None:
        validate_filter_covers(index, keep_mask)
    return _cagra_search(index, queries, int(k), int(params.itopk_size),
                         int(resolve_max_iterations(params)), int(params.search_width),
                         index.metric in _SQRT_METRICS,
                         resolve_seed_pool(params, index.seed_pool_hint), impl, keep_mask,
                         seed=int(params.seed))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def write_index(f, index: CagraIndex) -> None:
    """Serialize to an open binary stream, in the JAX package's layout."""
    serialize_header(f, "cagra")
    serialize_scalar(f, int(index.metric))
    serialize_scalar(f, int(index.seed_pool_hint))
    serialize_scalar(f, index.data_kind)
    serialize_mdspan(f, index.dataset)
    serialize_mdspan(f, index.graph)
    serialize_tuned(f, index.tuned)


def read_index(f, device=None) -> CagraIndex:
    """Deserialize from an open binary stream (every version the JAX
    package's loader reads), onto ``device`` (the CPU by default)."""
    ver = check_header(f, "cagra")
    metric = DistanceType(deserialize_scalar(f))
    # raft_tpu/4 added seed_pool_hint, raft_tpu/6 data_kind
    hint = deserialize_scalar(f) if ver not in ("raft_tpu/2", "raft_tpu/3") else 0
    kind = (deserialize_scalar(f) if ver not in ("raft_tpu/2", "raft_tpu/3", "raft_tpu/4",
                                                 "raft_tpu/5") else "float32")
    dataset = deserialize_mdspan(f, device)
    graph = deserialize_mdspan(f, device)
    tuned = deserialize_tuned(f, ver)
    return CagraIndex(dataset=dataset, graph=graph, metric=metric, data_kind=kind,
                      seed_pool_hint=hint, tuned=tuned)


def save(index: CagraIndex, path: str) -> None:
    """Serialize (reference: cagra_serialize.cuh); atomic, a crashed save
    keeps the previous file."""
    with atomic_write(path) as f:
        write_index(f, index)


def load(path: str, res: Resources | None = None) -> CagraIndex:
    """Deserialize onto the handle's device."""
    dev = (res or default_resources()).torch_device
    with open(path, "rb") as f:
        return read_index(f, dev)


def batched_searcher(index: CagraIndex, params: SearchParams | None = None):
    """The serving hook (contract in :mod:`._hooks`): ``fn(queries, k) ->
    (distances, ids)`` with ``kind``, ``dim``, ``query_dtype`` and
    ``device``. The serving ``k`` must satisfy ``k <= itopk_size``. With no
    ``params``, an attached tune decision (``index.tuned``, e.g. restored by
    a raft_tpu/9 load) supplies the pinned operating point
    (``tune.make_searcher(index, True, degrade_without_rows=True)``)."""
    from ._hooks import make_hook

    if params is None and index.tuned is not None:
        from ..tune.apply import make_searcher as tuned_searcher

        return tuned_searcher(index, True, degrade_without_rows=True)
    sp = params or SearchParams()
    return make_hook(lambda queries, k: search(sp, index, queries, k),
                     "cagra", index.dim, index.data_kind, index.device)
