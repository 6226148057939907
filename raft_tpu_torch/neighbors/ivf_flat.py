"""IVF-Flat: an inverted-file index over raw vectors.

Counterpart of raft_tpu/neighbors/ivf_flat.py (reference:
neighbors/ivf_flat-inl.cuh; build detail/ivf_flat_build.cuh, search
detail/ivf_flat_search-inl.cuh). The same index layout and the same
algorithm:

- **Lists**: a dense padded (n_lists, capacity, d) array of vectors in the
  storage type (float32, bfloat16, or int8 for 8-bit data, uint8 shifted by
  -128), their ids (-1 on padding) and squared norms (+inf on padding);
  lists larger than ``split_factor`` x the mean split into sub-lists
  (``_list_utils.bound_capacity``). A build's split holds at most 1.2x
  the list bytes ``obs.mem.plan()`` prices (``_list_utils.priced_capacity``;
  the JAX package's can hold more, where many lists pass the bound).
- **Build**: balanced k-means on a trainset, then the fill.
- **Search**: the coarse product and select of the ``n_probes`` nearest
  lists, then per (query tile, probe chunk) of ``plan_search_tiles``: the
  probed lists gathered once, upcast to float32, one batched product
  ``q·v`` in full float32 (TF32 off), the score ``‖v‖² − 2·q·v`` (or ``q·v``
  with -inf on padding), the sample filter, and a select over the tile's
  flat ``(T, pc·cap)`` row with the ids as payload. The chunks' selects
  merge in order, then ``+‖q‖²``, ``max(·, 0)`` and sqrt on finite values.
  Every select goes through ``select_k_impl``: on the card a row of 1,024
  columns or more takes the ``topk`` kernel (the chunk selects and the
  coarse select of a 1,024-list index), narrower rows (the merge) the plain
  top-k; on a CPU tensor every select is the plain top-k. Values come back
  exact, so ±inf slots stay ±inf.

Entry points run on the handle's device ("cuda" unless the caller passes
``Resources(device="cpu")``); an index lives on the device it was built or
loaded on. Files are the JAX package's ``raft_tpu/13`` format, byte for
byte, and :func:`from_state` takes a JAX index's arrays as numpy.

A chunked reader (:mod:`raft_tpu_torch.core.chunked`) builds and extends
out of core, and so does a host array above ``chunked.STREAM_EXTEND_BYTES``
handed to ``extend``: the result equals the in-core one bit for bit, bar the spatial
split of a severely oversized list, which needs every row on the device
(streamed, such a list splits by input order, as in the JAX package).

An index with a tune decision attached (``index.tuned``) serves its pinned
operating point through ``batched_searcher`` (:mod:`raft_tpu_torch.tune.apply`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..cluster import kmeans_balanced
from ..cluster.kmeans_balanced import KMeansBalancedParams
from ..config import auto_convert_output
from ..core import chunked
from ..core.chunked import is_reader
from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..core.serialize import (atomic_write, check_header, deserialize_mdspan,
                              deserialize_scalar, deserialize_tuned, serialize_header,
                              serialize_mdspan, serialize_scalar, serialize_tuned)
from ..distance.pairwise import full_f32
from ..distance.types import DistanceType, resolve_metric
from ..matrix.select_k import select_k_impl
from ..obs import mem as obs_mem
from ..obs.instrument import dtype_of, instrument, nrows
from ._list_utils import (assign_to_lists, bound_capacity, fill_tile, list_positions,
                          plan_search_tiles, stream_ingest, stream_probe)
from .brute_force import _INT_DTYPES, _as_signed, _coerce_queries, _dtype_name, _place

__all__ = ["IndexParams", "SearchParams", "IvfFlatIndex", "build", "extend", "search",
           "save", "load", "write_index", "read_index", "from_state", "batched_searcher"]

_L2_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Reference: ivf_flat::index_params (ivf_flat_types.hpp); the JAX
    package's fields and defaults (raft_tpu/neighbors/ivf_flat.py:56).

    ``list_dtype``: "auto" (float32 for float data, int8 for int8 / uint8
    data), "float32", "bfloat16", or "int8" (raw 8-bit data, uint8 shifted
    by -128)."""

    n_lists: int = 1024
    metric: Any = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    kmeans_train_mode: str = "auto"
    kmeans_batch_rows: int = 65536
    add_data_on_build: bool = True
    seed: int = 0
    list_dtype: str = "auto"
    split_factor: float = 1.3


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Reference: ivf_flat::search_params (ivf_flat_types.hpp)."""

    n_probes: int = 20


@dataclasses.dataclass
class IvfFlatIndex:
    """Reference: ivf_flat::index (ivf_flat_types.hpp:224); the JAX
    package's fields as tensors on one device."""

    centers: torch.Tensor      # (n_lists, d) float32
    list_data: torch.Tensor    # (n_lists, capacity, d) storage type
    list_ids: torch.Tensor     # (n_lists, capacity) int32, -1 = padding
    list_norms: torch.Tensor   # (n_lists, capacity) float32, +inf on padding
    list_sizes: torch.Tensor   # (n_lists,) int32
    metric: DistanceType = DistanceType.L2Expanded
    split_factor: float = 1.3
    # "float32" / "bfloat16" (float storage), "int8" (signed bytes as
    # given), "uint8" (bytes stored shifted by -128; queries shift alike)
    data_kind: str = "float32"
    tuned: dict | None = None
    # the largest stored id (-1 when empty), read once when the index is
    # made: extend returns a new index and nothing writes the lists in place
    max_stored_id: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.max_stored_id = int(self.list_ids.max()) if self.list_ids.numel() else -1

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def capacity(self) -> int:
        return self.list_data.shape[1]

    @property
    def size(self) -> int:
        """Total stored vectors."""
        return int(self.list_sizes.to(torch.int64).sum())


def _fill_rows(data, idbuf, norms, offsets, x, ids, labels):
    """Scatter one tile of rows into the padded lists at each list's running
    fill level (``offsets``, updated in place): a row's slot is its rank
    among earlier rows of its list, so tiles scattered in order give the
    layout one scatter of all rows gives (ref: ivf_flat_build.cuh:160)."""
    pos, counts = list_positions(labels, offsets.shape[0])
    lab = labels.to(torch.int64)
    pos = pos.to(torch.int64) + offsets[lab].to(torch.int64)
    data[lab, pos] = x
    idbuf[lab, pos] = ids.to(torch.int32)
    xf = x.to(torch.float32)
    norms[lab, pos] = (xf * xf).sum(dim=1)
    offsets += counts


def _resolve_storage(list_dtype: str, x, mt: DistanceType):
    """The ``list_dtype`` policy for a dataset: (data_kind, x in the storage
    domain, float32 working view)."""
    expects(list_dtype in ("auto", "float32", "bfloat16", "int8"),
            "list_dtype must be 'auto', 'float32', 'bfloat16' or 'int8', got %r",
            list_dtype)
    int_in = x.dtype in _INT_DTYPES
    ld = list_dtype
    if ld == "auto":
        ld = "int8" if int_in else "float32"
    if ld == "int8":
        expects(int_in, "list_dtype='int8' stores raw 8-bit data; got a %s dataset "
                "(quantized storage for float data is IVF-PQ's job)", x.dtype)
        # uint8 under inner product is not shift-invariant, and the
        # per-vector correction is not stored
        expects(mt != DistanceType.InnerProduct or x.dtype == torch.int8,
                "uint8 + inner_product is unsupported in int8 storage (the -128 "
                "shift changes inner products); use list_dtype='float32'")
        kind = _dtype_name(x)
        x = _as_signed(x)
        return kind, x, x.to(torch.float32)
    x = x.to(torch.float32) if int_in else x
    return ld, x, x.to(torch.float32)


@instrument("ivf_flat.build",
            items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["dataset"]),
            labels=lambda a, kw: {
                "dtype": dtype_of(a[1] if len(a) > 1 else kw["dataset"]),
                "n_lists": (a[0] if a else kw["params"]).n_lists,
            })
def build(params: IndexParams, dataset, res: Resources | None = None) -> IvfFlatIndex:
    """Build the index on the handle's device (reference: ivf_flat::build):
    balanced k-means centers on a trainset, then the fill.

    A chunked reader (:mod:`raft_tpu_torch.core.chunked`) streams: the
    trainset is gathered off it, and the assign and fill passes run over
    its staged chunks, so the device holds the index plus two chunks. It is
    gated on ``obs.mem.plan(streamed=True)`` against both budgets at
    ``site="build_stream"``, and equals the in-core build of the same rows
    bit for bit (bar the spatial split of a severely oversized list, which
    needs the corpus on the device: streamed, such a list splits by input
    order)."""
    res = res or default_resources()
    stream = is_reader(dataset)
    x = None if stream else _place(dataset, res)
    src = dataset if stream else x
    expects(src.ndim == 2, "dataset must be (n, d)")
    n, d = (int(s) for s in src.shape)
    expects(params.n_lists <= n, "n_lists > n_samples")
    mt = resolve_metric(params.metric)
    expects(mt in _L2_METRICS or mt == DistanceType.InnerProduct,
            "ivf_flat supports L2 / inner_product metrics, got %s", mt.name)
    if stream:
        # dtype-only storage resolution, then the streamed admission: the
        # chunked build's peak against both budgets, before the coarse
        # trainer spends anything
        kind, probe, _ = _resolve_storage(params.list_dtype,
                                          stream_probe(dataset.dtype, d), mt)
        plan_kw = dict(dtype=kind if kind in ("int8", "uint8", "bfloat16") else "float32",
                       streamed=True, chunk_rows=dataset.chunk_rows)
        obs_mem.gate(
            res, lambda: obs_mem.plan("ivf_flat", params, n, d, **plan_kw)["build_peak_bytes"],
            site="build_stream", detail=f"ivf_flat {n}x{d} ooc",
            host_bytes=lambda: obs_mem.plan("ivf_flat", params, n, d,
                                            **plan_kw)["host_peak_bytes"])
        xf = chunked.converted(dataset, stream_ingest(kind, torch.float32), res.torch_device)
        in_dtype = probe.dtype
    else:
        kind, x, xf = _resolve_storage(params.list_dtype, x, mt)
        # memory-budget admission, before the coarse trainer spends anything
        obs_mem.gate(res, lambda: obs_mem.plan(
            "ivf_flat", params, n, d,
            dtype=kind if kind in ("int8", "uint8", "bfloat16") else "float32"
        )["index_bytes"], site="build", detail=f"ivf_flat {n}x{d}")
        in_dtype = x.dtype
    max_train = max(int(n * params.kmeans_trainset_fraction), params.n_lists)
    kb = KMeansBalancedParams(
        n_iters=params.kmeans_n_iters,
        metric="inner_product" if mt == DistanceType.InnerProduct else "sqeuclidean",
        seed=params.seed, max_train_points=min(max_train, n),
        train_mode=params.kmeans_train_mode, batch_rows=params.kmeans_batch_rows)
    centers = kmeans_balanced.fit(kb, xf, params.n_lists, res=res)
    del xf
    storage = {"bfloat16": torch.bfloat16, "int8": torch.int8,
               "uint8": torch.int8}.get(kind, in_dtype)
    dev = centers.device
    cap = 0 if params.add_data_on_build else 8
    index = IvfFlatIndex(
        centers=centers,
        list_data=torch.zeros((params.n_lists, cap, d), dtype=storage, device=dev),
        list_ids=torch.full((params.n_lists, cap), -1, dtype=torch.int32, device=dev),
        list_norms=torch.full((params.n_lists, cap), math.inf, dtype=torch.float32,
                              device=dev),
        list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        metric=mt, split_factor=params.split_factor, data_kind=kind)
    if not params.add_data_on_build:
        return index
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    if stream:
        return _extend_rows(index, dataset, ids, res=res,
                            ingest=stream_ingest(kind, storage), priced=True)
    return _extend_rows(index, x.to(storage), ids, res=res, priced=True)


@instrument("ivf_flat.extend",
            items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["new_vectors"]))
def extend(index: IvfFlatIndex, new_vectors, new_ids=None, res: Resources | None = None,
           split_factor: float | None = None) -> IvfFlatIndex:
    """Append vectors (reference: ivf_flat::extend) and re-pack the lists.
    Returns a new index on the index's device; ids default to
    ``index.size + arange``. An 8-bit index takes vectors of its original
    dtype.

    A chunked reader, or a host ndarray past ``chunked.STREAM_EXTEND_BYTES``,
    streams: assign and fill run over staged chunks, never the whole batch
    on the device, with the result of the in-core extend."""
    new_vectors = chunked.maybe_reader(new_vectors)
    if is_reader(new_vectors):
        storage = index.list_data.dtype
        if index.data_kind in ("int8", "uint8"):
            expects(str(np.dtype(new_vectors.dtype)) == index.data_kind,
                    "this index stores %s vectors; got %s", index.data_kind,
                    new_vectors.dtype)
        return _extend_rows(index, new_vectors, new_ids, res=res, split_factor=split_factor,
                            ingest=stream_ingest(index.data_kind, storage))
    x = torch.as_tensor(new_vectors)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    x = x.to(index.device)
    if index.data_kind in ("int8", "uint8"):
        # a plain cast would wrap uint8 values instead of shifting them
        expects(_dtype_name(x) == index.data_kind,
                "this index stores %s vectors; got %s", index.data_kind, _dtype_name(x))
        x = _as_signed(x)
    return _extend_rows(index, x.to(index.list_data.dtype), new_ids, res=res,
                        split_factor=split_factor)


def _extend_rows(index: IvfFlatIndex, src, new_ids=None, res: Resources | None = None,
                 split_factor: float | None = None, ingest=None,
                 priced: bool = False) -> IvfFlatIndex:
    """extend() over rows in the index's storage domain: a tensor on its
    device, or a chunked reader whose staged chunks ``ingest`` converts.

    Two passes over :func:`~raft_tpu_torch.core.chunked.row_tiles` (assign,
    then fill), the same code in both modes: every per-row quantity (label,
    slot, norm) comes from tiles of one shape at the same offsets, so a
    streamed extend equals the in-core one bit for bit. Severely oversized
    lists split spatially in-core and by input order streamed (the spatial
    split needs every row on the device). ``priced`` (a build's fill, which
    ``obs.mem.plan()`` prices) splits oversized lists at
    ``_list_utils.priced_capacity``."""
    res = res or default_resources()
    dev = index.device
    stream = is_reader(src)
    n_new, d = (int(s) for s in src.shape)
    expects(d == index.dim, "vector dim mismatch")
    if new_ids is None:
        new_ids = index.size + torch.arange(n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
        expects(tuple(new_ids.shape) == (n_new,), "ids/vectors length mismatch")
    tile = fill_tile(n_new, index.n_lists, res.workspace_bytes)
    stager = (chunked.ChunkStager(src.chunk_rows, d, src.dtype, kind="ivf_flat", device=dev)
              if stream else None)
    tiles = dict(tile=tile, stager=stager, ingest=ingest, kind="ivf_flat")
    try:
        labels = torch.cat([assign_to_lists(t, index.centers, index.metric, tile)
                            for _, t in chunked.row_tiles(src, stage="assign", **tiles)])
        n_old = 0
        if index.capacity > 0 and index.size > 0:
            old = index.list_ids.reshape(-1) >= 0
            old_x = index.list_data.reshape(-1, d)[old]
            old_ids = index.list_ids.reshape(-1)[old]
            n_old = int(old_ids.shape[0])
            labels = torch.cat([torch.arange(index.n_lists, dtype=torch.int32, device=dev
                                             ).repeat_interleave(index.capacity)[old], labels])

        # the capacity policy: oversized lists split into sub-lists;
        # severely oversized ones (>= 8x the bound) split spatially, in-core,
        # and their children are re-centred on their members below
        sf = index.split_factor if split_factor is None else split_factor
        xs = None
        if not stream:
            xs = (torch.cat([old_x, src]) if n_old else src).to(torch.float32)
        labels, rep, n_lists, capacity, split_sp = bound_capacity(labels, index.n_lists, sf,
                                                                  x=xs, priced=priced)
        del xs
        data = torch.zeros((n_lists, capacity, d), dtype=index.list_data.dtype, device=dev)
        idbuf = torch.full((n_lists, capacity), -1, dtype=torch.int32, device=dev)
        norms = torch.full((n_lists, capacity), math.inf, dtype=torch.float32, device=dev)
        offsets = torch.zeros((n_lists,), dtype=torch.int32, device=dev)
        # the streamed build's device working set, which
        # obs.mem.plan(streamed=True) prices; released before the caller
        # holds the index
        tok = (obs_mem.account("build/ooc", name="ivf_flat", device=[
            data, idbuf, norms, offsets, labels, new_ids], owner=stager) if stream else None)
        if n_old:
            _fill_rows(data, idbuf, norms, offsets, old_x, old_ids, labels[:n_old])
        for start, t in chunked.row_tiles(src, stage="fill", **tiles):
            end = start + t.shape[0]
            _fill_rows(data, idbuf, norms, offsets, t, new_ids[start:end],
                       labels[n_old + start:n_old + end])
        obs_mem.release(tok)
    finally:
        if stager is not None:
            stager.release()
    sizes = offsets
    centers = index.centers
    if rep is not None:
        centers = centers.repeat_interleave(torch.from_numpy(rep).to(dev), dim=0)
        if split_sp is not None and split_sp.any():
            member = (idbuf >= 0)[..., None]
            sums = torch.where(member, data.to(torch.float32), 0.0).sum(dim=1)
            means = sums / torch.clamp_min(sizes, 1)[:, None].to(torch.float32)
            child = torch.from_numpy(np.repeat(split_sp, rep)).to(dev)
            centers = torch.where(child[:, None], means, centers)
    return IvfFlatIndex(centers, data, idbuf, norms, sizes, index.metric, sf,
                        index.data_kind)


def _coarse_probes(index: IvfFlatIndex, qf, n_probes: int):
    """The ``n_probes`` nearest lists of each query (ref:
    ivf_flat_search-inl.cuh:130), (m, n_probes) int32."""
    inner = index.metric == DistanceType.InnerProduct
    with full_f32():
        cscore = qf @ index.centers.T
    if not inner:
        cn = (index.centers * index.centers).sum(dim=1)
        cscore = cn[None, :] - 2.0 * cscore
    return select_k_impl(cscore, None, n_probes, not inner)[1]


def _ivf_search(index: IvfFlatIndex, queries, n_probes: int, k: int, query_tile: int,
                probe_chunk: int, keep_mask=None):
    """The tiled search (the JAX package's ``_ivf_search``)."""
    from .sample_filter import apply_id_filter

    m = queries.shape[0]
    qf = queries.to(torch.float32)
    inner = index.metric == DistanceType.InnerProduct
    probes = _coarse_probes(index, qf, n_probes).to(torch.int64)
    cap = index.capacity
    dists, idx = [], []
    for t0 in range(0, m, query_tile):
        q = qf[t0:t0 + query_tile]
        pr = probes[t0:t0 + query_tile]
        t = q.shape[0]
        cvs, cis = [], []
        for c0 in range(0, n_probes, probe_chunk):
            pc = pr[:, c0:c0 + probe_chunk]                      # (T, pc)
            # the probed lists, gathered once and upcast to float32 (bf16
            # and int8 lists too: the product is full float32)
            vecs = index.list_data[pc].reshape(t, probe_chunk * cap, index.dim)
            vecs = vecs.to(torch.float32)
            with full_f32():
                dots = torch.bmm(vecs, q[:, :, None])[..., 0]    # (T, pc·cap)
            del vecs
            ids = index.list_ids[pc].reshape(t, -1)
            if inner:
                scores = torch.where(ids >= 0, dots, -math.inf)
            else:
                # +inf padding norms stay +inf
                scores = index.list_norms[pc].reshape(t, -1) - 2.0 * dots
            if keep_mask is not None:
                scores = apply_id_filter(scores, ids, keep_mask, not inner)
            v, i = select_k_impl(scores, ids, k, not inner)
            cvs.append(v)
            cis.append(i)
        v, i = select_k_impl(torch.cat(cvs, dim=1), torch.cat(cis, dim=1), k, not inner)
        dists.append(v)
        idx.append(i)
    dists = torch.cat(dists)
    idx = torch.cat(idx)
    if not inner:
        # ‖v‖² − 2·q·v plus ‖q‖² is the squared L2 distance
        qn = (qf * qf).sum(dim=1, keepdim=True)
        fin = torch.isfinite(dists)
        dists = torch.where(fin, torch.clamp_min(dists + qn, 0.0), dists)
        if index.metric in _SQRT_METRICS:
            dists = torch.where(fin, torch.sqrt(dists), dists)
    if keep_mask is not None:
        # filtered candidates carry ±inf: report them as -1
        idx = torch.where(torch.isinf(dists), -1, idx)
    return dists, idx


def search_plan(index: IvfFlatIndex, m: int, n_probes: int, k: int,
                res: Resources | None = None):
    """(query_tile, probe_chunk) of a search of ``m`` queries: the JAX
    package's tile plan, each probe row costing its gathered float32
    vectors, norm and score, twice over for temporaries."""
    res = res or default_resources()
    return plan_search_tiles(m, n_probes, int(k), index.capacity,
                             bytes_per_probe_row=2 * index.capacity * (index.dim * 4 + 8),
                             budget_bytes=res.workspace_bytes)


@auto_convert_output
@instrument(
    "ivf_flat.search",
    items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["queries"]),
    labels=lambda a, kw: {"k": a[3] if len(a) > 3 else kw["k"],
                          "n_probes": (a[0] if a else kw["params"]).n_probes},
)
def search(params: SearchParams, index: IvfFlatIndex, queries, k: int,
           sample_filter=None, res: Resources | None = None):
    """Search (reference: ivf_flat::search). Returns (distances (m, k)
    float32, ids (m, k) int32) on the index's device; id -1 marks slots
    beyond the probed candidates (and, with a filter, filtered ones). A
    handle ``res`` that names another device than the index's raises."""
    from .sample_filter import resolve_filter, validate_filter_covers

    if res is not None:
        res.check_holds(index.device, "the ivf_flat index")
    res = res or default_resources()
    queries = torch.as_tensor(queries).to(index.device)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "query dim mismatch")
    queries = _coerce_queries(index.data_kind, queries)
    expects(index.capacity > 0, "index is empty")
    expects(index.size > 0, "index is empty")
    n_probes = min(params.n_probes, index.n_lists)
    expects(k <= n_probes * index.capacity,
            "k=%d exceeds the probed candidate pool (n_probes=%d x capacity=%d)",
            k, n_probes, index.capacity)
    query_tile, probe_chunk = search_plan(index, queries.shape[0], n_probes, k, res)
    keep_mask = resolve_filter(sample_filter, index.device)
    if keep_mask is not None:
        validate_filter_covers(index, keep_mask)
    return _ivf_search(index, queries, n_probes, int(k), query_tile, probe_chunk,
                       keep_mask)


def write_index(f, index: IvfFlatIndex) -> None:
    """Serialize to an open binary stream, in the JAX package's layout."""
    serialize_header(f, "ivf_flat")
    serialize_scalar(f, int(index.metric))
    serialize_scalar(f, float(index.split_factor))
    serialize_scalar(f, index.data_kind)
    for arr in (index.centers, index.list_data, index.list_ids, index.list_norms,
                index.list_sizes):
        serialize_mdspan(f, arr)
    serialize_tuned(f, index.tuned)


def read_index(f, device=None) -> IvfFlatIndex:
    """Deserialize from an open binary stream (every version the JAX
    package's loader reads), onto ``device`` (the CPU by default)."""
    ver = check_header(f, "ivf_flat")
    metric = DistanceType(deserialize_scalar(f))
    split_factor = float(deserialize_scalar(f))
    # raft_tpu/5 added data_kind; older files hold float kinds only
    kind = (deserialize_scalar(f)
            if ver not in ("raft_tpu/2", "raft_tpu/3", "raft_tpu/4") else None)
    arrs = [deserialize_mdspan(f, device) for _ in range(5)]
    if kind is None:
        kind = "bfloat16" if arrs[1].dtype == torch.bfloat16 else "float32"
    tuned = deserialize_tuned(f, ver)
    return IvfFlatIndex(*arrs, metric=metric, split_factor=split_factor,
                        data_kind=kind, tuned=tuned)


def save(index: IvfFlatIndex, path: str) -> None:
    """Serialize (reference: ivf_flat_serialize.cuh); atomic, a crashed
    save keeps the previous file."""
    with atomic_write(path) as f:
        write_index(f, index)


def load(path: str, res: Resources | None = None) -> IvfFlatIndex:
    """Deserialize onto the handle's device."""
    dev = (res or default_resources()).torch_device
    with open(path, "rb") as f:
        return read_index(f, dev)


_STATE_ARRAYS = ("centers", "list_data", "list_ids", "list_norms", "list_sizes")


def _state_tensor(a, res: Resources) -> torch.Tensor:
    """An array of another index's state on the handle's device; a numpy
    bfloat16 array (ml_dtypes, as JAX hands it out) travels as its bits."""
    if isinstance(a, np.ndarray) and a.dtype.name == "bfloat16":
        return res.put(a.view(np.int16)).view(torch.bfloat16)
    return res.put(a)


def from_state(arrays: dict, res: Resources | None = None, **meta) -> IvfFlatIndex:
    """An :class:`IvfFlatIndex` from another index's state: its arrays as
    numpy (``centers``, ``list_data``, ``list_ids``, ``list_norms``,
    ``list_sizes``) and its scalar fields as keywords (``metric``,
    ``split_factor``, ``data_kind``, ``tuned``). Placed on the handle's
    device; searches answer as the index that gave the state does."""
    res = res or default_resources()
    expects(set(arrays) == set(_STATE_ARRAYS), "from_state: arrays must be %s, got %s",
            list(_STATE_ARRAYS), sorted(arrays))
    fields = {name: _state_tensor(a, res) for name, a in arrays.items()}
    if "metric" in meta:
        m = meta["metric"]
        meta["metric"] = (DistanceType(int(m)) if isinstance(m, (int, np.integer))
                          else resolve_metric(m))
    return IvfFlatIndex(**fields, **meta)


def batched_searcher(index: IvfFlatIndex, params: SearchParams | None = None):
    """The serving hook (contract in :mod:`._hooks`): ``fn(queries, k) ->
    (distances, ids)`` with ``kind``, ``dim`` and ``query_dtype``. With no ``params``,
    an attached tune decision (``index.tuned``, e.g. restored by a
    raft_tpu/9 load) supplies the pinned operating point
    (``tune.make_searcher(index, True, degrade_without_rows=True)``)."""
    from ._hooks import make_hook

    if params is None and index.tuned is not None:
        from ..tune.apply import make_searcher as tuned_searcher

        return tuned_searcher(index, True, degrade_without_rows=True)
    sp = params or SearchParams()
    return make_hook(lambda queries, k: search(sp, index, queries, k),
                     "ivf_flat", index.dim, index.data_kind, index.device)
