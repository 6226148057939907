"""Brute-force (exact) k-nearest neighbours.

Counterpart of raft_tpu/neighbors/brute_force.py (reference:
cpp/include/raft/neighbors/brute_force.cuh, detail/knn_brute_force.cuh).
Two routes:

- the fused route: L2, inner product and cosine with k <= 64, n >= 4096
  and 64 <= d <= 4096 (:func:`_fused_eligible`) go to ops.fused_knn, which
  on a CUDA tensor launches the ``fused_knn`` kernel (scores never reach
  device memory) and on a CPU tensor runs its plain version. int8 / uint8
  pairs take the same kernel in mode "s8" (:func:`_bf_knn_s8`);
- everything else (k > 64, small shapes, the other metrics,
  ``mode="approx"``, mixed integer pairs): :func:`_bf_knn`, query tiles of
  one ``_pairwise`` evaluation plus a routed row top-k
  (``select_k_impl``: the ``topk`` kernel for wide rows on the card, else
  the plain top-k), ties to the lowest row.

Index files are the JAX package's ``brute_force`` section of
``raft_tpu/13``, byte for byte; :func:`batched_searcher` is the serving
hook.

Entry points run on the handle's device (``Resources.device``, "cuda" by
default). Results are torch tensors on that device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import chunked
from ..core.chunked import is_reader
from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import _PRECISIONS, _choose_tile, _pad_to_tiles, _pairwise
from ..distance.types import DistanceType, resolve_metric
from ..matrix.select_k import select_k, select_k_impl
from ..obs import mem as obs_mem
from ..obs.instrument import dtype_of, instrument, nrows

__all__ = ["knn", "knn_merge_parts", "BruteForce", "from_state", "write_index",
           "read_index", "save", "load", "batched_searcher"]

# metrics the fused kernel takes as l2 (value: sqrt)
_FUSED_L2 = {
    DistanceType.L2Expanded: False,
    DistanceType.L2SqrtExpanded: True,
    DistanceType.L2Unexpanded: False,
    DistanceType.L2SqrtUnexpanded: True,
}
_INT_DTYPES = (torch.int8, torch.uint8)
_KEPT_DTYPES = (torch.float32, torch.bfloat16, torch.float16) + _INT_DTYPES


def _as_signed(x):
    """uint8 -> int8 by the -128 shift (L2 is shift-invariant; inner-product
    callers correct through the row bias); int8 passes through."""
    if x.dtype == torch.uint8:
        return (x.to(torch.int16) - 128).to(torch.int8)
    return x


def _coerce_queries(data_kind: str, queries):
    """Queries in a byte index's storage domain (the search-side half of the
    :func:`_as_signed` contract): integer queries must match the index's
    original dtype and shift with it, to float32; float queries against a
    shifted uint8 index shift by -128. Float indexes take queries as given."""
    if data_kind not in ("int8", "uint8"):
        return queries
    if queries.dtype in _INT_DTYPES:
        expects(str(queries.dtype).split(".")[-1] == data_kind,
                "this index stores %s vectors; got %s queries",
                data_kind, str(queries.dtype).split(".")[-1])
        return _as_signed(queries).to(torch.float32)
    if data_kind == "uint8":
        return queries.to(torch.float32) - 128.0
    return queries


def _bf_knn_s8(dataset, queries, k, metric, keep_mask):
    """int8 / uint8 pairs through the kernel's s8 mode; distances are exact
    integers for d <= ~340."""
    from ..ops.fused_knn import fused_knn

    shifted = dataset.dtype == torch.uint8
    ds = _as_signed(dataset)
    qs = _as_signed(queries)
    if metric in _FUSED_L2:
        return fused_knn(ds, qs, k, metric="l2", mode="s8",
                         keep_mask=keep_mask, sqrt=_FUSED_L2[metric])
    if not shifted:
        return fused_knn(ds, qs, k, metric="ip", mode="s8", keep_mask=keep_mask)
    # inner product of shifted operands: q·v = q'·v' + 128·Σv' + 128·Σq'
    # + 128²·d — the Σv' term rides the row bias, the per-query constant is
    # added here
    d = dataset.shape[1]
    row_bias = -128.0 * ds.to(torch.float32).sum(dim=1)
    sim, idx = fused_knn(ds, qs, k, metric="ip", mode="s8",
                         keep_mask=keep_mask, row_bias=row_bias)
    qconst = 128.0 * qs.to(torch.float32).sum(dim=1, keepdim=True) + 16384.0 * d
    return torch.where(torch.isinf(sim), sim, sim + qconst), idx


def _fused_eligible(metric, k, n, d, mode, compute):
    """Whether a float search takes the fused route. Unlike the JAX package
    it does not ask for a backend: on CUDA the route launches the kernel,
    on the CPU it runs the kernel's plain version."""
    from ..ops.fused_knn import shapes_eligible

    return (
        mode == "exact"
        and compute in ("float32", "float32x3", "bfloat16")
        and shapes_eligible(n, d, k)
        and (metric in _FUSED_L2
             or metric in (DistanceType.InnerProduct, DistanceType.CosineExpanded))
    )


def _row_norms(x):
    xf = x.to(torch.float32)
    return torch.sqrt((xf * xf).sum(dim=1, keepdim=True))


def _bf_knn_fused(dataset, queries, k, metric, compute, keep_mask):
    """The fused route (ops.fused_knn)."""
    from ..ops.fused_knn import fused_knn

    mode = {"float32": "f32", "float32x3": "f32x3", "bfloat16": "bf16"}[compute]
    if metric in _FUSED_L2:
        return fused_knn(dataset, queries, k, metric="l2", mode=mode,
                         keep_mask=keep_mask, sqrt=_FUSED_L2[metric])
    if metric == DistanceType.InnerProduct:
        return fused_knn(dataset, queries, k, metric="ip", mode=mode,
                         keep_mask=keep_mask)
    # cosine: 1 - ip over normalized rows
    sim, idx = fused_knn(dataset / torch.clamp_min(_row_norms(dataset), 1e-30),
                         queries / torch.clamp_min(_row_norms(queries), 1e-30), k,
                         metric="ip", mode=mode, keep_mask=keep_mask)
    return torch.where(torch.isinf(sim), math.inf, 1.0 - sim), idx


def _bf_knn(dataset, queries, k: int, metric: DistanceType, metric_arg: float,
            tile: int, inner_tile: int, keep_mask=None, approx: bool = False,
            compute: str = "float32"):
    """GEMM + top-k over query tiles of ``tile`` rows. ``approx`` is
    accepted for the JAX package's ``mode="approx"`` and runs the same exact
    selection: the approximate TPU selector has no counterpart here."""
    m = queries.shape[0]
    # kNN order is the same under expanded and unexpanded L2
    metric = {
        DistanceType.L2Unexpanded: DistanceType.L2Expanded,
        DistanceType.L2SqrtUnexpanded: DistanceType.L2SqrtExpanded,
    }.get(metric, metric)
    qt, _ = _pad_to_tiles(queries, tile)
    select_min = metric != DistanceType.InnerProduct
    dists, idx = [], []
    for qb in qt:
        d = _pairwise(qb, dataset, metric, metric_arg, inner_tile, compute)
        if keep_mask is not None:
            d = torch.where(keep_mask[None, :], d,
                            math.inf if select_min else -math.inf)
        top_v, top_i = select_k_impl(d, None, k, select_min)
        dists.append(top_v)
        idx.append(top_i)
    dists = torch.cat(dists)[:m]
    idx = torch.cat(idx)[:m]
    if keep_mask is not None:
        # fewer than k rows pass the filter: the ±inf slots read -1
        idx = torch.where(torch.isinf(dists), -1, idx)
    return dists, idx


def _shape_and_itemsize(x):
    """(shape, bytes per element) of a tensor, an array or a nested list,
    without moving it to a device."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.element_size()
    a = x if hasattr(x, "shape") and hasattr(x, "dtype") else np.asarray(x)
    return tuple(int(s) for s in a.shape), np.dtype(a.dtype).itemsize


def _place(x, res: Resources):
    """A tensor on the handle's device, float64 and other wide types as
    float32 (as the JAX package stores them)."""
    x = res.put(x)
    return x if x.dtype in _KEPT_DTYPES else x.to(torch.float32)


@instrument(
    "brute_force.knn",
    items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["queries"]),
    labels=lambda a, kw: {
        "dtype": dtype_of(a[0] if a else kw["dataset"]),
        "k": a[2] if len(a) > 2 else kw["k"],
    },
)
def knn(dataset, queries, k: int, metric="sqeuclidean", metric_arg: float = 2.0,
        sample_filter=None, mode: str = "exact", compute: str = "float32",
        res: Resources | None = None):
    """Exact kNN of ``queries`` in ``dataset`` (reference: brute_force::knn).

    ``sample_filter``: an optional
    :class:`~raft_tpu_torch.neighbors.sample_filter.BitsetFilter` or boolean
    keep-mask over dataset rows. ``mode``: "exact", or "approx", which here
    runs the same exact selection (the TPU's approximate selector has no
    counterpart on the card). ``compute``: "float32" (full float32, never
    TF32), "float32x3" (bf16 hi/lo split on the fused route; "float32"
    elsewhere) or "bfloat16". int8 / uint8 pairs go to the kernel's s8 mode
    with exact integer distances; ``compute="int8"`` asserts that intent.

    Runs on ``res.device`` ("cuda" by default). Returns (distances (m, k)
    float32, indices (m, k) int32).
    """
    from .sample_filter import resolve_filter

    res = res or default_resources()
    dataset = _place(dataset, res)
    queries = _place(queries, res)
    expects(dataset.ndim == 2 and queries.ndim == 2, "inputs must be 2-D")
    expects(dataset.shape[1] == queries.shape[1], "feature dims must match")
    n = dataset.shape[0]
    expects(0 < k <= n, "k=%d must be in (0, n=%d]", k, n)
    expects(mode in ("exact", "approx"),
            "mode must be 'exact' or 'approx', got %r", mode)
    expects(compute in _PRECISIONS or compute in ("float32x3", "int8"),
            "compute must be one of %s, got %r",
            sorted(_PRECISIONS) + ["float32x3", "int8"], compute)
    mt = resolve_metric(metric)
    keep_mask = resolve_filter(sample_filter, dataset.device)
    if keep_mask is not None:
        expects(tuple(keep_mask.shape) == (n,),
                "sample filter must cover all %d dataset rows", n)
    expects(compute != "int8"
            or (dataset.dtype in _INT_DTYPES and queries.dtype in _INT_DTYPES),
            "compute='int8' requires int8/uint8 dataset AND queries, got "
            "%s/%s", dataset.dtype, queries.dtype)
    if dataset.dtype in _INT_DTYPES or queries.dtype in _INT_DTYPES:
        # integer pairs go to the s8 kernel; what it cannot take (mixed
        # pairs, cosine, small shapes) runs the float32 route, also exact
        # for 8-bit values
        if dataset.dtype in _INT_DTYPES and queries.dtype in _INT_DTYPES:
            expects(dataset.dtype == queries.dtype,
                    "int8/uint8 dataset and queries must share a dtype "
                    "(mixing signed and shifted domains is a data error), "
                    "got %s/%s", dataset.dtype, queries.dtype)
            from ..ops.fused_knn import shapes_eligible

            if (mode == "exact" and compute in ("float32", "int8")
                    and (mt in _FUSED_L2 or mt == DistanceType.InnerProduct)
                    and shapes_eligible(n, dataset.shape[1], int(k))):
                return _bf_knn_s8(dataset, queries, int(k), mt, keep_mask)
        dataset = dataset.to(torch.float32)
        queries = queries.to(torch.float32)
    if compute == "int8":
        compute = "float32"
    if _fused_eligible(mt, int(k), n, dataset.shape[1], mode, compute):
        return _bf_knn_fused(dataset, queries, int(k), mt, compute, keep_mask)
    if compute == "float32x3":
        compute = "float32"   # the GEMM route has no compensated mode
    tile = _choose_tile(queries.shape[0], n, 1, res.workspace_bytes)
    inner_tile = _choose_tile(tile, n, dataset.shape[1], res.workspace_bytes)
    return _bf_knn(dataset, queries, int(k), mt, float(metric_arg), tile,
                   inner_tile, keep_mask, approx=mode == "approx",
                   compute=compute)


def knn_merge_parts(part_dists, part_ids, k: int | None = None,
                    select_min: bool = True, res: Resources | None = None):
    """Merge per-shard kNN lists (reference: detail/knn_merge_parts.cuh):
    one select_k over the concatenated candidates. ``part_dists`` /
    ``part_ids``: (n_parts, n_queries, k_part) with global ids. Returns
    merged (dists, ids) of width ``k or k_part``."""
    res = res or default_resources()
    part_dists = res.put(part_dists)
    part_ids = res.put(part_ids)
    expects(part_dists.ndim == 3, "expected (n_parts, n_queries, k)")
    n_parts, nq, kp = part_dists.shape
    k = kp if k is None else k
    flat_d = part_dists.movedim(0, 1).reshape(nq, n_parts * kp)
    flat_i = part_ids.movedim(0, 1).reshape(nq, n_parts * kp)
    return select_k(flat_d, k, select_min=select_min, indices=flat_i, res=res)


class BruteForce:
    """Index-style wrapper (reference: brute_force::index): the dataset is
    the whole index, with ``metric`` and ``metric_arg``."""

    def __init__(self, metric="sqeuclidean", metric_arg: float = 2.0):
        self.metric = metric
        self.metric_arg = metric_arg
        self.dataset = None
        self.res = None
        # a pinned operating point (the JAX package's tune decision dict);
        # brute force has no search knobs, but the record rides save / load
        self.tuned = None

    def build(self, dataset, res: Resources | None = None):
        """Place the dataset on the handle's device, after the memory-budget
        gate (``Resources.memory_budget_bytes``) has priced it at
        n·d·min(itemsize, 4) bytes, as the JAX package does; the gate costs
        one attribute check when no budget is armed.

        A chunked reader (:mod:`raft_tpu_torch.core.chunked`) streams in:
        the dataset still lands on the device whole (it is the scan
        operand), through the staged chunk pipeline, after the gate has
        priced ``obs.mem.plan(streamed=True)``'s build peak and host peak
        at ``site="build_stream"``. It equals the in-core build's dataset
        bit for bit."""
        self.res = res or default_resources()
        if is_reader(dataset):
            n, d = (int(s) for s in dataset.shape)
            pl = obs_mem.plan("brute_force", None, n, d,
                              dtype=str(chunked.device_dtype(dataset.dtype)),
                              streamed=True, chunk_rows=dataset.chunk_rows)
            obs_mem.gate(self.res, pl["build_peak_bytes"], site="build_stream",
                         host_bytes=pl["host_peak_bytes"],
                         detail=f"brute_force {n}x{d} streamed")
            self.dataset = _place(chunked.device_materialize(
                dataset, kind="brute_force", device=self.res.torch_device), self.res)
            return self
        shape, itemsize = _shape_and_itemsize(dataset)
        expects(len(shape) == 2, "dataset must be (n, d)")
        obs_mem.gate(self.res, shape[0] * shape[1] * min(itemsize, 4), site="build",
                     detail=f"brute_force {shape[0]}x{shape[1]}")
        self.dataset = _place(dataset, self.res)
        return self

    def search(self, queries, k: int, res: Resources | None = None):
        expects(self.dataset is not None, "index is not built")
        return knn(self.dataset, queries, k, self.metric, self.metric_arg,
                   res=res or self.res)


def from_state(dataset: np.ndarray, metric, metric_arg: float = 2.0,
               res: Resources | None = None) -> BruteForce:
    """A :class:`BruteForce` from another index's state: its dataset,
    ``metric`` and ``metric_arg`` (a raft_tpu ``BruteForce`` holds nothing
    else). Searches answer as that index's do."""
    return BruteForce(metric=metric, metric_arg=metric_arg).build(dataset, res)


def _dtype_name(t: torch.Tensor) -> str:
    """"float32", "int8", ...: the dtype's name as numpy and JAX spell it."""
    return str(t.dtype).split(".")[-1]


def write_index(f, index: BruteForce) -> None:
    """Serialize to an open binary stream: the metric, its argument, the
    dataset and the tuned record, in the JAX package's layout."""
    from ..core.serialize import (serialize_header, serialize_mdspan,
                                  serialize_scalar, serialize_tuned)

    expects(index.dataset is not None, "index is not built")
    serialize_header(f, "brute_force")
    serialize_scalar(f, int(resolve_metric(index.metric)))
    serialize_scalar(f, float(index.metric_arg))
    serialize_mdspan(f, index.dataset)
    serialize_tuned(f, index.tuned)


def read_index(f, device=None) -> BruteForce:
    """Deserialize from an open binary stream (pairs with
    :func:`write_index`), onto ``device`` (the CPU by default)."""
    from ..core.serialize import (check_header, deserialize_mdspan,
                                  deserialize_scalar, deserialize_tuned)

    ver = check_header(f, "brute_force")
    metric = DistanceType(deserialize_scalar(f))
    idx = BruteForce(metric=metric, metric_arg=float(deserialize_scalar(f)))
    idx.dataset = deserialize_mdspan(f, device)
    idx.tuned = deserialize_tuned(f, ver)
    return idx


def save(index: BruteForce, path: str) -> None:
    """Serialize atomically (a crashed save leaves the previous file)."""
    from ..core.serialize import atomic_write

    with atomic_write(path) as f:
        write_index(f, index)


def load(path: str, res: Resources | None = None) -> BruteForce:
    """Deserialize onto the handle's device."""
    res = res or default_resources()
    with open(path, "rb") as f:
        idx = read_index(f, res.torch_device)
    idx.res = res
    return idx


def batched_searcher(index: BruteForce, params=None):
    """The serving hook (contract in :mod:`._hooks`): ``fn(queries, k) ->
    (distances, ids)`` with ``kind``, ``dim`` and ``query_dtype``. Brute
    force has no search params; ``params`` must be None."""
    from ._hooks import make_hook

    expects(index.dataset is not None, "index is not built")
    expects(params is None, "brute_force has no search params")
    return make_hook(index.search, "brute_force", index.dataset.shape[1],
                     _dtype_name(index.dataset), index.dataset.device)
