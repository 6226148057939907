"""IVF-PQ: an inverted-file index of product-quantized residuals.

Counterpart of raft_tpu/neighbors/ivf_pq.py (reference:
neighbors/ivf_pq-inl.cuh build :270 / search :723, detail/ivf_pq_build.cuh,
detail/ivf_pq_search.cuh). The same index layout and the same algorithm:

- **Build**: balanced k-means coarse centers, an identity (or random
  orthonormal) rotation, per-subspace codebooks trained by batched EM over
  the rotated residuals of a trainset, codes stored one byte per
  (vector, subspace) in padded lists (n_lists, capacity, pq_dim); lists
  larger than ``split_factor`` x the mean split into sub-lists that share
  their parent's center. ``pq_bits=8`` with ``pq8_split`` (the L2 default)
  stores a two-stage 4+4-bit code whose cross term rides in ``list_consts``.
- **Search**: coarse product + select_k, then per (query tile, probe chunk)
  of :func:`~raft_tpu_torch.neighbors._list_utils.plan_search_tiles`: the
  LUT ``|c|² - 2·r·c`` per subspace (one batched product), the scan
  ``Σ_s LUT[s, code_s]``, bias and constants, a per-chunk select_k, then a
  merge of the chunks in order (skipped for a tile of one chunk), so ties
  go to the lowest flat position.
- **Scan**: ``scan_impl`` takes the JAX package's names. "pallas" (or
  "kernel") is the ``pq_scan`` kernel (ops/pq_scan.py), which on a CUDA
  tensor follows the probed list ids itself; "onehot" and "select" are
  plain PyTorch formulations of the same sum. "auto" takes the kernel where
  the LUT stages are 16 wide (pq4 or split pq8) and ``lut_dtype`` is float32
  or bfloat16, and "onehot" otherwise (joint 256-entry pq8, int8 LUTs).
  Where the chunk's select would go to the ``topk`` kernel too, the kernel
  route runs ``pq_scan_topk`` instead: the scan, bias, constants, mask and
  top-k in one launch per chunk, the scores never written out. On a CPU
  tensor the kernel's route runs its plain version.

Entry points run on the handle's device ("cuda" unless the caller passes
``Resources(device="cpu")``); an index lives on the device it was built or
loaded on. Files are the JAX package's ``raft_tpu/13`` format, byte for
byte, and :func:`from_state` takes a JAX index's arrays as numpy.

Not yet ported (each raises ``RaftError("not yet ported")``): per-cluster
and "auto" codebooks, ``residual_scale_norm``, OPQ, anisotropic codebooks,
the fast-scan funnel, ``scan_order="grouped"``, int8/uint8 datasets, the
streamed build, sample filters, ``batched_searcher`` and the obs hooks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..cluster import kmeans_balanced
from ..cluster.kmeans_balanced import KMeansBalancedParams
from ..core import serialize as core_serialize
from ..core.errors import expects, fail
from ..core.resources import Resources, default_resources
from ..core.serialize import (check_header, deserialize_mdspan, deserialize_scalar,
                              deserialize_tuned, serialize_header, serialize_mdspan,
                              serialize_scalar, serialize_tuned, version_number)
from ..distance.pairwise import _choose_tile, full_f32
from ..distance.types import DistanceType, resolve_metric
from ..matrix.select_k import _select_k, select_k_impl, wide_dispatch_ok
from ._list_utils import (assign_to_lists, bound_capacity, list_positions,
                          plan_search_tiles, pq_scan_bytes_per_probe_row)

__all__ = ["IndexParams", "SearchParams", "IvfPqIndex", "build", "extend", "search",
           "save", "load", "write_index", "read_index", "from_state",
           "resolve_scan_impl"]

_L2_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_SELECT_IMPLS = {"auto": "auto", "xla": "torch", "pallas": "kernel"}
_BLOCK_BYTES = 1 << 28   # temporaries of one step of the plain formulations


def _not_ported(what: str):
    fail("ivf_pq: %s is not yet ported to raft_tpu_torch", what)


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Reference: ivf_pq::index_params (ivf_pq_types.hpp:48-105); the JAX
    package's fields and defaults (raft_tpu/neighbors/ivf_pq.py:87)."""

    n_lists: int = 1024
    metric: Any = "sqeuclidean"
    # codebook size 2**pq_bits, 4..8; 4 by default (the JAX package's choice)
    pq_bits: int = 4
    pq_dim: int = 0        # 0: the code bytes of the reference default
    codebook_kind: str = "per_subspace"
    force_random_rotation: bool = False
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    kmeans_train_mode: str = "auto"
    kmeans_batch_rows: int = 65536
    add_data_on_build: bool = True
    seed: int = 0
    split_factor: float = 1.3
    # pq_bits=8 layout: True two-stage 4+4-bit codes, False the joint
    # 256-entry codebook, None split for L2 and joint for inner product
    pq8_split: bool | None = None
    residual_scale_norm: bool = False
    rotation: str = "none"
    opq_rounds: int = 8
    opq_batch_rows: int = 16384
    codebook_loss: str = "l2"
    anisotropic_eta: float = 0.0
    fast_scan: str = "none"


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Reference: ivf_pq::search_params (ivf_pq_types.hpp:108-140); the JAX
    package's fields and defaults.

    ``scan_impl``: "auto", "pallas" or "kernel" (the ``pq_scan`` kernel),
    "onehot", "select". ``select_impl``: "auto", "xla" (the plain top-k) or
    "pallas" (the ``topk`` kernel)."""

    n_probes: int = 20
    lut_dtype: str = "float32"          # "float32" | "bfloat16" | "int8"
    scan_impl: str = "auto"
    scan_order: str = "auto"
    group_size: int = 16
    select_impl: str = "auto"
    funnel_widen: int = 1


@dataclasses.dataclass
class IvfPqIndex:
    """Reference: ivf_pq::index (ivf_pq_types.hpp:172-300); the JAX
    package's fields as tensors on one device."""

    centers: torch.Tensor      # (n_lists, d) float32
    centers_rot: torch.Tensor  # (n_lists, d_rot) float32
    rotation: torch.Tensor     # (d_rot, d) float32 orthonormal
    codebooks: torch.Tensor    # (pq_dim, K, pq_len) float32; K = 2**bits, 32 when split
    list_codes: torch.Tensor   # (n_lists, capacity, pq_dim) uint8
    list_ids: torch.Tensor     # (n_lists, capacity) int32, -1 padding
    list_sizes: torch.Tensor   # (n_lists,) int32
    list_consts: torch.Tensor | None = None  # (n_lists, capacity) split L2, else (n_lists, 0)
    list_scales: torch.Tensor | None = None  # (0,) unless residual_scale_norm
    list_sig: torch.Tensor | None = None     # (n_lists, 0, 0) unless fast_scan
    sig_scales: torch.Tensor | None = None   # (0,) unless fast_scan
    metric: DistanceType = DistanceType.L2Expanded
    codebook_kind: str = "per_subspace"
    pq_bits: int = 8
    split_factor: float = 1.3
    pq_split: bool = False
    data_kind: str = "float32"
    rotation_kind: str = "none"
    codebook_loss: str = "l2"
    fast_scan: str = "none"
    tuned: dict | None = None

    def __post_init__(self):
        dev = self.centers.device
        n = self.list_codes.shape[0]
        if self.list_consts is None:
            self.list_consts = torch.zeros((n, 0), dtype=torch.float32, device=dev)
        if self.list_scales is None:
            self.list_scales = torch.zeros((0,), dtype=torch.float32, device=dev)
        if self.list_sig is None:
            self.list_sig = torch.zeros((n, 0, 0), dtype=torch.uint8, device=dev)
        if self.sig_scales is None:
            self.sig_scales = torch.zeros((0,), dtype=torch.float32, device=dev)

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
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_dim(self) -> int:
        return self.list_codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.rot_dim // self.pq_dim

    @property
    def capacity(self) -> int:
        return self.list_codes.shape[1]

    @property
    def size(self) -> int:
        """Total stored vectors."""
        return int(self.list_sizes.to(torch.int64).sum())

    @property
    def scale_normed(self) -> bool:
        return self.list_scales.shape[0] > 0

    @property
    def has_fast_scan(self) -> bool:
        return self.list_sig.shape[-1] > 0


def _check_supported(index: IvfPqIndex) -> None:
    """Index features this port cannot yet search or extend."""
    if index.codebook_kind != "per_subspace":
        _not_ported(f"codebook_kind={index.codebook_kind!r}")
    if index.scale_normed:
        _not_ported("residual_scale_norm")
    if index.data_kind != "float32":
        _not_ported(f"an index of {index.data_kind} vectors")


def _check_split_consts(index: IvfPqIndex) -> None:
    """A split L2 index must carry its per-vector cross terms."""
    if (index.pq_split and index.metric != DistanceType.InnerProduct
            and index.capacity > 0):
        expects(tuple(index.list_consts.shape) == tuple(index.list_ids.shape),
                "pq_split L2 index needs list_consts of shape %s (per-vector "
                "cross terms), got %s — build via build()/extend(), which "
                "populate them", tuple(index.list_ids.shape),
                tuple(index.list_consts.shape))


def _default_pq_dim(d: int, pq_bits: int = 4) -> int:
    """The code bytes of the reference default (d/2 dims at 8 bits, d at 4),
    rounded down to a multiple of 8."""
    pq = max((d * 8) // (2 * pq_bits), 1)
    if pq >= 8:
        pq = (pq // 8) * 8
    return min(pq, d)


def _make_rotation(g, d_rot: int, d: int, force_random: bool, device):
    """Reference: make_rotation_matrix (ivf_pq_build.cuh:121): identity (or
    its zero-padded form) unless forced, else the Q of a Gaussian matrix."""
    if not force_random:
        rot = torch.zeros((d_rot, d), dtype=torch.float32, device=device)
        i = torch.arange(min(d_rot, d), device=device)
        rot[i, i] = 1.0
        return rot
    m = max(d_rot, d)
    q, _ = torch.linalg.qr(torch.randn((m, m), generator=g, device=device))
    return q[:d_rot, :d].contiguous()


def _nearest(sv, cb):
    """Index of the nearest row of ``cb`` (B, K, L) for every row of ``sv``
    (B, n, L), by ``|c|² - 2·v·c``, ties to the lowest; (B, n) int64. Works
    in row blocks that bound the (B, rows, K) scores."""
    b, n, _ = sv.shape
    k = cb.shape[1]
    cn = (cb * cb).sum(dim=-1)[:, None, :]
    rows = max(1, _BLOCK_BYTES // (4 * b * k))
    out = []
    for i in range(0, n, rows):
        with full_f32():
            d2 = cn - 2.0 * torch.bmm(sv[:, i:i + rows], cb.transpose(1, 2))
        out.append(torch.argmin(d2, dim=-1))
    return torch.cat(out, dim=1)


def _segment_means(vals, labels, k: int, fallback):
    """Per (batch, label) mean of ``vals`` (B, n, L); ``fallback`` (B, k, L)
    where a label has no member."""
    b, n, dim = vals.shape
    flat = (labels + k * torch.arange(b, device=vals.device)[:, None]).reshape(-1)
    sums = torch.zeros((b * k, dim), dtype=torch.float32, device=vals.device)
    sums.index_add_(0, flat, vals.reshape(-1, dim))
    counts = torch.bincount(flat, minlength=b * k).to(torch.float32).reshape(b, k, 1)
    means = sums.reshape(b, k, dim) / torch.clamp_min(counts, 1.0)
    return torch.where(counts > 0, means, fallback)


def _train_codebooks_batched(subvecs, g, n_codes: int, n_iters: int):
    """All codebooks at once: subvecs (B, n, pq_len) -> (B, n_codes, pq_len),
    one batched Lloyd EM from distinct random members (with replacement when
    a pool has fewer than n_codes rows). Reference: train_per_subset :343."""
    sv = subvecs.to(torch.float32)
    b, n, dim = sv.shape
    if n >= n_codes:
        init = torch.rand((b, n), generator=g, device=sv.device).topk(n_codes, dim=1).indices
    else:
        init = torch.randint(0, n, (b, n_codes), generator=g, device=sv.device)
    c = torch.gather(sv, 1, init[..., None].expand(b, n_codes, dim))
    for _ in range(n_iters):
        c = _segment_means(sv, _nearest(sv, c), n_codes, c)
    return c


def _train_split_codebooks(subvecs, g, n_iters: int):
    """Two-stage 4+4-bit residual codebooks (pq8_split): 16-means over the
    subvectors, 16-means over their stage-1 residuals, then three rounds of
    alternating re-fits under the joint 256-codeword encoding. Returns (B, 32, pq_len): stage 1 in [:, :16], stage 2 in
    [:, 16:]."""
    sv = subvecs.to(torch.float32)
    b, n, dim = sv.shape
    c1 = _train_codebooks_batched(sv, g, 16, n_iters)
    code1 = _nearest(sv, c1)
    resid2 = sv - torch.gather(c1, 1, code1[..., None].expand(b, n, dim))
    c2 = _train_codebooks_batched(resid2, g, 16, n_iters)
    for _ in range(3):
        comp = (c1[:, :, None, :] + c2[:, None, :, :]).reshape(b, 256, dim)
        code = _nearest(sv, comp)
        hi, lo = code // 16, code % 16
        r1 = sv - torch.gather(c2, 1, lo[..., None].expand(b, n, dim))
        c1n = _segment_means(r1, hi, 16, c1)
        r2 = sv - torch.gather(c1n, 1, hi[..., None].expand(b, n, dim))
        c2 = _segment_means(r2, lo, 16, c2)
        c1 = c1n
    return torch.cat([c1, c2], dim=1)


def _composed_codebooks(codebooks):
    """Split codebooks (B, 32, L) as the effective (B, 256, L) codebook:
    entry hi*16 + lo = cb1[hi] + cb2[lo]."""
    cb = codebooks.to(torch.float32)
    comp = cb[:, :16, None, :] + cb[:, None, 16:, :]
    return comp.reshape(cb.shape[0], 256, cb.shape[-1])


def _pq_cross_consts(codes, codebooks):
    """Per-vector scan constant of split L2 scoring,
    Σ_s 2·cb1[s, hi_s]·cb2[s, lo_s]: the cross term of |cb1 + cb2|² that the
    separate hi / lo LUT halves cannot carry, paid once at encode time."""
    cb = codebooks.to(torch.float32)
    with full_f32():
        x = 2.0 * torch.einsum("bhl,bgl->bhg", cb[:, :16], cb[:, 16:])
    xf = x.reshape(-1)           # flat b*256 + hi*16 + lo = b*256 + code
    offs = torch.arange(codes.shape[1], device=codes.device) * 256
    out = []
    for i in range(0, codes.shape[0], 65536):
        out.append(xf[codes[i:i + 65536].to(torch.int64) + offs].sum(dim=1))
    return torch.cat(out)


def _encode(residuals, codebooks, tile: int):
    """Nearest codebook entry per subspace: residuals (n, pq_dim, pq_len),
    codebooks (pq_dim, K, pq_len) -> (n, pq_dim) uint8, by argmin of
    ``|c|² - 2·r·c`` over row tiles."""
    cb = codebooks.to(torch.float32)
    cn = (cb * cb).sum(dim=-1)[None]
    out = []
    for i in range(0, residuals.shape[0], tile):
        with full_f32():
            dots = torch.einsum("tsl,skl->tsk", residuals[i:i + tile], cb)
        out.append(torch.argmin(cn - 2.0 * dots, dim=-1).to(torch.uint8))
    if not out:
        return torch.zeros((0, cb.shape[0]), dtype=torch.uint8, device=cb.device)
    return torch.cat(out)


def _fill_code_lists(codes, ids, labels, n_lists: int, capacity: int, consts=None):
    """Scatter codes, ids (and split L2 constants) into padded lists, each
    list's rows in input order."""
    pos, counts = list_positions(labels, n_lists)
    lab, pos = labels.to(torch.int64), pos.to(torch.int64)
    dev = codes.device
    buf = torch.zeros((n_lists, capacity, codes.shape[1]), dtype=torch.uint8, device=dev)
    buf[lab, pos] = codes
    idbuf = torch.full((n_lists, capacity), -1, dtype=torch.int32, device=dev)
    idbuf[lab, pos] = ids.to(torch.int32)
    if consts is None:
        cbuf = torch.zeros((n_lists, 0), dtype=torch.float32, device=dev)
    else:
        cbuf = torch.zeros((n_lists, capacity), dtype=torch.float32, device=dev)
        cbuf[lab, pos] = consts
    return buf, idbuf, counts, cbuf


def build(params: IndexParams, dataset, res: Resources | None = None) -> IvfPqIndex:
    """Build the index (reference: ivf_pq::build, ivf_pq-inl.cuh:270) on the
    handle's device."""
    res = res or default_resources()
    x = res.put(dataset)
    expects(x.ndim == 2, "dataset must be (n, d)")
    n, d = (int(s) for s in x.shape)
    expects(params.n_lists <= n, "n_lists > n_samples")
    expects(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8] (ref ivf_pq_types.hpp:68)")
    mt = resolve_metric(params.metric)
    expects(mt in _L2_METRICS or mt == DistanceType.InnerProduct,
            "ivf_pq supports L2 / inner_product metrics, got %s", mt.name)
    expects(params.codebook_kind in ("per_subspace", "per_cluster", "auto"),
            "codebook_kind must be per_subspace|per_cluster|auto")
    expects(params.rotation in ("none", "opq"),
            "rotation must be 'none' or 'opq', got %r", params.rotation)
    expects(params.codebook_loss in ("l2", "anisotropic"),
            "codebook_loss must be 'l2' or 'anisotropic', got %r", params.codebook_loss)
    expects(params.fast_scan in ("none", "1bit", "4bit"),
            "fast_scan must be 'none', '1bit' or '4bit', got %r", params.fast_scan)
    if params.codebook_kind != "per_subspace":
        _not_ported(f"codebook_kind={params.codebook_kind!r}")
    if params.residual_scale_norm:
        _not_ported("residual_scale_norm")
    if params.rotation != "none":
        _not_ported("rotation='opq'")
    if params.codebook_loss != "l2":
        _not_ported("codebook_loss='anisotropic'")
    if params.fast_scan != "none":
        _not_ported(f"fast_scan={params.fast_scan!r}")
    if not x.dtype.is_floating_point:
        _not_ported(f"a {x.dtype} dataset")
    x = x.to(torch.float32)
    dev = x.device
    pq_dim = params.pq_dim or _default_pq_dim(d, params.pq_bits)
    pq_len = -(-d // pq_dim)
    d_rot = pq_dim * pq_len
    n_codes = 1 << params.pq_bits

    # 1. coarse quantizer
    max_train = max(int(n * params.kmeans_trainset_fraction), params.n_lists)
    kb = KMeansBalancedParams(
        n_iters=params.kmeans_n_iters,
        metric="inner_product" if mt == DistanceType.InnerProduct else "sqeuclidean",
        seed=params.seed, max_train_points=min(max_train, n),
        train_mode=params.kmeans_train_mode, batch_rows=params.kmeans_batch_rows)
    centers = kmeans_balanced.fit(kb, x, params.n_lists, res=res)

    # 2. rotation, from the build's own random stream (the coarse trainer's
    # is seeded with params.seed itself)
    g = torch.Generator(device=dev).manual_seed(
        int(np.random.SeedSequence([int(params.seed), 1]).generate_state(1)[0]))
    rotation = _make_rotation(g, d_rot, d, params.force_random_rotation, dev)
    with full_f32():
        centers_rot = centers @ rotation.T

    # 3. rotated residuals of a trainset
    n_train = min(max_train, n)
    xt = x[torch.randperm(n, generator=g, device=dev)[:n_train]] if n_train < n else x
    tile = _choose_tile(n_train, params.n_lists, 1, res.workspace_bytes)
    labels = assign_to_lists(xt, centers, mt, tile)
    with full_f32():
        resid = (xt - centers[labels.to(torch.int64)]) @ rotation.T
    del xt
    sub = resid.reshape(n_train, pq_dim, pq_len).transpose(0, 1).contiguous()
    del resid

    # 4. per-subspace codebooks (ref train_per_subset :343)
    split_pref = (params.pq8_split if params.pq8_split is not None
                  else mt != DistanceType.InnerProduct)
    split = params.pq_bits == 8 and bool(split_pref)
    if split:
        codebooks = _train_split_codebooks(sub, g, params.kmeans_n_iters)
    else:
        codebooks = _train_codebooks_batched(sub, g, n_codes, params.kmeans_n_iters)
    del sub

    index = IvfPqIndex(
        centers=centers, centers_rot=centers_rot, rotation=rotation,
        codebooks=codebooks,
        list_codes=torch.zeros((params.n_lists, 0, pq_dim), dtype=torch.uint8, device=dev),
        list_ids=torch.zeros((params.n_lists, 0), dtype=torch.int32, device=dev),
        list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        metric=mt, codebook_kind="per_subspace", pq_bits=params.pq_bits,
        split_factor=params.split_factor, pq_split=split)
    if not params.add_data_on_build:
        return index
    return _extend_f32(index, x, torch.arange(n, dtype=torch.int32, device=dev), res=res)


def extend(index: IvfPqIndex, new_vectors, new_ids=None, res: Resources | None = None,
           split_factor: float | None = None) -> IvfPqIndex:
    """Encode and append vectors (reference: ivf_pq::extend). Returns a new
    index on the index's device; ids default to ``index.size + arange``."""
    _check_supported(index)
    if index.codebook_loss != "l2":
        _not_ported("extending an index with anisotropic codebooks")
    if index.has_fast_scan:
        _not_ported("extending an index with a fast-scan tier")
    x = torch.as_tensor(new_vectors)
    if not x.dtype.is_floating_point:
        _not_ported(f"{x.dtype} vectors")
    return _extend_f32(index, x.to(device=index.device, dtype=torch.float32), new_ids,
                       res=res, split_factor=split_factor)


def _extend_f32(index: IvfPqIndex, x, new_ids=None, res: Resources | None = None,
                split_factor: float | None = None) -> IvfPqIndex:
    """extend() for float32 vectors already on the index's device."""
    res = res or default_resources()
    _check_split_consts(index)
    expects(x.ndim == 2 and x.shape[1] == index.dim, "vector dim mismatch")
    dev = index.device
    n_new = x.shape[0]
    if new_ids is None:
        new_ids = index.size + torch.arange(n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
        expects(new_ids.shape == (n_new,), "ids/vectors length mismatch")

    tile = _choose_tile(n_new, index.n_lists, 1, res.workspace_bytes)
    labels = assign_to_lists(x, index.centers, index.metric, tile)
    with full_f32():
        resid = (x - index.centers[labels.to(torch.int64)]) @ index.rotation.T
    resid = resid.reshape(n_new, index.pq_dim, index.pq_len)
    # split indexes encode against the composed 256-entry codebook, whose
    # flat index is hi*16 + lo
    enc_cb = _composed_codebooks(index.codebooks) if index.pq_split else index.codebooks
    n_codes = enc_cb.shape[-2]
    enc_tile = max(min(n_new, res.workspace_bytes // max(index.pq_dim * n_codes * 4, 1)), 8)
    codes = _encode(resid, enc_cb, min(enc_tile, 8192))
    del resid
    consts = None
    if index.pq_split and index.metric != DistanceType.InnerProduct:
        consts = _pq_cross_consts(codes, index.codebooks)

    if index.capacity > 0 and index.size > 0:
        old = index.list_ids.reshape(-1) >= 0
        old_labels = torch.arange(index.n_lists, dtype=torch.int32, device=dev
                                  ).repeat_interleave(index.capacity)[old]
        codes = torch.cat([index.list_codes.reshape(-1, index.pq_dim)[old], codes])
        new_ids = torch.cat([index.list_ids.reshape(-1)[old], new_ids])
        labels = torch.cat([old_labels, labels])
        if consts is not None:
            consts = torch.cat([index.list_consts.reshape(-1)[old], consts])

    # the capacity policy: oversized lists split into sub-lists that share
    # their parent's center (and rotated center), so the codes stay valid
    sf = index.split_factor if split_factor is None else split_factor
    labels, rep, n_lists, capacity, _ = bound_capacity(labels, index.n_lists, sf)
    centers, centers_rot = index.centers, index.centers_rot
    if rep is not None:
        reps = torch.from_numpy(rep).to(dev)
        centers = centers.repeat_interleave(reps, dim=0)
        centers_rot = centers_rot.repeat_interleave(reps, dim=0)
    buf, idbuf, sizes, cbuf = _fill_code_lists(codes, new_ids, labels, n_lists,
                                               capacity, consts)
    return dataclasses.replace(
        index, centers=centers, centers_rot=centers_rot, list_codes=buf,
        list_ids=idbuf, list_sizes=sizes, list_consts=cbuf,
        list_sig=torch.zeros((n_lists, 0, 0), dtype=torch.uint8, device=dev),
        split_factor=sf)


def resolve_scan_impl(params: SearchParams, index: IvfPqIndex, n_codes: int) -> str:
    """Validate ``params.scan_impl`` and resolve it to "kernel", "onehot" or
    "select"."""
    expects(params.scan_impl in ("auto", "onehot", "select", "pallas", "kernel"),
            "scan_impl must be 'auto', 'onehot', 'select', 'pallas' or 'kernel', "
            "got %r", params.scan_impl)
    narrow_stages = index.pq_split or n_codes <= 16
    scan_impl = {"pallas": "kernel"}.get(params.scan_impl, params.scan_impl)
    if scan_impl == "auto":
        scan_impl = ("kernel" if narrow_stages and params.lut_dtype != "int8"
                     else "onehot")
    expects(scan_impl == "onehot" or narrow_stages,
            "scan_impl=%r needs 16-wide LUT stages (pq_bits=4 or "
            "nibble-split pq8); this index has %d-entry codebooks",
            params.scan_impl, n_codes)
    expects(scan_impl == "onehot" or params.lut_dtype != "int8",
            "lut_dtype='int8' is a one-hot-contraction optimization; use "
            "scan_impl='onehot' (or lut_dtype float32/bfloat16) instead")
    return scan_impl


def _coarse_probes(index: IvfPqIndex, qf, n_probes: int):
    """The ``n_probes`` nearest lists of each query (ref select_clusters
    :68), (m, n_probes) int32, ties to the lowest list."""
    inner = index.metric == DistanceType.InnerProduct
    with full_f32():
        cscore = qf @ index.centers.T
    if not inner:
        cn = (index.centers * index.centers).sum(dim=1)
        cscore = cn[None, :] - 2.0 * cscore
    return _select_k(cscore, None, n_probes, not inner)[1]


def _select_scores(codes, lut, split: bool):
    """Σ_s LUT[s, code_s] as compare+select passes (the JAX package's
    ``_select_scores``): codes (..., cap, S) uint8, lut (..., S, K)."""
    lutf = lut.to(torch.float32)
    acc = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    if split:
        hi, lo = codes >> 4, codes & 0xF
        for kk in range(16):
            acc = acc + torch.where(hi == kk, lutf[..., None, :, kk], 0.0)
            acc = acc + torch.where(lo == kk, lutf[..., None, :, 16 + kk], 0.0)
    else:
        for kk in range(lut.shape[-1]):
            acc = acc + torch.where(codes == kk, lutf[..., None, :, kk], 0.0)
    return acc.sum(dim=-1)


def _onehot_scores(codes, lut, split: bool, lut_dtype: str):
    """Σ_s LUT[s, code_s] as the JAX package's one-hot contraction:
    onehot(codes) (cap, S·K) times the flat LUT per pair, in float32 with
    the LUT rounded to ``lut_dtype`` (int8: quantized per pair with a
    symmetric scale, summed exactly, scaled back). Pairs go through in
    blocks that bound the one-hot operand."""
    *lead, cap, s_dim = codes.shape
    k = lut.shape[-1]
    codes = codes.reshape(-1, cap, s_dim)
    lutf = lut.reshape(-1, s_dim * k).to(torch.float32)
    scale = None
    if lut_dtype == "int8":
        amax = lutf.abs().amax(dim=1, keepdim=True)
        scale = torch.clamp_min(amax, 1e-30) / 127.0
        lutf = torch.clamp(torch.round(lutf / scale), -127, 127)
    elif lut_dtype == "bfloat16":
        lutf = lutf.to(torch.bfloat16).to(torch.float32)
    block = max(1, _BLOCK_BYTES // (4 * cap * s_dim * k))
    ar = torch.arange(16 if split else k, device=codes.device).to(codes.dtype)
    out = []
    for i in range(0, codes.shape[0], block):
        c = codes[i:i + block, ..., None]
        oh = (torch.cat([(c >> 4) == ar, (c & 15) == ar], dim=-1) if split
              else c == ar)
        oh = oh.reshape(c.shape[0], cap, s_dim * k).to(torch.float32)
        with full_f32():
            out.append(torch.bmm(oh, lutf[i:i + block, :, None])[..., 0])
    scores = torch.cat(out)
    if scale is not None:
        scores = scores * scale
    return scores.reshape(*lead, cap)


def _lut_type(lut_dtype: str):
    """The type the scan kernels and the "select" form read the LUT in."""
    return torch.bfloat16 if lut_dtype == "bfloat16" else torch.float32


def _scan(index: IvfPqIndex, pc, lut, scan_impl: str, lut_dtype: str):
    """Scores (T, pc, cap) of every slot of each probed list."""
    t, p = pc.shape
    if scan_impl == "kernel":
        from ..ops.pq_scan import pq_scan

        lut_t = lut.reshape(t * p, index.pq_dim, lut.shape[-1]).to(_lut_type(lut_dtype))
        lut_t = lut_t.contiguous()
        scores = pq_scan(index.list_codes, pc.reshape(-1).to(torch.int32).contiguous(),
                         lut_t, split=index.pq_split)
        return scores.reshape(t, p, index.capacity)
    codes = index.list_codes[pc.to(torch.int64)]        # (T, pc, cap, pq_dim)
    if scan_impl == "select":
        return _select_scores(codes, lut.to(_lut_type(lut_dtype)), index.pq_split)
    return _onehot_scores(codes, lut, index.pq_split, lut_dtype)


def _codebooks_f32(index: IvfPqIndex):
    """The codebooks (pq_dim, K, pq_len) as float32 and their squared norms."""
    cb = index.codebooks.to(torch.float32)
    return cb, (cb * cb).sum(dim=-1)


def _probe_luts(index: IvfPqIndex, qrot, pc, cb, cb_n2):
    """LUT (T, pc, pq_dim, K) and bias (T, pc) of each (query, probe) pair
    (ref ivfpq_search_worker :419): for L2, ``|c|² - 2·r·c`` over the
    rotated residual r = q_rot - c_rot and the bias Σ_s |r_s|²; for inner
    product, ``q_rot·c`` and the bias q_rot·c_rot."""
    t, p = pc.shape
    pq_dim, pq_len = index.pq_dim, index.pq_len
    crot = index.centers_rot[pc]                          # (T, pc, d_rot)
    with full_f32():
        if index.metric == DistanceType.InnerProduct:
            qs = qrot.reshape(t, 1, pq_dim, pq_len).expand(t, p, pq_dim, pq_len)
            return (torch.einsum("tpsl,skl->tpsk", qs, cb),
                    torch.einsum("td,tpd->tp", qrot, crot))
        r = (qrot[:, None, :] - crot).reshape(t, p, pq_dim, pq_len)
        return (cb_n2[None, None] - 2.0 * torch.einsum("tpsl,skl->tpsk", r, cb),
                (r * r).sum(dim=(2, 3)))


def _fuses_scan_and_select(index: IvfPqIndex, scan_impl: str, select_impl: str, pc: int,
                           k: int, lut_dtype: str) -> bool:
    """True when a chunk step of ``pc`` probes takes ``pq_scan_topk``, the
    scan fused with its select: the kernel scan, a select that would go to
    the ``topk`` kernel under ``select_k_impl``'s own rule ("kernel", or
    "auto" with :func:`wide_dispatch_ok` on the chunk's pc x cap float32
    scores), and a shape whose shared memory fits the fused kernel."""
    from ..ops.pq_scan import pq_scan_topk_fits

    if scan_impl != "kernel" or select_impl == "torch":
        return False
    if select_impl == "auto" and not wide_dispatch_ok(pc * index.capacity, k, torch.float32,
                                                      index.device):
        return False
    return pq_scan_topk_fits(index.pq_dim, index.pq_split, _lut_type(lut_dtype), pc)


def _pq_search(index: IvfPqIndex, queries, n_probes: int, k: int, query_tile: int,
               probe_chunk: int, lut_dtype: str, scan_impl: str,
               select_impl: str = "auto"):
    """The tiled search (the JAX package's ``_pq_search``). A chunk step
    either runs ``pq_scan_topk`` (:func:`_fuses_scan_and_select`) or scans,
    adds the bias (and split L2's constants), masks empty slots and selects;
    a tile of one chunk keeps that chunk's k, a tile of several merges them."""
    m = queries.shape[0]
    qf = queries.to(torch.float32)
    inner = index.metric == DistanceType.InnerProduct
    probes = _coarse_probes(index, qf, n_probes)
    with full_f32():
        qrot = qf @ index.rotation.T
    cb, cb_n2 = _codebooks_f32(index)
    bad = -math.inf if inner else math.inf
    consts = index.list_consts if index.pq_split and not inner else None
    fused = _fuses_scan_and_select(index, scan_impl, select_impl, probe_chunk, k, lut_dtype)
    dists, idx = [], []
    for t0 in range(0, m, query_tile):
        q = qrot[t0:t0 + query_tile]
        pr = probes[t0:t0 + query_tile].to(torch.int64)
        t = q.shape[0]
        cvs, cis = [], []
        for c0 in range(0, n_probes, probe_chunk):
            pc = pr[:, c0:c0 + probe_chunk]               # (T, pc)
            lut, bias = _probe_luts(index, q, pc, cb, cb_n2)
            if fused:
                from ..ops.pq_scan import pq_scan_topk

                v, i = pq_scan_topk(index.list_codes, index.list_ids,
                                    pc.to(torch.int32).contiguous(),
                                    lut.to(_lut_type(lut_dtype)).contiguous(),
                                    bias.contiguous(), k, not inner, split=index.pq_split,
                                    list_consts=consts)
            else:
                scores = _scan(index, pc, lut, scan_impl, lut_dtype) + bias[:, :, None]
                if consts is not None:
                    scores = scores + consts[pc]
                ids = index.list_ids[pc]                  # (T, pc, cap)
                scores = torch.where(ids >= 0, scores, bad)
                v, i = select_k_impl(scores.reshape(t, -1), ids.reshape(t, -1), k,
                                     not inner, impl=select_impl)
            cvs.append(v)
            cis.append(i)
        if len(cvs) > 1:
            v, i = select_k_impl(torch.cat(cvs, dim=1), torch.cat(cis, dim=1), k,
                                 not inner, impl=select_impl)
        dists.append(v)
        idx.append(i)
    dists = torch.cat(dists)
    if index.metric in _SQRT_METRICS:
        dists = torch.where(torch.isfinite(dists),
                            torch.sqrt(torch.clamp_min(dists, 0.0)), dists)
    return dists, torch.cat(idx)


def search(params: SearchParams, index: IvfPqIndex, queries, k: int,
           sample_filter=None, res: Resources | None = None):
    """Search (reference: ivf_pq::search :723). Returns (distances (m, k)
    float32, ids (m, k) int32) on the index's device; distances are the
    PQ-quantized ones, id -1 marks empty candidate slots. A handle ``res``
    that names another device than the index's raises."""
    if res is not None:
        res.check_holds(index.device, "the ivf_pq index")
    res = res or default_resources()
    if sample_filter is not None:
        _not_ported("sample_filter")
    queries = torch.as_tensor(queries).to(index.device)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "query dim mismatch")
    _check_supported(index)
    expects(index.capacity > 0, "index is empty")
    _check_split_consts(index)
    expects(index.size > 0, "index is empty")
    n_probes = min(params.n_probes, index.n_lists)
    expects(k <= n_probes * index.capacity, "k exceeds probed candidate pool")
    expects(params.lut_dtype in ("float32", "bfloat16", "int8"),
            "lut_dtype must be 'float32', 'bfloat16' or 'int8', got %r", params.lut_dtype)
    n_codes = index.codebooks.shape[-2]
    scan_impl = resolve_scan_impl(params, index, n_codes)
    expects(params.select_impl in _SELECT_IMPLS,
            "select_impl must be 'auto', 'xla' or 'pallas', got %r", params.select_impl)
    if params.select_impl == "pallas":
        from ..ops.topk import TOPK_MAX_K

        expects(k <= TOPK_MAX_K, "select_impl='pallas' selects with the topk kernel: "
                "k=%d must be <= %d", k, TOPK_MAX_K)
    expects(int(params.funnel_widen) >= 1, "funnel_widen must be >= 1, got %d",
            params.funnel_widen)
    if params.funnel_widen > 1:
        _not_ported("the fast-scan funnel (funnel_widen > 1)")
    expects(params.scan_order in ("auto", "tiled", "grouped"),
            "scan_order must be 'auto', 'tiled' or 'grouped', got %r", params.scan_order)
    if params.scan_order == "grouped":
        _not_ported("scan_order='grouped'")
    query_tile, probe_chunk = plan_search_tiles(
        queries.shape[0], n_probes, int(k), index.capacity,
        bytes_per_probe_row=pq_scan_bytes_per_probe_row(index.capacity, index.pq_dim,
                                                        n_codes),
        budget_bytes=res.workspace_bytes, max_query_tile=128)
    return _pq_search(index, queries, n_probes, int(k), query_tile, probe_chunk,
                      params.lut_dtype, scan_impl, _SELECT_IMPLS[params.select_impl])


def write_index(f, index: IvfPqIndex) -> None:
    """Serialize to an open binary stream, in the JAX package's layout."""
    serialize_header(f, "ivf_pq")
    serialize_scalar(f, int(index.metric))
    serialize_scalar(f, index.codebook_kind)
    serialize_scalar(f, int(index.pq_bits))
    serialize_scalar(f, float(index.split_factor))
    serialize_scalar(f, bool(index.pq_split))
    serialize_scalar(f, index.data_kind)
    for arr in (index.centers, index.centers_rot, index.rotation, index.codebooks,
                index.list_codes, index.list_ids, index.list_sizes,
                index.list_consts, index.list_scales):
        serialize_mdspan(f, arr)
    serialize_tuned(f, index.tuned)
    # the raft_tpu/13 quantization-codec record, after the tuned record
    if version_number(core_serialize.SERIALIZATION_VERSION) >= 13:
        serialize_scalar(f, index.rotation_kind)
        serialize_scalar(f, index.codebook_loss)
        serialize_scalar(f, index.fast_scan)
        serialize_mdspan(f, index.list_sig)
        serialize_mdspan(f, index.sig_scales)


def read_index(f, device=None) -> IvfPqIndex:
    """Deserialize from an open binary stream (every version the JAX
    package's loader reads), onto ``device`` (the CPU by default)."""
    ver = check_header(f, "ivf_pq")
    old = ver in ("raft_tpu/3", "raft_tpu/4", "raft_tpu/5")
    metric = DistanceType(deserialize_scalar(f))
    codebook_kind = deserialize_scalar(f)
    pq_bits = deserialize_scalar(f)
    split_factor = float(deserialize_scalar(f))
    pq_split = bool(deserialize_scalar(f))
    kind = "float32" if old else deserialize_scalar(f)   # raft_tpu/6 added data_kind
    arrs = [deserialize_mdspan(f, device) for _ in range(8)]
    # raft_tpu/7 added list_scales
    if old or ver == "raft_tpu/6":
        arrs.append(torch.zeros((0,), dtype=torch.float32, device=device))
    else:
        arrs.append(deserialize_mdspan(f, device))
    tuned = deserialize_tuned(f, ver)
    if version_number(ver) >= 13:
        rotation_kind = deserialize_scalar(f)
        codebook_loss = deserialize_scalar(f)
        fast_scan = deserialize_scalar(f)
        arrs.append(deserialize_mdspan(f, device))     # list_sig
        arrs.append(deserialize_mdspan(f, device))     # sig_scales
    else:
        rotation_kind, codebook_loss, fast_scan = "none", "l2", "none"
        arrs.append(torch.zeros((arrs[0].shape[0], 0, 0), dtype=torch.uint8, device=device))
        arrs.append(torch.zeros((0,), dtype=torch.float32, device=device))
    return IvfPqIndex(*arrs, metric=metric, codebook_kind=codebook_kind, pq_bits=pq_bits,
                      split_factor=split_factor, pq_split=pq_split, data_kind=kind,
                      rotation_kind=rotation_kind, codebook_loss=codebook_loss,
                      fast_scan=fast_scan, tuned=tuned)


def save(index: IvfPqIndex, path: str) -> None:
    """Serialize (reference: ivf_pq_serialize.cuh:52-110); atomic, a crashed
    save keeps the previous file."""
    with core_serialize.atomic_write(path) as f:
        write_index(f, index)


def load(path: str, res: Resources | None = None) -> IvfPqIndex:
    """Deserialize onto the handle's device."""
    dev = (res or default_resources()).torch_device
    with open(path, "rb") as f:
        return read_index(f, dev)


_STATE_ARRAYS = ("centers", "centers_rot", "rotation", "codebooks", "list_codes",
                 "list_ids", "list_sizes", "list_consts", "list_scales", "list_sig",
                 "sig_scales")


def from_state(arrays: dict, res: Resources | None = None, **meta) -> IvfPqIndex:
    """An :class:`IvfPqIndex` from another index's state: its arrays as numpy
    (``centers``, ``centers_rot``, ``rotation``, ``codebooks``,
    ``list_codes``, ``list_ids``, ``list_sizes``, and where present
    ``list_consts``, ``list_scales``, ``list_sig``, ``sig_scales``) and its
    scalar fields as keywords (``metric``, ``codebook_kind``, ``pq_bits``,
    ``split_factor``, ``pq_split``, ...). Placed on the handle's device;
    searches answer as the index that gave the state does."""
    res = res or default_resources()
    unknown = set(arrays) - set(_STATE_ARRAYS)
    expects(not unknown, "from_state: unknown arrays %s", sorted(unknown))
    missing = [a for a in _STATE_ARRAYS[:7] if a not in arrays]
    expects(not missing, "from_state: missing arrays %s", missing)
    fields = {name: res.put(a) for name, a in arrays.items() if a is not None}
    if "metric" in meta:
        m = meta["metric"]
        meta["metric"] = (DistanceType(int(m)) if isinstance(m, (int, np.integer))
                          else resolve_metric(m))
    return IvfPqIndex(**fields, **meta)
