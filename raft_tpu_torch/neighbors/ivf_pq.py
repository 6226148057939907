"""IVF-PQ: an inverted-file index of product-quantized residuals.

Counterpart of raft_tpu/neighbors/ivf_pq.py (reference:
neighbors/ivf_pq-inl.cuh build :270 / search :723, detail/ivf_pq_build.cuh,
detail/ivf_pq_search.cuh). The same index layout and the same algorithm:

- **Build**: balanced k-means coarse centers, an identity (or random
  orthonormal) rotation, per-subspace codebooks trained by batched EM over
  the rotated residuals of a trainset, codes stored one byte per
  (vector, subspace) in padded lists (n_lists, capacity, pq_dim); lists
  larger than ``split_factor`` x the mean split into sub-lists that share
  their parent's center, a build's split held within 1.2x the list bytes
  ``obs.mem.plan()`` prices (``_list_utils.priced_capacity``).
  ``pq_bits=8`` with ``pq8_split`` (the L2 default) stores a two-stage
  4+4-bit code whose cross term rides in ``list_consts``.
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

The rest of the JAX package's surface comes with it: int8 / uint8 datasets
(ingested as float32 in the signed-byte domain, queries coerced the same
way), per-cluster and "auto" codebooks, ``residual_scale_norm``, OPQ
rotations, anisotropic codebooks, the fast-scan tier and its funnel
(``funnel_widen > 1``; its signature scan is the ``pq_scan`` kernel over the
packed signatures), ``scan_order="grouped"``, sample filters (on the kernel
route a packed bitset inside ``pq_scan_topk``) and ``batched_searcher``.
Trained artifacts (codebooks, OPQ rotations, scales) come from torch random
streams, so the port's builds match the JAX package's in recall, and a JAX
index loaded from its file searches the same.

A chunked reader (:mod:`raft_tpu_torch.core.chunked`) builds and extends
out of core, as does a host array past ``chunked.STREAM_EXTEND_BYTES``
handed to ``extend``: the assign, encode and fill run per tile over staged
chunks, to the in-core result bit for bit.

Not yet ported (raises ``RaftError("not yet ported")``): ``batched_searcher``
of a tuned index without params.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any

import numpy as np
import torch

from ..cluster import kmeans_balanced
from ..cluster.kmeans_balanced import KMeansBalancedParams
from ..core import serialize as core_serialize
from ..core import chunked
from ..core.chunked import is_reader
from ..core.errors import expects, fail
from ..core.resources import Resources, default_resources
from ..core.serialize import (check_header, deserialize_mdspan, deserialize_scalar,
                              deserialize_tuned, serialize_header, serialize_mdspan,
                              serialize_scalar, serialize_tuned, version_number)
from ..distance.pairwise import _choose_tile, full_f32
from ..distance.types import DistanceType, resolve_metric
from ..matrix.ops import segment_sum
from ..matrix.select_k import _select_k, select_k_impl, wide_dispatch_ok
from ..obs import mem as obs_mem
from ..obs.instrument import dtype_of, instrument, nrows
from .brute_force import _as_signed, _coerce_queries, _dtype_name
from .sample_filter import apply_id_filter, resolve_filter, validate_filter_covers
from ._list_utils import (assign_to_lists, bound_capacity, fill_tile,
                          funnel_scan_bytes_per_probe_row, list_positions, plan_search_tiles,
                          pq_scan_bytes_per_probe_row, round_up, stream_ingest,
                          stream_probe)

__all__ = ["IndexParams", "SearchParams", "IvfPqIndex", "build", "extend", "search",
           "save", "load", "write_index", "read_index", "from_state",
           "resolve_scan_impl", "batched_searcher"]

_L2_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_SELECT_IMPLS = {"auto": "auto", "xla": "torch", "pallas": "kernel"}
_BLOCK_BYTES = 1 << 28   # temporaries of one step of the plain formulations
logger = logging.getLogger("raft_tpu_torch")


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
    # the largest stored id (-1 when empty), read once when the index is
    # made: extend returns a new index and nothing writes the lists in place
    max_stored_id: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.max_stored_id = int(self.list_ids.max()) if self.list_ids.numel() else -1
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
    sums = segment_sum(vals.reshape(-1, dim).to(torch.float32), flat, b * k)
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


def _resolve_pq_ingest(x, mt: DistanceType):
    """(data_kind, float32 working view) of a dataset (the JAX package's
    ``_resolve_pq_ingest``): int8 as it is, uint8 shifted by -128 into the
    signed domain (L2 is shift-invariant; queries shift the same way), and
    all PQ math in float32, where every 8-bit integer is exact."""
    if x.dtype not in (torch.int8, torch.uint8):
        return "float32", x.to(torch.float32)
    # uint8 under inner product is not shift-invariant, and the per-vector
    # correction is not stored
    expects(mt != DistanceType.InnerProduct or x.dtype == torch.int8,
            "uint8 + inner_product is unsupported for ivf_pq byte ingestion "
            "(the -128 shift changes inner products); cast to float32")
    return _dtype_name(x), _as_signed(x).to(torch.float32)


def _composed_codebooks(codebooks):
    """Split codebooks (B, 32, L) as the effective (B, 256, L) codebook:
    entry hi*16 + lo = cb1[hi] + cb2[lo]."""
    cb = codebooks.to(torch.float32)
    comp = cb[:, :16, None, :] + cb[:, None, 16:, :]
    return comp.reshape(cb.shape[0], 256, cb.shape[-1])


def _quant_error(v, c) -> float:
    """Σ over the rows of ``v`` (B, n, L) of the squared distance to their
    nearest row of ``c`` (B, K, L)."""
    rec = torch.gather(c, 1, _nearest(v, c)[..., None].expand(-1, -1, v.shape[-1]))
    return float((v - rec).square().sum(dtype=torch.float64))


def _per_cluster_gain(resid, labels, codebooks, split: bool, g, n_iters: int,
                      n_trial: int = 8, member_cap: int = 2048) -> float:
    """Per-cluster codebooks trained on the ``n_trial`` largest clusters:
    their quantization error over the per-subspace codebooks' on the same
    rows (< 1: per-cluster quantizes better). Split codebooks are compared
    composed, as search scores them (the JAX package's
    ``_per_cluster_gain``)."""
    n, pq_dim, pq_len = resid.shape
    cb_ps = _composed_codebooks(codebooks) if split else codebooks.to(torch.float32)
    lab_h = labels.cpu().numpy()
    counts = np.bincount(lab_h, minlength=1)
    trial = np.argsort(counts, kind="stable")[::-1][:n_trial]
    trial = trial[counts[trial] > 0]
    cap = min(member_cap, int(counts[trial].max()))
    pools = [np.nonzero(lab_h == c)[0] for c in trial]
    pools = np.stack([rows[np.arange(cap) % len(rows)] for rows in pools])
    rv = resid[torch.from_numpy(pools).to(resid.device)]     # (C, cap, pq_dim, L)
    # each subvector against its own subspace's codebook
    err_ps = _quant_error(rv.permute(2, 0, 1, 3).reshape(pq_dim, -1, pq_len), cb_ps)
    flat = rv.reshape(len(trial), cap * pq_dim, pq_len)
    if split:
        cb_pc = _composed_codebooks(_train_split_codebooks(flat, g, n_iters))
    else:
        cb_pc = _train_codebooks_batched(flat, g, cb_ps.shape[1], n_iters)
    return _quant_error(flat, cb_pc) / max(err_ps, 1e-30)


def _segment_sums(vals, labels, n_lists: int):
    """Per-list sums of ``vals`` (n,) and member counts, float32."""
    lab = labels.to(torch.int64)
    sums = segment_sum(vals.to(torch.float32), lab, n_lists)
    return sums, torch.bincount(lab, minlength=n_lists).to(torch.float32)


def _per_list_residual_scales(resid, labels, n_lists: int):
    """(n_lists,) RMS residual scale per list, sqrt(mean |r|² / d_rot) over
    its training members; lists the trainset missed take the global RMS."""
    n = resid.shape[0]
    rn2 = resid.reshape(n, -1).square().sum(dim=1)
    s, c = _segment_sums(rn2, labels, n_lists)
    gmean = rn2.sum() / max(n, 1)
    msq = torch.where(c > 0, s / torch.clamp_min(c, 1.0), gmean)
    return torch.sqrt(torch.clamp_min(msq / (resid.shape[1] * resid.shape[2]), 1e-24))


def _default_aniso_eta(d_rot: int, t: float = 0.2) -> float:
    """ScaNN's threshold rule (Guo et al., ICML'20 §3.2): parallel residual
    error weighs eta = (d - 1) T² / (1 - T²) at relative threshold T."""
    return max((d_rot - 1) * t * t / (1.0 - t * t), 1.0)


def _nearest_aniso(sv, norm, u, c, em1: float):
    """Codeword of least anisotropic loss |x - c|² + (eta - 1)·<u, x - c>²
    for every row of ``sv`` (B, n, L) (|x|² dropped), ties to the lowest."""
    b, n, _ = sv.shape
    k = c.shape[1]
    cn = (c * c).sum(dim=-1)[:, None, :]
    rows = max(1, _BLOCK_BYTES // (4 * b * k))
    out = []
    for i in range(0, n, rows):
        with full_f32():
            d2 = cn - 2.0 * torch.bmm(sv[:, i:i + rows], c.transpose(1, 2))
            upar = norm[:, i:i + rows, None] - torch.bmm(u[:, i:i + rows], c.transpose(1, 2))
        out.append(torch.argmin(d2 + em1 * upar * upar, dim=-1))
    return torch.cat(out, dim=1)


def _train_codebooks_aniso(subvecs, g, n_codes: int, n_iters: int, eta: float):
    """Anisotropic weighted EM (``codebook_loss="anisotropic"``) in the
    layout of :func:`_train_codebooks_batched`: assignment by
    :func:`_nearest_aniso`, the update solving each codeword's normal
    equations (count·I + (eta-1)·Σuuᵀ) c = eta·Σx."""
    sv = subvecs.to(torch.float32)
    b, n, dim = sv.shape
    em1 = eta - 1.0
    norm = torch.sqrt(torch.clamp_min((sv * sv).sum(dim=-1), 1e-30))
    u = sv / norm[..., None]
    uu = (u[..., :, None] * u[..., None, :]).reshape(b * n, dim * dim)
    if n >= n_codes:
        init = torch.rand((b, n), generator=g, device=sv.device).topk(n_codes, dim=1).indices
    else:
        init = torch.randint(0, n, (b, n_codes), generator=g, device=sv.device)
    c = torch.gather(sv, 1, init[..., None].expand(b, n_codes, dim))
    eye = torch.eye(dim, dtype=torch.float32, device=sv.device)
    offs = n_codes * torch.arange(b, device=sv.device)[:, None]
    for _ in range(n_iters):
        flat = (_nearest_aniso(sv, norm, u, c, em1) + offs).reshape(-1)
        counts = torch.bincount(flat, minlength=b * n_codes).to(torch.float32)
        sums = segment_sum(sv.reshape(-1, dim), flat, b * n_codes)
        suu = segment_sum(uu, flat, b * n_codes)
        a = (counts[:, None, None] * eye + em1 * suu.reshape(-1, dim, dim)) + 1e-6 * eye
        sol = torch.linalg.solve(a, (eta * sums)[..., None])[..., 0]
        c = torch.where(counts.reshape(b, n_codes, 1) > 0, sol.reshape(b, n_codes, dim), c)
    return c


def _train_opq_rotation(resid_flat, g, pq_dim: int, n_codes: int, n_iters: int,
                        rounds: int, batch: int):
    """OPQ rotation (Ge et al., CVPR'13, Alg. 1) on rotating mini-batches:
    fit per-subspace codebooks on the rotated batch, then solve orthogonal
    Procrustes over its reconstructions (R = U Vᵀ from the SVD of YᵀX).
    Returns the (d_rot, d_rot) rotation to fold into the index's."""
    n, d_rot = resid_flat.shape
    pq_len = d_rot // pq_dim
    dev = resid_flat.device
    perm = resid_flat.to(torch.float32)[torch.randperm(n, generator=g, device=dev)]
    rot = torch.eye(d_rot, dtype=torch.float32, device=dev)
    for i in range(rounds):
        start = (i * batch) % max(n - batch + 1, 1)
        xb = perm[start:start + batch]
        with full_f32():
            xr = xb @ rot.T
        sub = xr.reshape(-1, pq_dim, pq_len).transpose(0, 1).contiguous()
        cb = _train_codebooks_batched(sub, g, n_codes, n_iters)
        recon = torch.gather(cb, 1, _nearest(sub, cb)[..., None].expand(-1, -1, pq_len))
        y = recon.transpose(0, 1).reshape(-1, d_rot)
        with full_f32():
            u, _, vt = torch.linalg.svd(y.T @ xb, full_matrices=True)
            rot = u @ vt
    return rot


def _sig_words(d_rot: int, fast_scan: str) -> int:
    """Packed signature bytes a row for a fast-scan mode."""
    if fast_scan == "1bit":
        return -(-d_rot // 8)
    if fast_scan == "4bit":
        return -(-d_rot // 2)
    return 0


def _per_list_sig_scales(resid_flat, labels, n_lists: int, fast_scan: str):
    """(n_lists,) decode scale per list for the signature estimator, from
    the raw rotated residuals: mean |r_j| (1bit) or sqrt(mean r_j²) (4bit);
    lists the trainset missed take the global mean."""
    n, d_rot = resid_flat.shape
    red = (resid_flat.abs().sum(dim=1) if fast_scan == "1bit"
           else resid_flat.square().sum(dim=1))
    s, c = _segment_sums(red, labels, n_lists)
    gmean = red.sum() / max(n, 1)
    per_dim = torch.clamp_min(torch.where(c > 0, s / torch.clamp_min(c, 1.0), gmean) / d_rot,
                              1e-24)
    return per_dim if fast_scan == "1bit" else torch.sqrt(per_dim)


def _encode_sig(resid_flat, scales, fast_scan: str):
    """Bit-packed signatures (n, sig_words) uint8 of raw rotated residuals
    with per-row decode ``scales`` (n,). 1bit: sign bits, dim 8w+b in bit b
    of byte w. 4bit: levels round((r/s)/step + 7.5) clipped to [0, 15], the
    even dim in the low nibble. Padding dims pack as zero bits. The bit
    order is the file format's."""
    n, d_rot = resid_flat.shape
    r = resid_flat.to(torch.float32)
    if fast_scan == "1bit":
        w = -(-d_rot // 8)
        bits = torch.nn.functional.pad((r > 0).to(torch.int32), (0, w * 8 - d_rot))
        weights = 1 << torch.arange(8, dtype=torch.int32, device=r.device)
        return (bits.reshape(n, w, 8) * weights).sum(dim=-1).to(torch.uint8)
    w = -(-d_rot // 2)
    step = 4.0 / 15.0
    lev = torch.clamp(torch.round(r / (scales[:, None] * step) + 7.5), 0, 15)
    lev = torch.nn.functional.pad(lev, (0, w * 2 - d_rot)).to(torch.uint8)
    return lev[:, 0::2] | (lev[:, 1::2] << 4)


def _sig_nibble_lut(r, fast_scan: str, sig_words: int):
    """Per-(query, probe) nibble LUT of the signature scan: raw rotated
    residuals r (..., d_rot) -> (..., sig_words, 32), [..., :16] scoring
    the high nibble of each packed byte and [..., 16:] the low one (the
    split pq8 layout the scan takes): the scan sums <r, σ> (1bit, σ = ±1)
    or <r, level> (4bit); padding dims contribute 0."""
    d_rot = r.shape[-1]
    if fast_scan == "1bit":
        rp = torch.nn.functional.pad(r, (0, sig_words * 8 - d_rot))
        r8 = rp.reshape(*r.shape[:-1], sig_words, 8)
        v = torch.arange(16, device=r.device)
        b = torch.arange(4, device=r.device)
        pm = (2 * ((v[:, None] >> b[None, :]) & 1) - 1).to(torch.float32)
        with full_f32():
            lut_lo = torch.einsum("...wb,vb->...wv", r8[..., 0:4], pm)
            lut_hi = torch.einsum("...wb,vb->...wv", r8[..., 4:8], pm)
        return torch.cat([lut_hi, lut_lo], dim=-1)
    rp = torch.nn.functional.pad(r, (0, sig_words * 2 - d_rot))
    r2 = rp.reshape(*r.shape[:-1], sig_words, 2)
    levels = (torch.arange(16, dtype=torch.float32, device=r.device) - 7.5) * (4.0 / 15.0)
    return torch.cat([r2[..., 1:2] * levels, r2[..., 0:1] * levels], dim=-1)


def _pq_cross_consts(codes, codebooks, labels, per_cluster: bool):
    """Per-vector scan constant of split L2 scoring,
    Σ_s 2·cb1[s, hi_s]·cb2[s, lo_s] (per-cluster: from the vector's list's
    codebook): the cross term of |cb1 + cb2|² that the separate hi / lo LUT
    halves cannot carry, paid once at encode time."""
    cb = codebooks.to(torch.float32)
    with full_f32():
        x = 2.0 * torch.einsum("bhl,bgl->bhg", cb[:, :16], cb[:, 16:])
    xf = x.reshape(-1)           # flat b*256 + hi*16 + lo = b*256 + code
    out = [torch.zeros((0,), dtype=torch.float32, device=codes.device)]
    for i in range(0, codes.shape[0], 65536):
        c = codes[i:i + 65536].to(torch.int64)
        offs = (labels[i:i + 65536].to(torch.int64)[:, None] if per_cluster
                else torch.arange(codes.shape[1], device=codes.device)) * 256
        out.append(xf[c + offs].sum(dim=1))
    return torch.cat(out)


def _encode(residuals, codebooks, labels, per_cluster: bool, tile: int,
            aniso_eta: float = 0.0):
    """Nearest codebook entry per subspace: residuals (n, pq_dim, pq_len),
    codebooks (pq_dim, K, pq_len), or (n_lists, K, pq_len) taken by
    ``labels`` when ``per_cluster``, -> (n, pq_dim) uint8, by argmin of
    ``|c|² - 2·r·c`` over row tiles; ``aniso_eta > 0`` adds the anisotropic
    surcharge (eta - 1)·(|r| - <u, c>)², u = r/|r|."""
    cb = codebooks.to(torch.float32)
    cn = (cb * cb).sum(dim=-1)
    out = [torch.zeros((0, residuals.shape[1]), dtype=torch.uint8, device=cb.device)]
    for i in range(0, residuals.shape[0], tile):
        rb = residuals[i:i + tile]
        eq = "tsl,skl->tsk"
        cbl, cnl = cb, cn[None]
        if per_cluster:
            lb = labels[i:i + tile].to(torch.int64)
            eq, cbl, cnl = "tsl,tkl->tsk", cb[lb], cn[lb][:, None, :]
        with full_f32():
            d2 = cnl - 2.0 * torch.einsum(eq, rb, cbl)
        if aniso_eta > 0.0:
            nrm = torch.sqrt(torch.clamp_min((rb * rb).sum(dim=-1), 1e-30))
            with full_f32():
                ucb = torch.einsum(eq, rb / nrm[..., None], cbl)
            d2 = d2 + (aniso_eta - 1.0) * (nrm[..., None] - ucb) ** 2
        out.append(torch.argmin(d2, dim=-1).to(torch.uint8))
    return torch.cat(out)


@instrument("ivf_pq.build",
            items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["dataset"]),
            labels=lambda a, kw: {
                "dtype": dtype_of(a[1] if len(a) > 1 else kw["dataset"]),
                "n_lists": (a[0] if a else kw["params"]).n_lists,
            })
def build(params: IndexParams, dataset, res: Resources | None = None) -> IvfPqIndex:
    """Build the index (reference: ivf_pq::build, ivf_pq-inl.cuh:270) on the
    handle's device. int8 / uint8 datasets are ingested as float32 in the
    signed domain (:func:`_resolve_pq_ingest`)."""
    res = res or default_resources()
    stream = is_reader(dataset)
    x = None if stream else res.put(dataset)
    src = dataset if stream else x
    expects(src.ndim == 2, "dataset must be (n, d)")
    n, d = (int(s) for s in src.shape)
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
    if stream:
        # dtype-only ingest resolution, then the streamed admission: the
        # chunked build's peak against both budgets, before the coarse
        # trainer spends anything
        data_kind, _ = _resolve_pq_ingest(stream_probe(dataset.dtype, d), mt)
        plan_kw = dict(dtype=data_kind if data_kind in ("int8", "uint8") else "float32",
                       streamed=True, chunk_rows=dataset.chunk_rows)
        obs_mem.gate(
            res, lambda: obs_mem.plan("ivf_pq", params, n, d, **plan_kw)["build_peak_bytes"],
            site="build_stream", detail=f"ivf_pq {n}x{d} ooc",
            host_bytes=lambda: obs_mem.plan("ivf_pq", params, n, d,
                                            **plan_kw)["host_peak_bytes"])
        # the trainer and the trainset gather see the reader through the
        # build's working-domain conversion
        x = chunked.converted(dataset, stream_ingest(data_kind, torch.float32),
                              res.torch_device)
    else:
        data_kind, x = _resolve_pq_ingest(x, mt)
        # memory-budget admission, before the coarse trainer spends anything
        obs_mem.gate(res, lambda: obs_mem.plan("ivf_pq", params, n, d)["index_bytes"],
                     site="build", detail=f"ivf_pq {n}x{d}")
    dev = res.torch_device
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
    if n_train < n:
        # a device gather in-core, a host gather off the reader streamed:
        # the same indices, the same rows
        xt = chunked.take_rows(x, torch.randperm(n, generator=g, device=dev)[:n_train])
    else:
        xt = chunked.materialize(x)
    tile = _choose_tile(n_train, params.n_lists, 1, res.workspace_bytes)
    labels = assign_to_lists(xt, centers, mt, tile)
    lab = labels.to(torch.int64)
    with full_f32():
        resid = (xt - centers[lab]) @ rotation.T
    del xt
    resid = resid.reshape(n_train, pq_dim, pq_len)
    list_scales = torch.zeros((0,), dtype=torch.float32, device=dev)
    if params.residual_scale_norm:
        # codebooks train on unit-scale residuals; encode and search apply
        # each list's scale
        list_scales = _per_list_residual_scales(resid, labels, params.n_lists)
        resid = resid / list_scales[lab][:, None, None]

    split_pref = (params.pq8_split if params.pq8_split is not None
                  else mt != DistanceType.InnerProduct)
    split = params.pq_bits == 8 and bool(split_pref)
    # 3b. a learned rotation, folded into the index's (orthogonal, so the
    # list scales stay valid)
    if params.rotation == "opq":
        r_opq = _train_opq_rotation(resid.reshape(n_train, d_rot), g, pq_dim,
                                    16 if split else n_codes,
                                    min(params.kmeans_n_iters, 10), int(params.opq_rounds),
                                    min(int(params.opq_batch_rows), n_train))
        with full_f32():
            rotation = r_opq @ rotation
            centers_rot = centers @ rotation.T
            resid = (resid.reshape(n_train, d_rot) @ r_opq.T).reshape(n_train, pq_dim, pq_len)

    # 4. codebooks (ref train_per_subset :343 / train_per_cluster :424)
    aniso_eta = 0.0
    if params.codebook_loss == "anisotropic":
        expects(not split, "codebook_loss='anisotropic' needs a joint codebook — "
                "nibble-split pq8 trains a two-stage residual quantizer (set "
                "pq8_split=False or pq_bits < 8)")
        aniso_eta = float(params.anisotropic_eta or _default_aniso_eta(d_rot))

    def train(pools):
        if split:
            return _train_split_codebooks(pools, g, params.kmeans_n_iters)
        if aniso_eta > 0.0:
            return _train_codebooks_aniso(pools, g, n_codes, params.kmeans_n_iters, aniso_eta)
        return _train_codebooks_batched(pools, g, n_codes, params.kmeans_n_iters)

    kind = params.codebook_kind
    if kind != "per_cluster":
        codebooks = train(resid.transpose(0, 1).contiguous())
        # "auto" trial-trains per-cluster codebooks on the largest clusters
        # and takes them where they quantize markedly better
        if kind == "auto":
            if params.n_lists >= 16 and n_train >= 4 * params.n_lists:
                ratio = _per_cluster_gain(resid, labels, codebooks, split, g,
                                          min(params.kmeans_n_iters, 10))
                if ratio < 0.9:
                    logger.info("ivf_pq auto codebooks: per-cluster trial error is %.2fx "
                                "per-subspace — training per-cluster codebooks", ratio)
                    kind = "per_cluster"
                else:
                    logger.info("ivf_pq auto codebooks: per-cluster trial gains little "
                                "(%.2fx) — keeping per-subspace codebooks", ratio)
            if kind == "auto":
                kind = "per_subspace"
    if kind == "per_cluster":
        # each cluster's members' subvectors, padded by wraparound to one size
        counts = torch.bincount(lab, minlength=params.n_lists)
        pool_cap = round_up(max(int(counts.max()), n_codes), 8)
        starts = torch.cumsum(counts, 0) - counts
        offs = (torch.arange(pool_cap, device=dev)[None, :]
                % torch.clamp_min(counts, 1)[:, None])
        rows = torch.argsort(lab, stable=True)[(starts[:, None] + offs).clamp_max(n_train - 1)]
        codebooks = train(resid.reshape(n_train, d_rot)[rows].reshape(
            params.n_lists, pool_cap * pq_dim, pq_len))

    # 5. the fast-scan tier's decode scales, from the raw rotated residuals
    sig_scales = torch.zeros((0,), dtype=torch.float32, device=dev)
    if params.fast_scan != "none":
        raw = resid.reshape(n_train, d_rot)
        if params.residual_scale_norm:
            raw = raw * list_scales[lab][:, None]
        sig_scales = _per_list_sig_scales(raw, labels, params.n_lists, params.fast_scan)
    del resid

    index = IvfPqIndex(
        centers=centers, centers_rot=centers_rot, rotation=rotation,
        codebooks=codebooks,
        list_codes=torch.zeros((params.n_lists, 0, pq_dim), dtype=torch.uint8, device=dev),
        list_ids=torch.zeros((params.n_lists, 0), dtype=torch.int32, device=dev),
        list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        list_scales=list_scales,
        list_sig=torch.zeros((params.n_lists, 0, _sig_words(d_rot, params.fast_scan)),
                             dtype=torch.uint8, device=dev),
        sig_scales=sig_scales, metric=mt, codebook_kind=kind, pq_bits=params.pq_bits,
        split_factor=params.split_factor, pq_split=split, data_kind=data_kind,
        rotation_kind=params.rotation, codebook_loss=params.codebook_loss,
        fast_scan=params.fast_scan)
    if not params.add_data_on_build:
        return index
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    if stream:
        return _extend_rows(index, dataset, ids, res=res,
                            ingest=stream_ingest(data_kind, torch.float32), priced=True)
    return _extend_rows(index, x, ids, res=res, priced=True)


@instrument("ivf_pq.extend",
            items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["new_vectors"]))
def extend(index: IvfPqIndex, new_vectors, new_ids=None, res: Resources | None = None,
           split_factor: float | None = None) -> IvfPqIndex:
    """Encode and append vectors (reference: ivf_pq::extend). Returns a new
    index on the index's device; ids default to ``index.size + arange``. A
    byte index takes vectors of its original dtype only.

    A chunked reader, or a host ndarray past ivf_flat's
    ``chunked.STREAM_EXTEND_BYTES``, streams: assign, encode and fill run over
    staged chunks, with the result of the in-core extend."""
    new_vectors = chunked.maybe_reader(new_vectors)
    if is_reader(new_vectors):
        if index.data_kind in ("int8", "uint8"):
            expects(str(np.dtype(new_vectors.dtype)) == index.data_kind,
                    "this index stores %s vectors; got %s", index.data_kind,
                    new_vectors.dtype)
        return _extend_rows(index, new_vectors, new_ids, res=res, split_factor=split_factor,
                            ingest=stream_ingest(index.data_kind, torch.float32))
    x = torch.as_tensor(new_vectors)
    if index.data_kind in ("int8", "uint8"):
        expects(_dtype_name(x) == index.data_kind, "this index stores %s vectors; got %s",
                index.data_kind, _dtype_name(x))
        x = _as_signed(x)
    return _extend_rows(index, x.to(device=index.device, dtype=torch.float32), new_ids,
                        res=res, split_factor=split_factor)


def _fill_code_rows(bufs, offsets, codes, ids, labels, consts=None, sig=None):
    """Scatter one tile's codes, ids (and split L2 constants, and fast-scan
    signatures) into the padded lists at each list's running fill level
    (``offsets``, updated in place), so tiles scattered in order give the
    layout one scatter of all rows gives."""
    buf, idbuf, cbuf, sbuf = bufs
    pos, counts = list_positions(labels, offsets.shape[0])
    lab = labels.to(torch.int64)
    pos = pos.to(torch.int64) + offsets[lab].to(torch.int64)
    buf[lab, pos] = codes
    idbuf[lab, pos] = ids.to(torch.int32)
    if consts is not None:
        cbuf[lab, pos] = consts
    if sig is not None:
        sbuf[lab, pos] = sig
    offsets += counts


def _extend_rows(index: IvfPqIndex, src, new_ids=None, res: Resources | None = None,
                 split_factor: float | None = None, ingest=None,
                 priced: bool = False) -> IvfPqIndex:
    """extend() over float32 rows in the index's working domain: a tensor on
    its device, or a chunked reader whose staged chunks ``ingest``
    converts.

    Two passes over :func:`~raft_tpu_torch.core.chunked.row_tiles`: assign,
    then the residual, encode and fill of each tile against the per-list
    arrays repeated over the split lists (bitwise the parent's values), the
    same code in both modes, so a streamed extend equals the in-core one
    bit for bit. ``priced`` (a build's fill, which ``obs.mem.plan()``
    prices) splits oversized lists at ``_list_utils.priced_capacity``."""
    res = res or default_resources()
    _check_split_consts(index)
    stream = is_reader(src)
    expects(src.ndim == 2 and int(src.shape[1]) == index.dim, "vector dim mismatch")
    dev = index.device
    n_new, d = (int(s) for s in src.shape)
    if new_ids is None:
        new_ids = index.size + torch.arange(n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
        expects(new_ids.shape == (n_new,), "ids/vectors length mismatch")
    per_cluster = index.codebook_kind == "per_cluster"
    want_consts = index.pq_split and index.metric != DistanceType.InnerProduct
    stager = (chunked.ChunkStager(src.chunk_rows, d, src.dtype, kind="ivf_pq", device=dev)
              if stream else None)
    try:
        tile = fill_tile(n_new, index.n_lists, res.workspace_bytes)
        labels = torch.cat([assign_to_lists(t, index.centers, index.metric, tile)
                            for _, t in chunked.row_tiles(src, tile, stager=stager,
                                                          ingest=ingest, kind="ivf_pq",
                                                          stage="assign")])
        n_old = 0
        if index.capacity > 0 and index.size > 0:
            old = index.list_ids.reshape(-1) >= 0
            n_old = int(old.sum())
            labels = torch.cat([torch.arange(index.n_lists, dtype=torch.int32, device=dev
                                             ).repeat_interleave(index.capacity)[old], labels])

        # the capacity policy: oversized lists split into sub-lists that
        # share their parent's center, rotated center, per-cluster codebook,
        # residual scale and signature scale, so the codes stay valid
        sf = index.split_factor if split_factor is None else split_factor
        labels, rep, n_lists, capacity, _ = bound_capacity(labels, index.n_lists, sf,
                                                           priced=priced)
        per_list = {"centers": index.centers, "centers_rot": index.centers_rot}
        if per_cluster:
            per_list["codebooks"] = index.codebooks
        if index.scale_normed:
            per_list["list_scales"] = index.list_scales
        if index.has_fast_scan:
            per_list["sig_scales"] = index.sig_scales
        if rep is not None:
            reps = torch.from_numpy(rep).to(dev)
            per_list = {k: a.repeat_interleave(reps, dim=0) for k, a in per_list.items()}
        centers = per_list["centers"]
        codebooks = per_list.get("codebooks", index.codebooks)
        list_scales = per_list.get("list_scales", index.list_scales)
        sig_scales = per_list.get("sig_scales", index.sig_scales)

        sig_w = index.list_sig.shape[2] if index.has_fast_scan else 0
        bufs = (torch.zeros((n_lists, capacity, index.pq_dim), dtype=torch.uint8, device=dev),
                torch.full((n_lists, capacity), -1, dtype=torch.int32, device=dev),
                torch.zeros((n_lists, capacity if want_consts else 0), dtype=torch.float32,
                            device=dev),
                (torch.zeros((n_lists, capacity, sig_w), dtype=torch.uint8, device=dev)
                 if index.has_fast_scan
                 else torch.zeros((n_lists, 0, 0), dtype=torch.uint8, device=dev)))
        offsets = torch.zeros((n_lists,), dtype=torch.int32, device=dev)
        # the streamed build's device working set, which
        # obs.mem.plan(streamed=True) prices
        tok = (obs_mem.account("build/ooc", name="ivf_pq",
                               device=[*bufs, offsets, labels, new_ids], owner=stager)
               if stream else None)
        if n_old:
            old_sig = (index.list_sig.reshape(-1, sig_w)[old] if index.has_fast_scan
                       else None)
            _fill_code_rows(bufs, offsets, index.list_codes.reshape(-1, index.pq_dim)[old],
                            index.list_ids.reshape(-1)[old], labels[:n_old],
                            index.list_consts.reshape(-1)[old] if want_consts else None,
                            old_sig)

        # split indexes encode against the composed 256-entry codebook,
        # whose flat index is hi*16 + lo
        enc_cb = _composed_codebooks(codebooks) if index.pq_split else codebooks
        n_codes = enc_cb.shape[-2]
        enc_tile = min(max(min(n_new, res.workspace_bytes
                               // max(index.pq_dim * n_codes * 4, 1)), 8), 8192)
        aniso_eta = (_default_aniso_eta(index.rot_dim)
                     if index.codebook_loss == "anisotropic" else 0.0)
        for start, t in chunked.row_tiles(src, tile, stager=stager, ingest=ingest,
                                          kind="ivf_pq", stage="fill"):
            end = start + t.shape[0]
            lab_t = labels[n_old + start:n_old + end]
            lab = lab_t.to(torch.int64)
            with full_f32():
                resid = (t - centers[lab]) @ index.rotation.T
            # signatures pack the raw rotated residual
            sig = (_encode_sig(resid, sig_scales[lab], index.fast_scan)
                   if index.has_fast_scan else None)
            resid = resid.reshape(-1, index.pq_dim, index.pq_len)
            if index.scale_normed:
                resid = resid / list_scales[lab][:, None, None]
            codes = _encode(resid, enc_cb, lab_t, per_cluster, enc_tile, aniso_eta)
            consts = None
            if want_consts:
                consts = _pq_cross_consts(codes, codebooks, lab_t, per_cluster)
                if index.scale_normed:
                    # the stored cross term enters the score raw: s² folds in
                    consts = consts * list_scales[lab] ** 2
            _fill_code_rows(bufs, offsets, codes, new_ids[start:end], lab_t, consts, sig)
        obs_mem.release(tok)
    finally:
        if stager is not None:
            stager.release()
    buf, idbuf, cbuf, sbuf = bufs
    return dataclasses.replace(index, list_codes=buf, list_ids=idbuf, list_sizes=offsets,
                               list_consts=cbuf, list_sig=sbuf, split_factor=sf, **per_list)


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
    (ref ivfpq_search_worker :419; the JAX package's order, ivf_pq.py
    :1660-1703): for L2, ``|c|² - 2·r·c`` over the rotated residual
    r = q_rot - c_rot and the bias Σ_s |r_s|²; for inner product,
    ``q_rot·c`` and the bias q_rot·c_rot. Per-cluster codebooks are the
    probed list's; with per-list residual scales s, r is divided by s
    before the products, the bias stays raw, and the LUT is multiplied by
    s² (L2) or s (inner product)."""
    t, p = pc.shape
    pq_dim, pq_len = index.pq_dim, index.pq_len
    crot = index.centers_rot[pc]                          # (T, pc, d_rot)
    sc = index.list_scales[pc] if index.scale_normed else None
    per_cluster = index.codebook_kind == "per_cluster"
    eq = "tpsl,tpkl->tpsk" if per_cluster else "tpsl,skl->tpsk"
    cbl = cb[pc] if per_cluster else cb
    with full_f32():
        if index.metric == DistanceType.InnerProduct:
            qs = qrot.reshape(t, 1, pq_dim, pq_len).expand(t, p, pq_dim, pq_len)
            lut = torch.einsum(eq, qs, cbl)
            if sc is not None:
                lut = lut * sc[:, :, None, None]
            return lut, torch.einsum("td,tpd->tp", qrot, crot)
        r = (qrot[:, None, :] - crot).reshape(t, p, pq_dim, pq_len)
        bias = (r * r).sum(dim=(2, 3))
        if sc is not None:
            r = r / sc[:, :, None, None]
        cnl = cb_n2[pc][:, :, None, :] if per_cluster else cb_n2[None, None]
        lut = cnl - 2.0 * torch.einsum(eq, r, cbl)
        if sc is not None:
            lut = lut * (sc * sc)[:, :, None, None]
        return lut, bias


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


def _finish(index: IvfPqIndex, dists, idx, empty=None):
    """The square root of an L2Sqrt index's distances, and id -1 wherever
    ``empty(dists)`` holds: ``torch.isinf`` after a filtered tiled search,
    not finite after the grouped order (the JAX package's two tails)."""
    if index.metric in _SQRT_METRICS:
        dists = torch.where(torch.isfinite(dists),
                            torch.sqrt(torch.clamp_min(dists, 0.0)), dists)
    if empty is not None:
        idx = torch.where(empty(dists), -1, idx)
    return dists, idx


def _tiled(index: IvfPqIndex, queries, n_probes: int, k: int, query_tile: int,
           probe_chunk: int, select_impl: str, keep_mask, chunk_step):
    """The tile and chunk loop shared by the tiled search and the funnel: the
    coarse probes and the rotated queries, then per tile of ``query_tile``
    queries ``chunk_step(qrot_tile, probes_chunk) -> (values, ids)`` over
    chunks of ``probe_chunk`` probes; a tile of one chunk keeps that
    chunk's k, a tile of several merges them."""
    inner = index.metric == DistanceType.InnerProduct
    qf = queries.to(torch.float32)
    probes = _coarse_probes(index, qf, n_probes)
    with full_f32():
        qrot = qf @ index.rotation.T
    dists, idx = [], []
    for t0 in range(0, qf.shape[0], query_tile):
        q = qrot[t0:t0 + query_tile]
        pr = probes[t0:t0 + query_tile].to(torch.int64)
        parts = [chunk_step(q, pr[:, c0:c0 + probe_chunk])
                 for c0 in range(0, n_probes, probe_chunk)]
        v, i = parts[0]
        if len(parts) > 1:
            v, i = select_k_impl(torch.cat([p[0] for p in parts], dim=1),
                                 torch.cat([p[1] for p in parts], dim=1), k, not inner,
                                 impl=select_impl)
        dists.append(v)
        idx.append(i)
    return _finish(index, torch.cat(dists), torch.cat(idx),
                   torch.isinf if keep_mask is not None else None)


def _pq_search(index: IvfPqIndex, queries, n_probes: int, k: int, query_tile: int,
               probe_chunk: int, lut_dtype: str, scan_impl: str,
               select_impl: str = "auto", keep_mask=None, keep_words=None):
    """The tiled search (the JAX package's ``_pq_search``). A chunk step
    either runs ``pq_scan_topk`` (:func:`_fuses_scan_and_select`, with the
    filter as its packed bitset: ``keep_words`` when the caller packed it,
    else packed here) or scans, adds the bias (and split L2's constants),
    masks empty and filtered slots and selects."""
    from ..ops.pq_scan import pack_keep_words, pq_scan_topk

    inner = index.metric == DistanceType.InnerProduct
    cb, cb_n2 = _codebooks_f32(index)
    bad = -math.inf if inner else math.inf
    consts = index.list_consts if index.pq_split and not inner else None
    fused = _fuses_scan_and_select(index, scan_impl, select_impl, probe_chunk, k, lut_dtype)
    if not fused or keep_mask is None:
        keep_words = None
    elif keep_words is None:
        keep_words = pack_keep_words(keep_mask)

    def chunk_step(q, pc):
        lut, bias = _probe_luts(index, q, pc, cb, cb_n2)
        if fused:
            return pq_scan_topk(index.list_codes, index.list_ids, pc.to(torch.int32).contiguous(),
                                lut.to(_lut_type(lut_dtype)).contiguous(), bias.contiguous(), k,
                                not inner, split=index.pq_split, list_consts=consts,
                                keep_words=keep_words)
        scores = _scan(index, pc, lut, scan_impl, lut_dtype) + bias[:, :, None]
        if consts is not None:
            scores = scores + consts[pc]
        ids = index.list_ids[pc]                          # (T, pc, cap)
        scores = torch.where(ids >= 0, scores, bad)
        if keep_mask is not None:
            scores = apply_id_filter(scores, ids, keep_mask, not inner)
        t = q.shape[0]
        return select_k_impl(scores.reshape(t, -1), ids.reshape(t, -1), k, not inner,
                             impl=select_impl)

    return _tiled(index, queries, n_probes, k, query_tile, probe_chunk, select_impl, keep_mask,
                  chunk_step)


def _decode(index: IvfPqIndex, codes, lists, cb):
    """Codewords (..., pq_dim, pq_len) of ``codes`` (..., pq_dim) stored in
    ``lists`` (...): cb[s, code] (split: cb1[hi] + cb2[lo]); per-cluster
    codebooks are the list's."""
    c = codes.to(torch.int64)
    if index.codebook_kind == "per_cluster":
        cbl = cb[lists.to(torch.int64)]                     # (..., K, L)

        def take(col):
            return torch.gather(cbl, -2, col[..., None].expand(*col.shape, cbl.shape[-1]))
    else:
        s = torch.arange(index.pq_dim, device=c.device)

        def take(col):
            return cb[s, col]
    if index.pq_split:
        return take(c >> 4) + take(16 + (c & 15))
    return take(c)


def _pq_search_funnel(index: IvfPqIndex, queries, n_probes: int, k: int, k_widen: int,
                      query_tile: int, probe_chunk: int, lut_dtype: str,
                      select_impl: str = "auto", keep_mask=None):
    """The quantization funnel (the JAX package's ``_pq_search_funnel``):
    per chunk, the signature estimator over every probed slot (the
    ``pq_scan`` kernel over ``list_sig`` with the nibble LUT of
    :func:`_sig_nibble_lut`), the best ``k_widen`` flat positions, those
    survivors re-scored exactly against their decoded PQ codes, and the k
    best kept; the chunks merge as in :func:`_pq_search`. Estimator-filtered
    survivors keep their ±inf score."""
    from ..ops.pq_scan import pq_scan

    inner = index.metric == DistanceType.InnerProduct
    d_rot, cap = index.rot_dim, index.capacity
    sig_w = index.list_sig.shape[2]
    cb = index.codebooks.to(torch.float32)
    bad = -math.inf if inner else math.inf

    def chunk_step(q, pc):
        t, p = pc.shape
        crot = index.centers_rot[pc]
        ids = index.list_ids[pc]
        ss = index.sig_scales[pc]
        # stage A, in the raw residual domain the signature scales were fit
        # in: L2 est = |r|² + s²·d_rot - 2·s·raw, IP est = q·c + s·raw
        r = q[:, None, :].expand(t, p, d_rot) if inner else q[:, None, :] - crot
        slut = _sig_nibble_lut(r, index.fast_scan, sig_w)
        raw = pq_scan(index.list_sig, pc.reshape(-1).to(torch.int32).contiguous(),
                      slut.reshape(t * p, sig_w, 32).to(_lut_type(lut_dtype)).contiguous(),
                      split=True).reshape(t, p, cap)
        with full_f32():
            if inner:
                est = torch.einsum("td,tpd->tp", q, crot)[:, :, None] + ss[:, :, None] * raw
            else:
                est = (((r * r).sum(dim=-1) + ss * ss * d_rot)[:, :, None]
                       - 2.0 * ss[:, :, None] * raw)
        est = torch.where(ids >= 0, est, bad)
        if keep_mask is not None:
            est = apply_id_filter(est, ids, keep_mask, not inner)
        est_sel, pos_sel = select_k_impl(est.reshape(t, -1), None, k_widen, not inner,
                                         impl=select_impl)
        pos_sel = pos_sel.to(torch.int64)
        list_sel = torch.gather(pc, 1, pos_sel // cap)      # (T, kw)
        slot_sel = pos_sel % cap
        # stage B: the survivors' exact PQ scores by direct decode
        dec = _decode(index, index.list_codes[list_sel, slot_sel], list_sel[..., None],
                      cb).reshape(t, -1, d_rot)
        if index.scale_normed:
            dec = dec * index.list_scales[list_sel][..., None]
        crot_sel = index.centers_rot[list_sel]
        with full_f32():
            if inner:
                score = torch.einsum("td,twd->tw", q, crot_sel + dec)
            else:
                score = (q[:, None, :] - crot_sel - dec).square().sum(dim=-1)
        score = torch.where(torch.isfinite(est_sel), score, est_sel)
        return select_k_impl(score, index.list_ids[list_sel, slot_sel], k, not inner,
                             impl=select_impl)

    return _tiled(index, queries, n_probes, k, query_tile, probe_chunk, select_impl, keep_mask,
                  chunk_step)


def _pq_search_grouped(index: IvfPqIndex, queries, n_probes: int, k: int, lut_dtype: str,
                       group_size: int = 16, group_chunk: int = 32,
                       select_impl: str = "auto", keep_mask=None):
    """The probe-major order (the JAX package's ``_pq_search_grouped``): the
    batch's (query, probe) pairs sorted by list (stably, so each list's
    pairs keep their order) and cut into groups of ``group_size`` pairs of
    one list; a group scores the list's one-hot codes against all its
    pairs' LUTs in one product and selects k per pair. The pairs' answers
    go back to their queries in probe order and merge there, so ties fall
    as in the tiled order. Slots are laid out as in the JAX package, which
    pads them to a static bound; here only to the groups the batch has."""
    m = queries.shape[0]
    qf = queries.to(torch.float32)
    inner = index.metric == DistanceType.InnerProduct
    n_lists, cap, pq_dim = index.n_lists, index.capacity, index.pq_dim
    n_codes = index.codebooks.shape[-2]
    g_sz, dev = group_size, qf.device
    probes = _coarse_probes(index, qf, n_probes)
    with full_f32():
        qrot = qf @ index.rotation.T
    cb, cb_n2 = _codebooks_f32(index)
    bad = -math.inf if inner else math.inf

    # pair grouping: sorted pair j sits at slot slot_sorted[j] of its list's
    # padded run
    mp = m * n_probes
    pairs = probes.reshape(-1).to(torch.int64)
    order = torch.argsort(pairs, stable=True)
    sorted_list = pairs[order]
    counts = torch.bincount(pairs, minlength=n_lists)
    padded = -(-counts // g_sz) * g_sz
    pstart = torch.cumsum(padded, 0) - padded
    starts = torch.cumsum(counts, 0) - counts
    slot_sorted = pstart[sorted_list] + torch.arange(mp, device=dev) - starts[sorted_list]
    n_groups = int(padded.sum()) // g_sz
    n_slots = -(-n_groups // group_chunk) * group_chunk * g_sz
    all_slots = torch.arange(n_slots, device=dev)
    j_of_slot = torch.searchsorted(slot_sorted, all_slots)
    jc = j_of_slot.clamp_max(mp - 1)
    slot_live = (j_of_slot < mp) & (slot_sorted[jc] == all_slots)
    l_of_slot = torch.searchsorted(pstart + padded, all_slots, right=True).clamp_max(n_lists - 1)
    q_of_slot = torch.where(slot_live, order[jc] // n_probes, 0)

    ar = torch.arange(16 if index.pq_split else n_codes, device=dev).to(torch.uint8)
    consts = index.list_consts if index.pq_split and not inner else None
    per = group_chunk * g_sz
    slot_v, slot_i = [], []
    for s0 in range(0, n_slots, per):
        qs, ls = q_of_slot[s0:s0 + per], l_of_slot[s0:s0 + per]
        lg = ls.reshape(group_chunk, g_sz)[:, 0]
        lut, bias = _probe_luts(index, qrot[qs], ls[:, None], cb, cb_n2)
        lutf = lut.reshape(group_chunk, g_sz, pq_dim * lut.shape[-1]).to(torch.float32)
        codes = index.list_codes[lg][..., None]           # (Gc, cap, pq_dim, 1)
        oh = (torch.cat([(codes >> 4) == ar, (codes & 15) == ar], dim=-1) if index.pq_split
              else codes == ar).reshape(group_chunk, cap, -1).to(torch.float32)
        scale = None
        if lut_dtype == "int8":
            scale = torch.clamp_min(lutf.abs().amax(dim=2, keepdim=True), 1e-30) / 127.0
            lutf = torch.clamp(torch.round(lutf / scale), -127, 127)
        elif lut_dtype == "bfloat16":
            lutf = lutf.to(torch.bfloat16).to(torch.float32)
        with full_f32():
            scores = torch.bmm(oh, lutf.transpose(1, 2))  # (Gc, cap, G)
        if scale is not None:
            scores = scores * scale.transpose(1, 2)
        scores = scores + bias.reshape(group_chunk, 1, g_sz)
        if consts is not None:
            scores = scores + consts[lg][:, :, None]
        ids = index.list_ids[lg]
        scores = torch.where(ids[:, :, None] >= 0, scores, bad)
        sc_t = scores.transpose(1, 2).reshape(per, cap)
        ids_t = ids[:, None, :].expand(group_chunk, g_sz, cap).reshape(per, cap)
        if keep_mask is not None:
            sc_t = apply_id_filter(sc_t, ids_t, keep_mask, not inner)
        sv, si = select_k_impl(sc_t, ids_t, k, not inner, impl=select_impl)
        live = slot_live[s0:s0 + per, None]
        slot_v.append(torch.where(live, sv, bad))
        slot_i.append(torch.where(live, si, -1))
    # un-sort: slots -> sorted pairs -> pairs in probe order, merged per query
    inv = torch.argsort(order)
    pv = torch.cat(slot_v)[slot_sorted][inv].reshape(m, n_probes * k)
    pi = torch.cat(slot_i)[slot_sorted][inv].reshape(m, n_probes * k)
    dists, idx = select_k_impl(pv, pi, k, not inner, impl=select_impl)
    return _finish(index, dists, idx, lambda d: ~torch.isfinite(d))


@instrument(
    "ivf_pq.search",
    items=lambda a, kw: nrows(a[2] if len(a) > 2 else kw["queries"]),
    labels=lambda a, kw: {"k": a[3] if len(a) > 3 else kw["k"],
                          "n_probes": (a[0] if a else kw["params"]).n_probes},
)
def search(params: SearchParams, index: IvfPqIndex, queries, k: int,
           sample_filter=None, res: Resources | None = None):
    """Search (reference: ivf_pq::search :723, the filtered overload
    search_with_filtering). Returns (distances (m, k) float32, ids (m, k)
    int32) on the index's device; distances are the PQ-quantized ones, id
    -1 marks empty candidate slots and, with ``sample_filter`` (a keep-mask
    or BitsetFilter over ids), filtered ones. A byte index takes queries of
    its dtype (or float queries in its original domain). A handle ``res``
    that names another device than the index's raises."""
    if res is not None:
        res.check_holds(index.device, "the ivf_pq index")
    res = res or default_resources()
    queries = torch.as_tensor(queries).to(index.device)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "query dim mismatch")
    queries = _coerce_queries(index.data_kind, queries)
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
    select_impl = _SELECT_IMPLS[params.select_impl]
    widen = int(params.funnel_widen)
    expects(widen >= 1, "funnel_widen must be >= 1, got %d", widen)
    if widen > 1:
        expects(index.has_fast_scan,
                "funnel_widen=%d widens through the fast-scan tier, but this index carries "
                "none — build with IndexParams.fast_scan='1bit'|'4bit'", widen)
        bytes_per_probe_row = funnel_scan_bytes_per_probe_row(index.capacity,
                                                              index.list_sig.shape[2])
    else:
        bytes_per_probe_row = pq_scan_bytes_per_probe_row(index.capacity, index.pq_dim,
                                                          n_codes)
    query_tile, probe_chunk = plan_search_tiles(
        queries.shape[0], n_probes, int(k), index.capacity,
        bytes_per_probe_row=bytes_per_probe_row, budget_bytes=res.workspace_bytes,
        max_query_tile=128)
    keep_mask = resolve_filter(sample_filter, index.device)
    if keep_mask is not None:
        validate_filter_covers(index, keep_mask)
    expects(params.scan_order in ("auto", "tiled", "grouped"),
            "scan_order must be 'auto', 'tiled' or 'grouped', got %r", params.scan_order)
    # the JAX package's "auto" scan is the one-hot contraction, which the
    # funnel and the grouped order require; the port's "auto" takes the
    # kernel where it can, so those two check the asked-for scan_impl
    one_hot = params.scan_impl in ("auto", "onehot")
    if widen > 1:
        expects(params.scan_order != "grouped", "funnel_widen > 1 rides the tiled scan "
                "order; set scan_order='tiled' (or 'auto')")
        expects(one_hot, "funnel_widen > 1 implements the one-hot signature contraction; "
                "set scan_impl='onehot' (or 'auto'; either runs the signature scan on the "
                "pq_scan kernel here)")
        expects(params.lut_dtype != "int8", "lut_dtype='int8' quantizes the PQ LUT; the "
                "funnel's signature tier is already 1-4 bit — use float32/bfloat16")
        # per-chunk widen pool: at least k, at most every slot the chunk scans
        k_widen = max(int(k), min(widen * int(k), probe_chunk * index.capacity))
        return _pq_search_funnel(index, queries, n_probes, int(k), k_widen, query_tile,
                                 probe_chunk, params.lut_dtype, select_impl, keep_mask)
    if params.scan_order == "grouped":
        expects(k <= index.capacity, "scan_order='grouped' selects per (pair, list): k=%d "
                "must be <= capacity=%d", k, index.capacity)
        expects(one_hot, "scan_order='grouped' implements the one-hot contraction; set "
                "scan_impl='onehot' (or 'auto')")
        expects(1 <= params.group_size <= 1024,
                "group_size must be in [1, 1024], got %d", params.group_size)
        return _pq_search_grouped(index, queries, n_probes, int(k), params.lut_dtype,
                                  int(params.group_size), select_impl=select_impl,
                                  keep_mask=keep_mask)
    return _pq_search(index, queries, n_probes, int(k), query_tile, probe_chunk,
                      params.lut_dtype, scan_impl, select_impl, keep_mask,
                      keep_words=getattr(sample_filter, "words", None))


def batched_searcher(index: IvfPqIndex, params: SearchParams | None = None):
    """The serving hook (contract in :mod:`._hooks`): ``fn(queries, k) ->
    (distances, ids)`` with ``kind``, ``dim`` and ``query_dtype``. An index
    with a tune decision and no ``params`` would take its pinned operating
    point from ``tune/apply.py``, which is not yet ported."""
    from ._hooks import make_hook

    if params is None and index.tuned is not None:
        _not_ported("batched_searcher of a tuned index without params (tune.apply)")
    sp = params or SearchParams()
    return make_hook(lambda queries, k: search(sp, index, queries, k),
                     "ivf_pq", index.dim, index.data_kind, index.device)


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
