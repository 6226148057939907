"""Balanced k-means, the coarse quantizer trainer of IVF indexes.

Counterpart of raft_tpu/cluster/kmeans_balanced.py (reference:
cluster/kmeans_balanced.cuh, detail/kmeans_balanced.cuh: EM loop :618,
adjust_centers :524, predict :371). A fixed number of EM iterations (no
tolerance) and a balancing step that re-seeds the centers of under-populated
clusters from members of crowded ones, so inverted lists stay usable.

Assignment is :func:`~raft_tpu_torch.distance.fused_nn._fused_l2_nn` (a
full-float32 product and argmin per row tile); center sums are
:func:`raft_tpu_torch.matrix.ops.segment_sum`, in a fixed order, so a fit
repeats bit for bit on a card. ``train_mode="minibatch"`` (the default through "auto" above
2 x ``batch_rows`` trainset rows) iterates over rotating mini-batches of one
shuffle with the streaming 1/c center update (Sculley, WWW 2010), and one
full-trainset pass closes every fit.

Randomness comes from a ``torch.Generator`` seeded with ``params.seed`` on
the handle's device (for a chunked reader too, so a streamed build trains
on the same rows). It does not give the JAX package's numbers: the two fits
are compared by inertia and list balance, not bit for bit. The JAX package's
trainer metrics (``obs.build``'s assignment passes and sampled rows) are not
emitted yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import chunked
from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.fused_nn import _fused_l2_nn
from ..distance.pairwise import _choose_tile, full_f32
from ..matrix.ops import segment_sum

__all__ = ["KMeansBalancedParams", "fit", "predict", "fit_predict",
           "build_clusters", "resolve_train_mode"]


@dataclasses.dataclass(frozen=True)
class KMeansBalancedParams:
    """Reference: kmeans_balanced_params (cluster/kmeans_balanced_types.hpp);
    the fields and defaults of the JAX package's."""

    n_iters: int = 20
    metric: str = "sqeuclidean"      # L2 or inner_product assignment
    seed: int = 0
    # clusters smaller than avg_size * small_ratio are re-seeded
    small_ratio: float = 0.25
    max_train_points: int | None = None   # subsample cap for fit
    # "full": every EM iteration assigns the whole trainset; "minibatch":
    # rotating batch_rows-row batches, then one full sharpening pass; "auto":
    # minibatch above 2 x batch_rows trainset rows
    train_mode: str = "auto"
    batch_rows: int = 65536


def resolve_train_mode(mode: str, n_train: int, batch_rows: int) -> str:
    """The ``train_mode`` policy for a trainset size."""
    expects(mode in ("full", "minibatch", "auto"),
            "train_mode must be 'full', 'minibatch' or 'auto', got %r", mode)
    expects(batch_rows >= 1, "batch_rows must be >= 1, got %d", batch_rows)
    if mode == "auto":
        return "minibatch" if n_train > 2 * batch_rows else "full"
    return mode


def _assign_labels(x, centers, tile: int, inner: bool):
    if inner:
        out = []
        for i in range(0, x.shape[0], tile):
            with full_f32():
                scores = x[i:i + tile].to(torch.float32) @ centers.T
            out.append(torch.argmax(scores, dim=1).to(torch.int32))
        return torch.cat(out)
    return _fused_l2_nn(x, centers, False, tile)[1]


def _sums_counts(xf, labels, k: int):
    lab = labels.to(torch.int64)
    return segment_sum(xf, lab, k), torch.bincount(lab, minlength=k).to(torch.float32)


def _choice(g, n: int, size: int, device):
    """``size`` distinct indices of ``range(n)``."""
    return torch.randperm(n, generator=g, device=device)[:size]


def _reseed_small(centers, counts, pool_w, pool_vecs, g, k: int, avg: float,
                  small_ratio: float):
    """The balancing step (ref: adjust_centers :524): centers of clusters
    under ``avg * small_ratio`` members move to pool points drawn by
    crowdedness of their cluster, without replacement (Gumbel top-k), so two
    small clusters never re-seed to one point. Returns (centers, small)."""
    small = counts < (avg * small_ratio)
    logits = torch.log(torch.clamp_min(pool_w, 1e-6))
    u = torch.rand(pool_vecs.shape[0], generator=g, device=centers.device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))
    repl = pool_vecs[torch.topk(logits + gumbel, k).indices]
    return torch.where(small[:, None], repl, centers), small


def _balanced_em(x, centers, g, k: int, n_iters: int, small_ratio: float,
                 tile: int, inner: bool):
    """Full-data EM loop (train_mode="full"); returns unsharpened centers."""
    n = x.shape[0]
    xf = x.to(torch.float32)
    pool = min(max(4 * k, 4096), n)
    for _ in range(n_iters):
        labels = _assign_labels(x, centers, tile, inner)
        sums, counts = _sums_counts(xf, labels, k)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp_min(counts, 1.0)[:, None], centers)
        pool_idx = _choice(g, n, pool, x.device)
        pool_w = counts[labels[pool_idx].to(torch.int64)]
        centers, _ = _reseed_small(centers, counts, pool_w, xf[pool_idx], g, k,
                                   n / k, small_ratio)
    return centers


def _balanced_em_minibatch(x, centers, g, k: int, n_iters: int,
                           small_ratio: float, tile: int, inner: bool,
                           batch: int):
    """Mini-batch EM loop (train_mode="minibatch"); returns unsharpened
    centers. Rotating batches of one shuffle; a center moves by
    (batch sum - batch count x center) / its cumulative count; the balancing
    re-seed runs on the batch's counts, and a re-seeded center's cumulative
    count resets so its next update replaces it by the batch mean."""
    n = x.shape[0]
    perm = torch.randperm(n, generator=g, device=x.device)
    offs = torch.arange(batch, device=x.device)
    ccounts = torch.zeros(k, dtype=torch.float32, device=x.device)
    pool = min(max(4 * k, 4096), batch)
    for i in range(n_iters):
        xb = x[perm[(i * batch + offs) % n]].to(torch.float32)
        labels = _assign_labels(xb, centers, tile, inner)
        sums, counts = _sums_counts(xb, labels, k)
        ccounts = ccounts + counts
        centers = centers + (sums - counts[:, None] * centers) / torch.clamp_min(
            ccounts, 1.0)[:, None]
        pool_idx = _choice(g, batch, pool, x.device)
        pool_w = counts[labels[pool_idx].to(torch.int64)]
        centers, small = _reseed_small(centers, counts, pool_w, xb[pool_idx], g,
                                       k, batch / k, small_ratio)
        ccounts = torch.where(small, 0.0, ccounts)
    return centers


def _final_sharpen(x, centers, k: int, tile: int, inner: bool):
    """One full-data pass without balancing, so centers are true means."""
    labels = _assign_labels(x, centers, tile, inner)
    sums, counts = _sums_counts(x.to(torch.float32), labels, k)
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp_min(counts, 1.0)[:, None], centers)


def _is_inner(metric: str) -> bool:
    from ..distance.types import DistanceType, resolve_metric

    mt = resolve_metric(metric)
    expects(
        mt in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
               DistanceType.InnerProduct),
        "kmeans_balanced supports L2 / inner_product metrics, got %s", mt.name,
    )
    return mt == DistanceType.InnerProduct


def fit(params: KMeansBalancedParams, x, n_clusters: int,
        res: Resources | None = None):
    """Train balanced cluster centers (reference: kmeans_balanced::fit).
    Returns (n_clusters, d) float32 centers on the handle's device.

    ``x`` may be a chunked reader (:mod:`raft_tpu_torch.core.chunked`, the
    streamed builds): it stays on the host until the trainset gather, whose
    indices are drawn exactly as in-core (the same generator on the
    handle's device, the same calls), then gathered off the reader and
    uploaded, so the centers equal the in-core fit's bit for bit."""
    res = res or default_resources()
    dev = res.torch_device
    stream = chunked.is_reader(x)
    if not stream:
        x = res.put(x)
    expects(x.ndim == 2, "X must be 2-D")
    n = int(x.shape[0])
    expects(n_clusters <= n, "n_clusters > n_samples")
    g = torch.Generator(device=dev).manual_seed(int(params.seed))
    if params.max_train_points is not None and n > params.max_train_points:
        x = chunked.take_rows(x, _choice(g, n, params.max_train_points, dev))
        n = params.max_train_points
    elif stream:
        x = chunked.materialize(x, device=dev)
    x = res.put(x)
    centers = x[_choice(g, n, n_clusters, x.device)].to(torch.float32)
    tile = _choose_tile(n, n_clusters, 1, res.workspace_bytes)
    inner = _is_inner(params.metric)
    if resolve_train_mode(params.train_mode, n, params.batch_rows) == "minibatch":
        # the balancing pool needs at least n_clusters candidates per batch
        batch = min(n, max(params.batch_rows, n_clusters))
        centers = _balanced_em_minibatch(x, centers, g, n_clusters, params.n_iters,
                                         params.small_ratio, min(tile, batch),
                                         inner, batch)
    else:
        centers = _balanced_em(x, centers, g, n_clusters, params.n_iters,
                               params.small_ratio, tile, inner)
    return _final_sharpen(x, centers, n_clusters, tile, inner)


def predict(x, centers, metric: str = "sqeuclidean", res: Resources | None = None):
    """Nearest-center labels, int32 (reference: kmeans_balanced::predict)."""
    res = res or default_resources()
    x = res.put(x)
    centers = res.put(centers, torch.float32)
    tile = _choose_tile(x.shape[0], centers.shape[0], 1, res.workspace_bytes)
    return _assign_labels(x, centers, tile, _is_inner(metric))


def fit_predict(params: KMeansBalancedParams, x, n_clusters: int,
                res: Resources | None = None):
    centers = fit(params, x, n_clusters, res=res)
    return centers, predict(x, centers, metric=params.metric, res=res)


def build_clusters(params: KMeansBalancedParams, x, n_clusters: int,
                   res: Resources | None = None):
    """Train, assign and count in one call, the IVF-build entry point
    (reference: detail::kmeans_balanced::build_clusters). Returns (centers,
    labels, cluster_sizes int32)."""
    centers, labels = fit_predict(params, x, n_clusters, res=res)
    sizes = torch.bincount(labels.to(torch.int64), minlength=n_clusters).to(torch.int32)
    return centers, labels, sizes
