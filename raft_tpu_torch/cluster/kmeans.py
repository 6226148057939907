"""k-means clustering.

Counterpart of raft_tpu/cluster/kmeans.py (reference: cluster/kmeans.cuh,
detail/kmeans.cuh: kmeansPlusPlus :90, the Lloyd loop kmeans_fit_main :361,
update_centroids :287, auto-k detail/kmeans_auto_find_k.cuh):

- assignment is :func:`~raft_tpu_torch.distance.fused_nn._fused_l2_nn` (a
  full-float32 product and argmin per row tile);
- the weighted centroid update is ``index_add_`` of the rows into their
  labels' sums;
- the Lloyd loop runs on the host, reading ``shift²`` back each iteration,
  with the JAX package's stop rule ``it < max_iter and shift² > tol²`` and
  its empty-cluster rule (a centroid with no weight stays where it was).

Randomness (k-means++ trials, "random" init) comes from a
``torch.Generator`` seeded with ``params.seed`` on the data's device, so it
does not give the JAX package's numbers: from ``init="array"`` the two fits
agree, from the random inits they are compared by inertia. The JAX
package's obs hooks and trace ranges wait for the port of ``obs`` and
``core/tracing``; results are torch tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.fused_nn import _fused_l2_nn
from ..distance.pairwise import _choose_tile, _l2_expanded, pairwise_distance
from ..obs.instrument import instrument, nrows

__all__ = ["KMeansParams", "KMeansOutput", "fit", "predict", "fit_predict",
           "transform", "cluster_cost", "find_k", "init_plus_plus",
           "update_centroids"]


@dataclasses.dataclass(frozen=True)
class KMeansParams:
    """Reference: raft::cluster::kmeans::KMeansParams (kmeans_types.hpp);
    the fields and defaults of the JAX package's."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "kmeans++"  # "kmeans++" | "random" | "array"
    seed: int = 0
    n_init: int = 1
    oversampling_factor: float = 2.0  # kept for parity; ++ is exact here
    batch_samples: int = 1 << 15
    # the distributed fit's EM policy (raft_tpu.parallel.kmeans); the
    # single-device fit always runs full Lloyd
    train_mode: str = "full"
    batch_rows: int = 1 << 16


@dataclasses.dataclass
class KMeansOutput:
    centroids: torch.Tensor        # (k, d) float32
    labels: torch.Tensor | None    # (n,) int32
    inertia: torch.Tensor          # float32 scalar
    n_iter: int


def _assign(x, centroids, tile: int):
    """Nearest centroid of each row: (squared distances, int32 labels)."""
    return _fused_l2_nn(x, centroids, False, tile)


def _update(xf, labels, weights, k: int):
    """Weighted per-label sums (k, d) and weights (k,) (ref:
    update_centroids :287)."""
    lab = labels.to(torch.int64)
    sums = torch.zeros((k, xf.shape[1]), dtype=torch.float32, device=xf.device)
    if weights is None:
        sums.index_add_(0, lab, xf)
        return sums, torch.bincount(lab, minlength=k).to(torch.float32)
    sums.index_add_(0, lab, xf * weights[:, None])
    counts = torch.zeros(k, dtype=torch.float32, device=xf.device).index_add_(0, lab, weights)
    return sums, counts


def _new_centroids(sums, counts, centroids):
    # the divisor is the true (possibly fractional) weight total; a cluster
    # without weight keeps its centroid
    denom = torch.where(counts > 0, counts, 1.0)
    return torch.where(counts[:, None] > 0, sums / denom[:, None], centroids)


def _lloyd(x, init_centroids, weights, k: int, max_iter: int, tol: float, tile: int):
    """The Lloyd loop (ref: kmeans_fit_main, detail/kmeans.cuh:361). Returns
    (centroids, labels, inertia, n_iter)."""
    xf = x.to(torch.float32)
    centroids = init_centroids.to(torch.float32)
    shift2, it = math.inf, 0
    while it < max_iter and shift2 > tol * tol:
        _, labels = _assign(x, centroids, tile)
        sums, counts = _update(xf, labels, weights, k)
        new = _new_centroids(sums, counts, centroids)
        shift2 = float(torch.square(new - centroids).sum())
        centroids, it = new, it + 1
    d2, labels = _assign(x, centroids, tile)
    inertia = (d2 if weights is None else d2 * weights).sum()
    return centroids, labels, inertia, it


def _kmeans_plus_plus(x, g, k: int):
    """Greedy k-means++ seeding (ref: kmeansPlusPlus, detail/kmeans.cuh:90;
    n_trials = 2 + ceil(log k) at :113-255): each step draws ``n_trials``
    candidates with probability proportional to the current min squared
    distance (D² sampling) and keeps the one that lowers the total cost
    most."""
    n, d = x.shape
    trials = 2 + int(math.ceil(math.log(max(k, 2))))
    xf = x.to(torch.float32)
    first = int(torch.randint(0, n, (1,), generator=g, device=x.device))
    centers = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centers[0] = xf[first]
    mind2 = _l2_expanded(xf[first][None, :], xf, sqrt=False)[0]
    for i in range(1, k):
        cand = torch.multinomial(torch.clamp_min(mind2, 1e-30), trials,
                                 replacement=True, generator=g)
        cvec = xf[cand]
        newmin = torch.minimum(mind2[None, :], _l2_expanded(cvec, xf, sqrt=False))
        best = int(torch.argmin(newmin.sum(dim=1)))
        centers[i] = cvec[best]
        mind2 = newmin[best]
    return centers


def _init_centroids(params: KMeansParams, x, centroids, g, res: Resources):
    if params.init == "array":
        expects(centroids is not None, "init='array' requires centroids")
        return res.put(centroids, torch.float32)
    if params.init == "random":
        idx = torch.randperm(x.shape[0], generator=g, device=x.device)[:params.n_clusters]
        return x[idx].to(torch.float32)
    expects(params.init == "kmeans++", "unknown init %s", params.init)
    return _kmeans_plus_plus(x, g, params.n_clusters)


def _weights(sample_weights, res: Resources):
    return None if sample_weights is None else res.put(sample_weights, torch.float32)


@instrument("cluster.kmeans.fit",
            items=lambda a, kw: nrows(a[1] if len(a) > 1 else kw["x"]),
            labels=lambda a, kw: {
                "n_clusters": (a[0] if a else kw["params"]).n_clusters})
def fit(params: KMeansParams, x, sample_weights=None, centroids=None,
        res: Resources | None = None) -> KMeansOutput:
    """Fit k-means (reference: raft::cluster::kmeans::fit) on the handle's
    device; of ``n_init`` trials the one with the least inertia wins."""
    res = res or default_resources()
    x = res.put(x)
    expects(x.ndim == 2, "X must be (n_samples, n_features)")
    expects(params.n_clusters <= x.shape[0], "n_clusters > n_samples")
    w = _weights(sample_weights, res)
    tile = _choose_tile(x.shape[0], params.n_clusters, 1, res.workspace_bytes)
    g = torch.Generator(device=x.device).manual_seed(int(params.seed))
    best = None
    for _ in range(max(params.n_init, 1)):
        init_c = _init_centroids(params, x, centroids, g, res)
        c, labels, inertia, n_iter = _lloyd(x, init_c, w, params.n_clusters,
                                            params.max_iter, params.tol, tile)
        if best is None or float(inertia) < float(best.inertia):
            best = KMeansOutput(c, labels, inertia, int(n_iter))
    return best


@instrument("cluster.kmeans.predict",
            items=lambda a, kw: nrows(a[0] if a else kw["x"]))
def predict(x, centroids, sample_weights=None, res: Resources | None = None):
    """Nearest-centroid labels (reference: kmeans::predict). Returns (labels
    (n,) int32, inertia)."""
    res = res or default_resources()
    x = res.put(x)
    centroids = res.put(centroids)
    tile = _choose_tile(x.shape[0], centroids.shape[0], 1, res.workspace_bytes)
    d2, labels = _assign(x, centroids, tile)
    w = _weights(sample_weights, res)
    return labels, (d2 if w is None else d2 * w).sum()


def fit_predict(params: KMeansParams, x, sample_weights=None,
                res: Resources | None = None):
    out = fit(params, x, sample_weights, res=res)
    return out.labels, out


def transform(x, centroids, res: Resources | None = None):
    """Squared distances to every centroid (reference: kmeans::transform)."""
    return pairwise_distance(x, centroids, metric="sqeuclidean", res=res)


def cluster_cost(x, centroids, res: Resources | None = None):
    """Total squared distance to the nearest centroid."""
    return predict(x, centroids, res=res)[1]


def init_plus_plus(x, n_clusters: int, seed: int = 0, res: Resources | None = None):
    """Standalone k-means++ seeding (reference: raft_runtime
    kmeans::init_plus_plus). Returns (n_clusters, d) centroids."""
    res = res or default_resources()
    x = res.put(x)
    expects(x.ndim == 2, "X must be (n_samples, n_features)")
    expects(n_clusters <= x.shape[0], "n_clusters > n_samples")
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    return _kmeans_plus_plus(x, g, int(n_clusters))


def update_centroids(x, centroids, sample_weights=None, res: Resources | None = None):
    """One weighted Lloyd step (reference: raft_runtime
    kmeans::update_centroids). Returns (new_centroids, labels)."""
    res = res or default_resources()
    x = res.put(x)
    centroids = res.put(centroids, torch.float32)
    k = centroids.shape[0]
    tile = _choose_tile(x.shape[0], k, 1, res.workspace_bytes)
    _, labels = _assign(x, centroids, tile)
    sums, counts = _update(x.to(torch.float32), labels, _weights(sample_weights, res), k)
    return _new_centroids(sums, counts, centroids), labels


def find_k(x, k_range, params: KMeansParams | None = None, res: Resources | None = None):
    """Pick k by the largest Calinski–Harabasz index over the caller's
    candidates (reference: detail/kmeans_auto_find_k.cuh:196, its binary
    search replaced by a scan of ``k_range``). Returns (best_k, {k: score})."""
    from ..stats.metrics import dispersion

    params = params or KMeansParams()
    res = res or default_resources()
    x = res.put(x)
    n = x.shape[0]
    scores = {}
    best_k, best_score = None, None
    for k in k_range:
        k = int(k)
        out = fit(dataclasses.replace(params, n_clusters=k), x, res=res)
        sizes = torch.bincount(out.labels.to(torch.int64), minlength=k).to(torch.float32)
        bgss = float(dispersion(out.centroids, sizes, res=res)) ** 2
        wss = max(float(out.inertia), 1e-30)
        ch = (n - k) / max(k - 1, 1) * bgss / wss
        scores[k] = ch
        if best_score is None or ch > best_score:
            best_k, best_score = k, ch
    return best_k, scores
