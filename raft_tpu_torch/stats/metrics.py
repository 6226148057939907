"""Model and clustering evaluation metrics.

Counterpart of raft_tpu/stats/metrics.py (reference: stats/accuracy.cuh,
r2_score.cuh, regression_metrics.cuh, entropy.cuh, mutual_info_score.cuh,
rand_index.cuh, adjusted_rand_index.cuh, homogeneity_score.cuh,
completeness_score.cuh, v_measure.cuh, kl_divergence.cuh,
silhouette_score.cuh, trustworthiness_score.cuh, dispersion.cuh,
contingency_matrix.cuh, information_criterion.cuh). Each returns a
float32 tensor on the handle's device, with the JAX module's formulas and
guards (the ``1e-30`` floors, ``where(p > 0, ...)``).

Two departures in how, not what:
  - the contingency matrix and the class counts, one-hot products in the
    JAX module, are integer counts here (a ``bincount`` of
    ``a·n_b + b``), exact in any order; labels outside the classes count
    nowhere, as a one-hot row of zeros;
  - the median of ``regression_metrics`` sorts and averages the two middle
    values of an even count, as ``jnp.median`` does (``torch.median``
    returns the lower one).

``trustworthiness`` ranks the original space with a stable argsort (as
``jnp.argsort``) and takes the embedding's k nearest through
``matrix.select_k.select_k_impl``, which on a card runs the ``topk``
kernel for rows of 1,024 or more. Both order -0 with +0 as equal and break
ties by the lowest index, as ``jnp.argsort`` does: the embedding's
distances are folded to +0 first, since the plain select route ranks -0
below +0 (``lax.top_k``'s order).
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32, pairwise_distance
from ..matrix.select_k import select_k_impl

__all__ = [
    "accuracy",
    "r2_score",
    "regression_metrics",
    "entropy",
    "contingency_matrix",
    "mutual_info_score",
    "rand_index",
    "adjusted_rand_index",
    "homogeneity_score",
    "completeness_score",
    "v_measure",
    "kl_divergence",
    "silhouette_score",
    "dispersion",
    "trustworthiness",
    "information_criterion",
]

_f32 = torch.float32


def _res(res):
    return res or default_resources()


def accuracy(predictions, labels, res: Resources | None = None):
    """Fraction of exact matches (reference: stats/accuracy.cuh)."""
    res = _res(res)
    return (res.put(predictions) == res.put(labels)).to(_f32).mean()


def r2_score(y, y_hat, res: Resources | None = None):
    """Coefficient of determination (reference: stats/r2_score.cuh)."""
    res = _res(res)
    y, y_hat = res.put(y, _f32), res.put(y_hat, _f32)
    ss_res = torch.square(y - y_hat).sum()
    ss_tot = torch.square(y - y.mean()).sum()
    return 1.0 - ss_res / ss_tot


def _median(v):
    s = torch.sort(v.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def regression_metrics(predictions, ref, res: Resources | None = None):
    """(mean absolute error, mean squared error, median absolute error)
    (reference: stats/regression_metrics.cuh)."""
    res = _res(res)
    err = res.put(predictions, _f32) - res.put(ref, _f32)
    ae = torch.abs(err)
    return ae.mean(), torch.square(err).mean(), _median(ae)


def _class_counts(labels, n_classes: int):
    lab = labels.to(torch.int64)
    flat = torch.where((lab >= 0) & (lab < n_classes), lab, n_classes)
    return torch.bincount(flat.reshape(-1), minlength=n_classes + 1)[:n_classes].to(_f32)


def entropy(labels, n_classes: int, res: Resources | None = None):
    """Shannon entropy of a label distribution, in nats (reference:
    stats/entropy.cuh)."""
    counts = _class_counts(_res(res).put(labels), n_classes)
    p = counts / counts.sum()
    return -torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0).sum()


def _n_classes(*labels):
    """max + 1 of each label array, read back in one transfer."""
    return [int(v) + 1 for v in torch.stack([x.max() for x in labels]).tolist()]


def contingency_matrix(a, b, n_classes_a: int | None = None, n_classes_b: int | None = None,
                       res: Resources | None = None):
    """Joint label counts, (n_a, n_b) int32 (reference:
    stats/contingency_matrix.cuh); class counts default to max + 1."""
    res = _res(res)
    a, b = res.put(a).to(torch.int64), res.put(b).to(torch.int64)
    if n_classes_a is None or n_classes_b is None:
        ma, mb = _n_classes(a, b)
        na = int(n_classes_a) if n_classes_a is not None else ma
        nb = int(n_classes_b) if n_classes_b is not None else mb
    else:
        na, nb = int(n_classes_a), int(n_classes_b)
    ok = (a >= 0) & (a < na) & (b >= 0) & (b < nb)
    flat = torch.where(ok, a * nb + b, na * nb)
    counts = torch.bincount(flat.reshape(-1), minlength=na * nb + 1)[:na * nb]
    return counts.reshape(na, nb).to(torch.int32)


def _mi_from_contingency(c):
    c = c.to(_f32)
    pij = c / c.sum()
    pi = pij.sum(dim=1, keepdim=True)
    pj = pij.sum(dim=0, keepdim=True)
    logterm = torch.where(pij > 0, torch.log(torch.where(pij > 0, pij, 1.0))
                          - torch.log(pi * pj + 1e-30), 0.0)
    return (pij * logterm).sum()


def mutual_info_score(a, b, n_classes: int, res: Resources | None = None):
    """Reference: stats/mutual_info_score.cuh."""
    return _mi_from_contingency(contingency_matrix(a, b, n_classes, n_classes, res=res))


def _comb2(x):
    return x * (x - 1.0) / 2.0


def rand_index(a, b, res: Resources | None = None):
    """Unadjusted Rand index (reference: stats/rand_index.cuh), from float32
    pair counts."""
    c = contingency_matrix(a, b, res=res).to(_f32)
    total = _comb2(c.sum())
    return (total + 2 * _comb2(c).sum() - _comb2(c.sum(dim=1)).sum()
            - _comb2(c.sum(dim=0)).sum()) / total


def adjusted_rand_index(a, b, n_classes: int | None = None, res: Resources | None = None):
    """ARI (reference: stats/adjusted_rand_index.cuh); ``n_classes``
    defaults to max + 1 of each labelling."""
    n = n_classes or None
    c = contingency_matrix(a, b, n, n, res=res).to(_f32)
    sum_comb = _comb2(c).sum()
    sum_rows = _comb2(c.sum(dim=1)).sum()
    sum_cols = _comb2(c.sum(dim=0)).sum()
    expected = sum_rows * sum_cols / _comb2(c.sum())
    max_index = 0.5 * (sum_rows + sum_cols)
    return (sum_comb - expected) / (max_index - expected + 1e-30)


def _conditional_entropy(c):
    """H(A|B) from the contingency counts c[a, b]."""
    c = c.to(_f32)
    n = c.sum()
    ratio = c / torch.clamp_min(c.sum(dim=0)[None, :], 1e-30)
    term = torch.where(c > 0, (c / n) * torch.log(torch.where(ratio > 0, ratio, 1.0)), 0.0)
    return -term.sum()


def homogeneity_score(labels_true, labels_pred, n_classes: int, res: Resources | None = None):
    """1 - H(C|K) / H(C) (reference: stats/homogeneity_score.cuh)."""
    c = contingency_matrix(labels_true, labels_pred, n_classes, n_classes, res=res)
    h_c = entropy(labels_true, n_classes, res=res)
    h_ck = _conditional_entropy(c)
    return torch.where(h_c > 0, 1.0 - h_ck / torch.clamp_min(h_c, 1e-30), 1.0)


def completeness_score(labels_true, labels_pred, n_classes: int, res: Resources | None = None):
    """Reference: stats/completeness_score.cuh."""
    return homogeneity_score(labels_pred, labels_true, n_classes, res=res)


def v_measure(labels_true, labels_pred, n_classes: int, beta: float = 1.0,
              res: Resources | None = None):
    """Weighted harmonic mean of homogeneity and completeness (reference:
    stats/v_measure.cuh)."""
    h = homogeneity_score(labels_true, labels_pred, n_classes, res=res)
    c = completeness_score(labels_true, labels_pred, n_classes, res=res)
    return torch.where(h + c > 0, (1 + beta) * h * c / (beta * h + c + 1e-30), 0.0)


def kl_divergence(p, q, res: Resources | None = None):
    """Σ p log(p / q) over two densities (reference: stats/kl_divergence.cuh)."""
    res = _res(res)
    p, q = res.put(p, _f32), res.put(q, _f32)
    return torch.where(p > 0, p * (torch.log(torch.where(p > 0, p, 1.0))
                                   - torch.log(torch.clamp_min(q, 1e-30))), 0.0).sum()


def _one_hot(labels, n_classes: int):
    """(n, n_classes) float32; a label outside the classes is a row of 0."""
    return (labels.to(torch.int64)[:, None]
            == torch.arange(n_classes, device=labels.device)[None, :]).to(_f32)


def silhouette_score(x, labels, n_classes: int, metric="euclidean",
                     res: Resources | None = None):
    """Mean silhouette coefficient (reference: stats/silhouette_score.cuh).

    Each sample's distance mass to each cluster is one (n, n)·(n, k)
    product of the pairwise distances and the one-hot labels, in full
    float32.
    """
    res = _res(res)
    x, labels = res.put(x), res.put(labels).to(torch.int64)
    d = pairwise_distance.native(x, x, metric=metric, res=res)
    onehot = _one_hot(labels, n_classes)
    with full_f32():
        sums = d @ onehot                                 # (n, k)
    counts = onehot.sum(dim=0)
    own_count = counts[labels]
    own_sum = torch.gather(sums, 1, labels[:, None])[:, 0]
    a = torch.where(own_count > 1, own_sum / torch.clamp_min(own_count - 1, 1), 0.0)
    other_mean = torch.where((counts[None, :] > 0) & (onehot == 0),
                             sums / torch.clamp_min(counts[None, :], 1), torch.inf)
    b = other_mean.amin(dim=1)
    s = torch.where(own_count > 1, (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30), 0.0)
    return s.mean()


def dispersion(centroids, cluster_sizes, global_centroid=None,
               res: Resources | None = None):
    """Size-weighted scatter of centroids around the global mean,
    sqrt(Σ_c size_c · ‖c − g‖²); ``g`` defaults to the size-weighted mean of
    the centroids (reference: stats/dispersion.cuh)."""
    res = _res(res)
    c = res.put(centroids, _f32)
    sizes = res.put(cluster_sizes, _f32)
    if global_centroid is None:
        g = (c * sizes[:, None]).sum(dim=0) / sizes.sum()
    else:
        g = res.put(global_centroid, _f32)
    sq = torch.square(c - g[None, :]).sum(dim=1)
    return torch.sqrt((sizes * sq).sum())


def _emb_knn(d_emb, k: int):
    """Each row's k smallest columns, ties to the lowest column and -0 equal
    to +0 (``jnp.argsort(d)[:, :k]``)."""
    return select_k_impl(d_emb + 0.0, None, int(k), select_min=True)[1]


def trustworthiness(x, x_embedded, n_neighbors: int, metric="euclidean",
                    res: Resources | None = None):
    """Embedding-quality score (reference: stats/trustworthiness_score.cuh):
    penalizes points that are among the k nearest in the embedding but far
    in the original space."""
    res = _res(res)
    x, e = res.put(x), res.put(x_embedded)
    n = x.shape[0]
    k = n_neighbors
    expects(k < n / 2, "n_neighbors must be < n/2")
    big = torch.finfo(_f32).max
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d_orig = pairwise_distance.native(x, x, metric=metric, res=res).masked_fill_(eye, big)
    d_emb = pairwise_distance.native(e, e, metric=metric, res=res).masked_fill_(eye, big)
    # rank of j in i's original-space order (0 = nearest)
    order = torch.argsort(d_orig, dim=1, stable=True)
    del d_orig
    ranks = torch.empty((n, n), dtype=torch.int32, device=x.device)
    ranks.scatter_(1, order, torch.arange(n, dtype=torch.int32, device=x.device)
                   .expand(n, n))
    del order
    r = torch.gather(ranks, 1, _emb_knn(d_emb, k).to(torch.int64)).to(_f32)
    penalty = torch.clamp_min(r - (k - 1), 0.0).sum()
    norm = 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))
    return 1.0 - norm * penalty


def information_criterion(log_likelihood, n_params: int, n_samples: int, kind: str = "bic",
                          res: Resources | None = None):
    """AIC, AICc or BIC (reference: stats/information_criterion.cuh)."""
    ll = _res(res).put(log_likelihood, _f32)
    if kind == "aic":
        return -2.0 * ll + 2.0 * n_params
    if kind == "aicc":
        corr = 2.0 * n_params * (n_params + 1.0) / max(n_samples - n_params - 1.0, 1.0)
        return -2.0 * ll + 2.0 * n_params + corr
    expects(kind == "bic", "kind must be aic|aicc|bic")
    return -2.0 * ll + n_params * torch.log(torch.tensor(float(n_samples), dtype=_f32,
                                                         device=ll.device))
