"""Synthetic dataset generators.

Counterpart of raft_tpu/random/datagen.py (reference: random/make_blobs.cuh,
make_regression.cuh, multi_variable_gaussian.cuh). Each call draws from one
generator (:func:`.rng.as_key` of ``seed``) in the JAX module's order:
centers, labels, noise, permutation. Products run in full float32.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32
from .rng import _draw

__all__ = ["make_blobs", "make_regression", "multi_variable_gaussian"]


def make_blobs(
    n_samples: int,
    n_features: int,
    n_clusters: int = 3,
    cluster_std: float = 1.0,
    centers=None,
    center_box=(-10.0, 10.0),
    shuffle: bool = True,
    seed=0,
    dtype=torch.float32,
    res: Resources | None = None,
):
    """Gaussian-blob clusters (reference: random/make_blobs.cuh).

    Returns ``(X (n_samples, n_features), labels (n_samples,) int32)``.
    ``centers`` may be a precomputed (n_clusters, n_features) array.
    """
    res = res or default_resources()
    g, dev = _draw(seed, res)
    if centers is None:
        lo, hi = center_box
        centers = torch.rand((n_clusters, n_features), generator=g, device=dev,
                             dtype=dtype) * (hi - lo) + lo
    else:
        centers = res.put(centers, dtype)
        n_clusters = centers.shape[0]
    labels = torch.randint(0, n_clusters, (n_samples,), generator=g, device=dev,
                           dtype=torch.int32)
    x = centers[labels.long()] + torch.randn((n_samples, n_features), generator=g,
                                             device=dev, dtype=dtype) * cluster_std
    if shuffle:
        perm = torch.randperm(n_samples, generator=g, device=dev)
        x, labels = x[perm], labels[perm]
    return x, labels


def make_regression(
    n_samples: int,
    n_features: int,
    n_informative: int | None = None,
    n_targets: int = 1,
    bias: float = 0.0,
    noise: float = 0.0,
    shuffle: bool = True,
    seed=0,
    dtype=torch.float32,
    res: Resources | None = None,
):
    """Linear-model regression data (reference: random/make_regression.cuh).

    Returns ``(X, y, coef)`` with ``y = X @ coef + bias + N(0, noise)``;
    the first ``n_informative`` rows of ``coef`` are uniform on [0, 100),
    the rest 0; ``y`` is 1-D when ``n_targets == 1``.
    """
    res = res or default_resources()
    n_informative = n_features if n_informative is None else min(n_informative, n_features)
    g, dev = _draw(seed, res)
    x = torch.randn((n_samples, n_features), generator=g, device=dev, dtype=dtype)
    coef = torch.zeros((n_features, n_targets), device=dev, dtype=dtype)
    coef[:n_informative] = 100.0 * torch.rand((n_informative, n_targets), generator=g,
                                              device=dev, dtype=dtype)
    with full_f32():
        y = x @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=g, device=dev, dtype=dtype)
    if shuffle:
        perm = torch.randperm(n_samples, generator=g, device=dev)
        x, y = x[perm], y[perm]
    return x, y[:, 0] if n_targets == 1 else y, coef


def multi_variable_gaussian(rng, mean, cov, n_samples: int, dtype=torch.float32,
                            res: Resources | None = None):
    """Samples of N(mean, cov) through the Cholesky factor of
    ``cov + 1e-6·I`` (reference: random/multi_variable_gaussian.cuh)."""
    res = res or default_resources()
    mean = res.put(mean, dtype)
    cov = res.put(cov, dtype)
    d = mean.shape[0]
    expects(tuple(cov.shape) == (d, d), "cov must be (d, d)")
    chol = torch.linalg.cholesky(cov + 1e-6 * torch.eye(d, device=cov.device, dtype=dtype))
    g, dev = _draw(rng, res)
    z = torch.randn((n_samples, d), generator=g, device=dev, dtype=dtype)
    with full_f32():
        return mean[None, :] + z @ chol.T
