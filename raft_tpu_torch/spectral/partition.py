"""Spectral graph partitioning and modularity clustering.

Counterpart of raft_tpu/spectral/partition.py (reference: raft/spectral/
partition.cuh (partition :49-59, analyzePartition :81),
modularity_maximization.cuh (:36, analyzeModularity :73), detail/
{partition.hpp, modularity_maximization.hpp, spectral_util.cuh},
matrix_wrappers.hpp). The Laplacian and modularity operators are matvecs
over the port's CSR ``spmv``; the eigensolver is the thick-restart Lanczos
of ``solver/lanczos.py``; the cluster stage is the port's k-means. The
whitening (spectral_util.cuh transform_eigen_matrix :122) and the
modularity path's per-observation normalisation (scale_obs) are the JAX
package's.

Both entry points take ``v0=``, the eigensolver's start vector: the JAX
package draws it from ``EigenSolverConfig.seed`` with its own generator, so
giving both packages one ``v0`` makes them solve the same problem. The
k-means draws are the port's own (a torch generator), so labels agree with
the JAX package's at the partition level, not by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cluster.kmeans import KMeansParams, fit as kmeans_fit
from ..core.errors import expects
from ..core.resources import Resources
from ..solver.lanczos import eigsh
from ..sparse.linalg import laplacian, row_reduce, spmm, spmv
from ..sparse.types import CsrMatrix

__all__ = ["EigenSolverConfig", "ClusterSolverConfig", "SpectralOutput", "partition",
           "analyze_partition", "modularity_maximization", "analyze_modularity"]


@dataclasses.dataclass(frozen=True)
class EigenSolverConfig:
    """Reference: raft::spectral::eigen_solver_config_t
    (spectral/eigen_solvers.cuh:30)."""

    n_eig_vecs: int = 2
    max_iter: int = 4000
    restart_iter: int | None = None
    tol: float = 1e-4
    seed: int = 1234567


@dataclasses.dataclass(frozen=True)
class ClusterSolverConfig:
    """Reference: raft::spectral::cluster_solver_config_t
    (spectral/cluster_solvers.cuh)."""

    max_iter: int = 100
    tol: float = 1e-4
    seed: int = 123456


@dataclasses.dataclass
class SpectralOutput:
    labels: torch.Tensor          # (n,) int32
    eigenvalues: torch.Tensor     # (n_eig_vecs,)
    eigenvectors: torch.Tensor    # (n, n_eig_vecs)
    n_eigen_restarts: int
    kmeans_inertia: torch.Tensor


def _whiten(vecs: torch.Tensor) -> torch.Tensor:
    """transform_eigen_matrix (spectral_util.cuh:122): each column less its
    mean, over its population standard deviation."""
    centered = vecs - vecs.mean(dim=0, keepdim=True)
    std = torch.linalg.vector_norm(centered, dim=0, keepdim=True) / torch.sqrt(
        torch.tensor(float(vecs.shape[0]), dtype=vecs.dtype, device=vecs.device))
    return centered / torch.clamp_min(std, 1e-30)


def _cluster(embedding, n_clusters: int, cfg: ClusterSolverConfig, res: Resources):
    params = KMeansParams(n_clusters=n_clusters, max_iter=cfg.max_iter, tol=cfg.tol,
                          seed=cfg.seed)
    out = kmeans_fit(params, embedding, res=res)
    return out.labels, out.inertia


def _checked(a, res: Resources | None) -> Resources:
    expects(isinstance(a, CsrMatrix), "expects a CsrMatrix adjacency")
    expects(a.shape[0] == a.shape[1], "adjacency must be square")
    if res is not None:
        res.check_holds(a.device, "the adjacency")
    return res or Resources(device=a.device)


def partition(a: CsrMatrix, n_clusters: int, eigen_cfg: EigenSolverConfig | None = None,
              cluster_cfg: ClusterSolverConfig | None = None, res: Resources | None = None,
              v0=None) -> SpectralOutput:
    """Min-balanced-cut spectral partition (reference: spectral/partition.cuh:49):
    the k smallest eigenpairs of the graph Laplacian, whitened, then k-means
    on the embedding's rows; on the adjacency's device."""
    res = _checked(a, res)
    eigen_cfg = eigen_cfg or EigenSolverConfig(n_eig_vecs=n_clusters)
    cluster_cfg = cluster_cfg or ClusterSolverConfig()
    w, v, n_restarts = eigsh(laplacian(a), k=eigen_cfg.n_eig_vecs, which="SA",
                             ncv=eigen_cfg.restart_iter, max_iter=eigen_cfg.max_iter,
                             tol=eigen_cfg.tol, seed=eigen_cfg.seed, v0=v0)
    labels, inertia = _cluster(_whiten(v), n_clusters, cluster_cfg, res)
    return SpectralOutput(labels, w, v, int(n_restarts), inertia)


def _degree_vector(a: CsrMatrix) -> torch.Tensor:
    """Weighted degrees: the adjacency's row sums."""
    return row_reduce(a, a.data)


def modularity_maximization(a: CsrMatrix, n_clusters: int,
                            eigen_cfg: EigenSolverConfig | None = None,
                            cluster_cfg: ClusterSolverConfig | None = None,
                            res: Resources | None = None, v0=None) -> SpectralOutput:
    """Spectral modularity clustering (reference:
    spectral/modularity_maximization.cuh:36): the k largest eigenpairs of
    B = A - d dᵀ / 2m, whitened, each row scaled to unit norm, then k-means;
    on the adjacency's device."""
    res = _checked(a, res)
    eigen_cfg = eigen_cfg or EigenSolverConfig(n_eig_vecs=n_clusters)
    cluster_cfg = cluster_cfg or ClusterSolverConfig()
    d = _degree_vector(a)
    two_m = torch.clamp_min(d.sum(), 1e-30)

    def b_matvec(x):
        # modularity_matrix_t::mv (spectral/matrix_wrappers.hpp): A x - d (d.x) / 2m
        return spmv(a, x) - d * (torch.dot(d, x) / two_m)

    w, v, n_restarts = eigsh(b_matvec, n=a.shape[0], k=eigen_cfg.n_eig_vecs, which="LA",
                             ncv=eigen_cfg.restart_iter, max_iter=eigen_cfg.max_iter,
                             tol=eigen_cfg.tol, seed=eigen_cfg.seed, v0=v0, res=res)
    emb = _whiten(v)
    # scale_obs (spectral_util.cuh): each observation to unit norm
    emb = emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-30)
    labels, inertia = _cluster(emb, n_clusters, cluster_cfg, res)
    return SpectralOutput(labels, w, v, int(n_restarts), inertia)


def _one_hot(a: CsrMatrix, labels, n_clusters: int):
    labels = (labels if isinstance(labels, torch.Tensor)
              else torch.from_numpy(np.array(labels, dtype=np.int64)))
    labels = labels.to(device=a.device, dtype=torch.int64)
    return torch.nn.functional.one_hot(labels, n_clusters).to(a.data.dtype)


def analyze_partition(a: CsrMatrix, n_clusters: int, labels) -> tuple:
    """(edge_cut, cost) of a partition (reference: spectral/partition.cuh:81;
    detail/partition.hpp:81): with x_i a cluster's indicator, cut_i =
    x_iᵀ L x_i, cost = Σ cut_i / |cluster_i|, edge_cut = Σ cut_i / 2. All
    clusters in one batch: one spmm of the (n, k) indicators."""
    x = _one_hot(a, labels, n_clusters)
    cuts = (x * spmm(laplacian(a), x)).sum(0)
    sizes = x.sum(0)
    nonempty = sizes > 0
    zero = torch.zeros_like(cuts)
    cost = torch.where(nonempty, cuts / torch.clamp_min(sizes, 1.0), zero).sum()
    edge_cut = torch.where(nonempty, cuts, zero).sum() / 2.0
    return edge_cut, cost


def analyze_modularity(a: CsrMatrix, n_clusters: int, labels) -> torch.Tensor:
    """Modularity of a clustering (reference:
    spectral/modularity_maximization.cuh:73): Σ_i x_iᵀ B x_i over 2m."""
    d = _degree_vector(a)
    two_m = torch.clamp_min(d.sum(), 1e-30)
    x = _one_hot(a, labels, n_clusters)
    quad_a = (x * spmm(a, x)).sum(0)
    dx = d @ x
    return (quad_a - dx * dx / two_m).sum() / two_m
