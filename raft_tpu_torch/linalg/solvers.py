"""Dense decompositions and solvers.

Counterpart of raft_tpu/linalg/solvers.py (reference: linalg/eig.cuh,
qr.cuh, svd.cuh, rsvd.cuh, lstsq.cuh, cholesky_r1_update.cuh). The
factorizations are ``torch.linalg``'s (cuSOLVER on a card); every float32
product runs with TF32 off.

On a card every SVD runs cuSOLVER's ``gesvd`` (QR iteration): torch's
default there, the Jacobi ``gesvdj``, read singular values 1.5e-4 (relative
to the largest) off float64 at 4,096 x 1,024 on an H100, where float32
should hold ~1e-6.

``lstsq`` is the JAX package's SVD solve, not ``torch.linalg.lstsq``: on
CUDA that has only the ``gels`` driver, which assumes a tall matrix of full
rank, while ``jnp.linalg.lstsq`` gives the minimum-norm solution for any
shape and rank, cutting singular values below ``eps·max(m, n)·s_max``.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32
from ..random.rng import as_key

__all__ = ["eig_dc", "eigh", "qr", "svd", "rsvd", "lstsq", "cholesky_r1_update"]

_f32 = torch.float32


def eigh(a, res: Resources | None = None):
    """Symmetric eigendecomposition, eigenvalues ascending (reference:
    linalg/eig.cuh eigDC). As ``jnp.linalg.eigh``, the input is symmetrized,
    ``(a + aᵀ) / 2``, before the lower triangle is factorized. Returns
    (eigenvalues, eigenvectors as columns)."""
    a = (res or default_resources()).put(a)
    return torch.linalg.eigh((a + a.T) / 2, UPLO="L")


eig_dc = eigh


def _svd(a, full_matrices=False):
    return torch.linalg.svd(a, full_matrices=full_matrices,
                            driver="gesvd" if a.device.type == "cuda" else None)


def qr(a, res: Resources | None = None):
    """Reduced QR (reference: linalg/qr.cuh qrGetQR). Returns (Q, R)."""
    return torch.linalg.qr((res or default_resources()).put(a), mode="reduced")


def svd(a, full_matrices: bool = False, res: Resources | None = None):
    """SVD (reference: linalg/svd.cuh svdQR). Returns (U, S, Vᵀ)."""
    return _svd((res or default_resources()).put(a), full_matrices)


def rsvd(a, k: int, p: int = 10, n_iter: int = 2, seed=0, res: Resources | None = None):
    """Randomized truncated SVD (reference: linalg/rsvd.cuh): the
    Halko-Martinsson-Tropp sketch of ``k + p`` Gaussian columns, ``n_iter``
    power iterations with a QR after each product, an exact SVD of the
    small projection. Returns (U (m, k), S (k,), Vt (k, n))."""
    res = res or default_resources()
    a = res.put(a, _f32)
    m, n = a.shape
    l = min(k + p, n)
    omega = torch.randn((n, l), generator=as_key(seed, a.device), device=a.device, dtype=_f32)
    with full_f32():
        q, _ = torch.linalg.qr(a @ omega)
        for _ in range(n_iter):
            q, _ = torch.linalg.qr(a.T @ q)
            q, _ = torch.linalg.qr(a @ q)
        ub, s, vt = _svd(q.T @ a)
        return (q @ ub)[:, :k], s[:k], vt[:k]


def lstsq(a, b, res: Resources | None = None):
    """Least-squares solve of min‖Ax - b‖ (reference: linalg/lstsq.cuh): the
    minimum-norm solution through the SVD, singular values below
    ``eps·max(m, n)·s_max`` dropped, as ``jnp.linalg.lstsq``."""
    res = res or default_resources()
    a = res.put(a, _f32)
    b = res.put(b, _f32)
    expects(a.ndim == 2 and b.shape[0] == a.shape[0],
            "lstsq needs a (m, n) matrix and b with m rows")
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    u, s, vt = _svd(a)
    rcond = torch.finfo(_f32).eps * max(a.shape)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)[:, None]
    with full_f32():
        x = vt.T @ (s_inv * (u.T @ b))
    return x[:, 0] if vec else x


def cholesky_r1_update(l, x, uplo_lower: bool = True, res: Resources | None = None):
    """Rank-1 Cholesky update: given L with A = L·Lᵀ, return L' with
    A + x·xᵀ = L'·L'ᵀ (reference: linalg/cholesky_r1_update.cuh).

    The JAX module's Givens step, one column at a time in a host loop (the
    column order is the algorithm's critical path): with
    r = sqrt(L_kk² + x_k²), c = r / L_kk, s = x_k / L_kk, the column below
    the diagonal becomes (L_ik + s·x_i) / c, L_kk becomes r, and x_i
    becomes c·x_i - s·L'_ik. ``uplo_lower=False`` takes and returns U = Lᵀ.
    """
    res = res or default_resources()
    lm = res.put(l, _f32)
    xv = res.put(x, _f32).clone()
    n = lm.shape[0]
    expects(tuple(lm.shape) == (n, n) and tuple(xv.shape) == (n,), "L must be (n,n), x (n,)")
    lm = (lm if uplo_lower else lm.T).clone()
    for k in range(n):
        lkk, xk = lm[k, k], xv[k]
        r = torch.sqrt(lkk * lkk + xk * xk)
        c, s = r / lkk, xk / lkk
        below = (lm[k + 1:, k] + s * xv[k + 1:]) / c
        lm[k + 1:, k] = below
        lm[k, k] = r
        xv[k + 1:] = c * xv[k + 1:] - s * below
    return lm if uplo_lower else lm.T
