"""Thick-restart Lanczos eigensolver.

Counterpart of raft_tpu/solver/lanczos.py (reference: raft/sparse/solver/
lanczos.cuh computeSmallestEigenvectors :68 / computeLargestEigenvectors
:132). The JAX design: thick-restart Lanczos with full two-pass
reorthogonalisation (each step two (n, m) GEMVs, ``Vᵀw`` and ``V h``, in
full float32), the projected (m, m) system solved with
``torch.linalg.eigh`` on the device, k Ritz vectors locked at each restart.

The JAX restart loop is one ``lax.while_loop``; here it is a host loop with
one convergence read-back a restart, not a step: a breakdown (an invariant
subspace) swaps in a fresh random direction on the device by a select, as
the JAX body does. Random numbers (the start vector without ``v0=``, the
breakdown directions) come from a ``torch.Generator`` seeded with ``seed``
on the operator's device, so they are not the JAX package's; given the
same ``v0`` the two solvers agree to their tolerance.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32
from ..sparse.types import CsrMatrix

__all__ = ["eigsh", "compute_smallest_eigenvectors", "compute_largest_eigenvectors"]

_f32 = torch.float32


def _thick_restart(matvec: Callable, v0: torch.Tensor, k: int, m: int,
                   max_restarts: int, tol: float, g: torch.Generator):
    """The restart loop: (eigenvalues (k,), eigenvectors (n, k), restarts).

    V is (n, m+1) with unbuilt columns zero, so ``h = Vᵀw; w -= V h``
    restricts itself to the built basis; H is the (m+1, m) projected
    matrix, arrow-shaped after a restart (the locked Ritz values on its
    diagonal, the coupling in row k).
    """
    n = v0.shape[0]
    dev, dtype = v0.device, v0.dtype
    eps = 1e-30
    V = torch.zeros((n, m + 1), dtype=dtype, device=dev)
    V[:, 0] = v0
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    j0 = 0
    restarts = 0
    while restarts < max_restarts:
        for j in range(j0, m):
            w = matvec(V[:, j])
            h1 = V.T @ w
            w = w - V @ h1
            h2 = V.T @ w
            w = w - V @ h2
            h = h1 + h2
            beta = torch.linalg.vector_norm(w)
            # breakdown: go on with a fresh orthonormalised random direction
            rnd = torch.randn((n,), generator=g, dtype=dtype, device=dev)
            rnd = rnd - V @ (V.T @ rnd)
            rnd = rnd / torch.clamp_min(torch.linalg.vector_norm(rnd), eps)
            ok = beta > 1e-6 * torch.clamp_min(torch.linalg.vector_norm(h), 1.0)
            V[:, j + 1] = torch.where(ok, w / torch.clamp_min(beta, eps), rnd)
            h[j + 1] = torch.where(ok, beta, 0.0)
            H[:, j] = h
        t = H[:m, :m]
        theta, s = torch.linalg.eigh((t + t.T) * 0.5)       # ascending
        res = torch.abs(H[m, m - 1] * s[m - 1, :])
        scale = torch.clamp_min(torch.abs(theta[:k]).max(), 1.0)
        converged = res[:k].max() < tol * scale
        # thick restart: lock k Ritz vectors, keep the residual vector
        Vn = torch.zeros_like(V)
        Vn[:, :k] = V[:, :m] @ s[:, :k]
        Vn[:, k] = V[:, m]
        Hn = torch.zeros_like(H)
        ar = torch.arange(k, device=dev)
        Hn[ar, ar] = theta[:k]
        Hn[k, :k] = H[m, m - 1] * s[m - 1, :k]
        V, H, j0 = Vn, Hn, k
        restarts += 1
        if bool(converged):
            break
    return torch.diagonal(H)[:k], V[:, :k], restarts


def _operator(a, n, res: Resources | None):
    """(matvec, n, device) of a CsrMatrix, a dense matrix or a callable."""
    if isinstance(a, CsrMatrix):
        from ..sparse.linalg import spmv

        expects(a.shape[0] == a.shape[1], "matrix must be square")
        if res is not None:
            res.check_holds(a.device, "the matrix")
        return (lambda x: spmv(a, x)), a.shape[0], a.device
    if callable(a):
        expects(n is not None, "n is required for a callable operator")
        return a, int(n), (res or default_resources()).torch_device
    if isinstance(a, torch.Tensor):
        if res is not None:
            res.check_holds(a.device, "the matrix")
        arr = a.to(_f32)
    else:
        arr = (res or default_resources()).put(np.asarray(a), _f32)
    expects(arr.ndim == 2 and arr.shape[0] == arr.shape[1], "matrix must be square")
    return (lambda x: arr @ x), arr.shape[0], arr.device


def eigsh(a, k: int = 6, which: str = "SA", n: int | None = None, ncv: int | None = None,
          max_iter: int = 4000, tol: float = 1e-6, seed: int = 42, v0=None,
          res: Resources | None = None):
    """k extremal eigenpairs of a symmetric operator.

    ``a`` is a :class:`CsrMatrix`, a dense (n, n) matrix or a matvec callable
    (pass ``n``). ``which``: "SA" (smallest algebraic; the reference's
    computeSmallestEigenvectors) or "LA" (largest, solved on -A). A
    CsrMatrix or a tensor runs on its own device; a numpy matrix and a
    callable's vectors live on ``res``'s (``cuda`` by default).

    Returns (eigenvalues (k,), eigenvectors (n, k), restarts), eigenvalues
    ascending, as scipy.sparse.linalg.eigsh.
    """
    matvec, n, dev = _operator(a, n, res)
    expects(1 <= k < n, "need 1 <= k < n")
    expects(which in ("SA", "LA"), "which must be 'SA' or 'LA'")
    m = ncv if ncv is not None else min(n - 1, max(2 * k + 8, 20))
    m = max(m, k + 2)
    expects(m <= n, "ncv must be <= n (matrix too small for this k/ncv)")
    max_restarts = max(1, math.ceil(max(max_iter - m, 0) / max(m - k, 1)) + 1)
    op = matvec if which == "SA" else (lambda x: -matvec(x))
    g = torch.Generator(device=dev).manual_seed(int(seed))
    if v0 is None:
        v0 = torch.randn((n,), generator=g, dtype=_f32, device=dev)
    else:
        v0 = (v0.to(dev, _f32) if isinstance(v0, torch.Tensor)
              else torch.as_tensor(np.array(v0, dtype=np.float32), device=dev))
    v0 = v0 / torch.linalg.vector_norm(v0)
    with full_f32():
        w, v, restarts = _thick_restart(op, v0, k, m, max_restarts, float(tol), g)
    if which == "LA":
        w, v = -torch.flip(w, [0]), torch.flip(v, [1])
    return w, v, restarts


def compute_smallest_eigenvectors(a, k: int, max_iter: int = 4000,
                                  restart_iter: int | None = None, tol: float = 1e-6,
                                  seed: int = 42, v0=None, res: Resources | None = None):
    """Reference: raft/sparse/solver/lanczos.cuh:68."""
    return eigsh(a, k=k, which="SA", ncv=restart_iter, max_iter=max_iter, tol=tol,
                 seed=seed, v0=v0, res=res)


def compute_largest_eigenvectors(a, k: int, max_iter: int = 4000,
                                 restart_iter: int | None = None, tol: float = 1e-6,
                                 seed: int = 42, v0=None, res: Resources | None = None):
    """Reference: raft/sparse/solver/lanczos.cuh:132."""
    return eigsh(a, k=k, which="LA", ncv=restart_iter, max_iter=max_iter, tol=tol,
                 seed=seed, v0=v0, res=res)
