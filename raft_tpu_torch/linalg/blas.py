"""BLAS-style dense operations.

Counterpart of raft_tpu/linalg/blas.py (reference: linalg/gemm.cuh,
gemv.cuh, axpy.cuh, dot.cuh, transpose.cuh). Products accumulate in float32
with TF32 off (the JAX module's ``Precision.HIGHEST``) and come back in the
first operand's type.
"""

from __future__ import annotations

import torch

from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32

__all__ = ["gemm", "gemv", "axpy", "dot", "transpose"]


def _mm(a, b):
    with full_f32():
        return a.to(torch.float32) @ b.to(torch.float32)


def gemm(a, b, c=None, alpha: float = 1.0, beta: float = 0.0, trans_a: bool = False,
         trans_b: bool = False, res: Resources | None = None):
    """alpha·op(A)·op(B) + beta·C (reference: linalg/gemm.cuh)."""
    res = res or default_resources()
    a, b = res.put(a), res.put(b)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    out = alpha * _mm(a, b)
    if c is not None and beta != 0.0:
        out = out + beta * res.put(c)
    return out.to(a.dtype)


def gemv(a, x, y=None, alpha: float = 1.0, beta: float = 0.0, trans: bool = False,
         res: Resources | None = None):
    """alpha·op(A)·x + beta·y (reference: linalg/gemv.cuh)."""
    res = res or default_resources()
    a, x = res.put(a), res.put(x)
    if trans:
        a = a.T
    out = alpha * _mm(a, x[:, None])[:, 0]
    if y is not None and beta != 0.0:
        out = out + beta * res.put(y)
    return out.to(a.dtype)


def axpy(alpha: float, x, y, res: Resources | None = None):
    """y + alpha·x (reference: linalg/axpy.cuh)."""
    res = res or default_resources()
    return res.put(y) + alpha * res.put(x)


def dot(x, y, res: Resources | None = None):
    """Inner product of the flattened inputs (reference: linalg/dot.cuh;
    ``vdot``)."""
    res = res or default_resources()
    return torch.vdot(res.put(x).flatten(), res.put(y).flatten())


def transpose(a, res: Resources | None = None):
    """Materialized transpose (reference: linalg/transpose.cuh)."""
    res = res or default_resources()
    return res.put(a).T.contiguous()
