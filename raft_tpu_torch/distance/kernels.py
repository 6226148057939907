"""Gram (kernel) matrices: linear, polynomial, tanh and RBF.

Counterpart of raft_tpu/distance/kernels.py (reference:
distance/detail/kernels/{gram_matrix.cuh, kernel_matrices.cuh,
kernel_factory.cuh}). One full-float32 product ``x·yᵀ`` and the kernel's
elementwise epilogue. Inputs are dense, or a ``sparse.CsrMatrix``, which
is densified first, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from ..core.errors import expects, fail
from ..core.resources import Resources, default_resources
from .pairwise import full_f32

__all__ = ["KernelType", "KernelParams", "gram_matrix", "kernel_factory"]

_f32 = torch.float32


class KernelType(enum.Enum):
    """Mirrors raft::distance::kernels::KernelType (distance_types.hpp:88)."""

    LINEAR = "linear"
    POLYNOMIAL = "polynomial"
    RBF = "rbf"
    TANH = "tanh"


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Mirrors raft::distance::kernels::KernelParams (distance_types.hpp:98)."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


def _as_dense(x, res: Resources):
    from ..sparse.types import CsrMatrix

    if isinstance(x, CsrMatrix):
        res.check_holds(x.device, "the CSR matrix")
        return x.todense().to(_f32)
    return res.put(x, _f32)


def gram_matrix(params: KernelParams, x, y=None, norm_x=None, norm_y=None,
                res: Resources | None = None):
    """The (m, n) Gram matrix K(x_i, y_j) on the handle's device (reference:
    GramMatrixBase::evaluate, kernel_matrices.cuh). ``y=None`` means
    K(x, x). ``norm_x`` / ``norm_y``: optional squared L2 row norms for the
    RBF expansion."""
    res = res or default_resources()
    xd = _as_dense(x, res)
    yd = xd if y is None else _as_dense(y, res)
    expects(xd.ndim == 2 and yd.ndim == 2, "gram inputs must be 2-D")
    expects(xd.shape[1] == yd.shape[1], "feature dims must match")
    with full_f32():
        dot = xd @ yd.T
    k = params.kernel
    if k == KernelType.LINEAR:
        return dot
    if k == KernelType.POLYNOMIAL:
        # (gain·K + offset)^degree
        return torch.pow(params.gamma * dot + params.coef0, params.degree)
    if k == KernelType.TANH:
        # tanh(gain·K + offset)
        return torch.tanh(params.gamma * dot + params.coef0)
    if k == KernelType.RBF:
        # exp(-gain·(‖x‖² + ‖y‖² − 2·K))
        nx = (xd * xd).sum(dim=1) if norm_x is None else res.put(norm_x, _f32)
        if y is None and norm_y is None:
            ny = nx
        else:
            ny = (yd * yd).sum(dim=1) if norm_y is None else res.put(norm_y, _f32)
        d2 = torch.clamp_min(nx[:, None] + ny[None, :] - 2.0 * dot, 0.0)
        return torch.exp(-params.gamma * d2)
    fail("Kernel not implemented: %s", k)


def kernel_factory(params: KernelParams):
    """``f(x, y=None, norm_x=None, norm_y=None, res=None) -> K`` for
    ``params`` (reference: KernelFactory::create, kernel_factory.cuh:29)."""

    def evaluate(x, y=None, norm_x=None, norm_y=None, res: Resources | None = None):
        return gram_matrix(params, x, y, norm_x=norm_x, norm_y=norm_y, res=res)

    return evaluate
