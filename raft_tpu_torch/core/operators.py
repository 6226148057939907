"""Composable operator vocabulary on tensors.

Counterpart of raft_tpu/core/operators.py (the reference's host/device
functors, cpp/include/raft/core/operators.hpp: identity / sq / abs / add /
sub / mul / div / min / max / pow, the argmin-style KeyValuePair reductions
and the compose / plug adapters; core/kvp.hpp's KeyValuePair). Each is a
plain function of tensors (or Python scalars, which torch broadcasts), so
they compose into ``map_reduce``-style code; ``KeyValuePair`` is the
(key, value) pair of the fused 1-NN reductions.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

__all__ = [
    "identity_op", "void_op", "sq_op", "abs_op", "cast_op", "key_op", "value_op",
    "add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op", "pow_op",
    "min_op", "max_op", "sqrt_op", "nz_op", "equal_op", "notequal_op",
    "compose_op", "plug_const_op", "KeyValuePair", "argmin_op", "argmax_op",
]


class KeyValuePair(typing.NamedTuple):
    """Reference: raft::KeyValuePair (core/kvp.hpp)."""

    key: typing.Any
    value: typing.Any


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def identity_op(x):
    return x


def void_op(*_args):
    return None


def sq_op(x):
    return x * x


def abs_op(x):
    return torch.abs(_t(x))


def sqrt_op(x):
    return torch.sqrt(_t(x))


def nz_op(x):
    """1 where nonzero (ref: nz_op)."""
    x = _t(x)
    return torch.where(x != 0, 1.0, 0.0).to(torch.float32)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name        # "float32", "int8", ... (numpy-style names)
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"cast_op: no torch dtype for {dtype!r}")
    return out


def cast_op(dtype):
    """Reference: cast_op<T> — returns the casting functor. ``dtype`` is a
    ``torch.dtype`` or a numpy-style name or type ("float32", np.int8)."""
    target = _torch_dtype(dtype)

    def f(x):
        return _t(x).to(target)

    return f


def key_op(kvp: KeyValuePair):
    return kvp.key


def value_op(kvp: KeyValuePair):
    return kvp.value


def add_op(a, b):
    return a + b


def sub_op(a, b):
    return a - b


def mul_op(a, b):
    return a * b


def div_op(a, b):
    return a / b


def div_checkzero_op(a, b):
    """a / b with 0 where b == 0 (ref: div_checkzero_op)."""
    a, b = _t(a), _t(b)
    zero = b == 0
    return torch.where(zero, 0.0, a / torch.where(zero, torch.ones_like(b), b))


def pow_op(a, b):
    return torch.pow(_t(a), b)


def min_op(a, b):
    return torch.minimum(_t(a), _t(b))


def max_op(a, b):
    return torch.maximum(_t(a), _t(b))


def equal_op(a, b):
    return a == b


def notequal_op(a, b):
    return a != b


def argmin_op(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    """KVP reduction keeping the smaller value; on equal values the lower
    key (ref: argmin_op, operators.hpp)."""
    av, bv, ak, bk = _t(a.value), _t(b.value), _t(a.key), _t(b.key)
    take_a = (av < bv) | ((av == bv) & (ak <= bk))
    return KeyValuePair(torch.where(take_a, ak, bk), torch.where(take_a, av, bv))


def argmax_op(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    """KVP reduction keeping the larger value; on equal values the lower key."""
    av, bv, ak, bk = _t(a.value), _t(b.value), _t(a.key), _t(b.key)
    take_a = (av > bv) | ((av == bv) & (ak <= bk))
    return KeyValuePair(torch.where(take_a, ak, bk), torch.where(take_a, av, bv))


def compose_op(*fns):
    """Right-to-left composition (ref: compose_op — outer(inner(...)))."""

    def f(x, *args):
        for fn in reversed(fns[1:]):
            x = fn(x, *args)
            args = ()
        return fns[0](x)

    return f


def plug_const_op(const, op):
    """Bind a constant second operand (ref: plug_const_op)."""

    def f(x):
        return op(x, const)

    return f
