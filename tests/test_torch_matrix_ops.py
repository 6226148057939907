"""raft_tpu_torch.matrix.ops against raft_tpu.matrix.ops: each of the 16
functions on the same numpy inputs (seeded), exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.matrix import ops as jops
from raft_tpu_torch.core import RaftError
from raft_tpu_torch.matrix import ops as tops


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(7, 9)).astype(np.float32)
    a[2, 3] = a[2, 6] = a[2].max() + 1.0          # a tied row maximum
    a[4] = np.round(a[4])                         # ties for the sorts
    return a


def _eq(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape, t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", ["argmax", "argmin", "copy", "upper_triangular",
                                  "lower_triangular", "get_diagonal", "sign_flip"])
def test_unary(m, name):
    _eq(getattr(tops, name)(torch.from_numpy(m)), getattr(jops, name)(jnp.asarray(m)))


def test_gather_and_gather_if(m):
    rows = np.array([3, 0, 6, 3], np.int32)
    mask = np.array([True, False, True, False])
    _eq(tops.gather(m, rows), jops.gather(jnp.asarray(m), jnp.asarray(rows)))
    _eq(tops.gather_if(m, rows, mask, fill_value=-2.5),
        jops.gather_if(jnp.asarray(m), jnp.asarray(rows), jnp.asarray(mask), fill_value=-2.5))


@pytest.mark.parametrize("bounds", [(1, 5), (2, 6, 3, 8), (0, 7, 4)])
def test_slice(m, bounds):
    _eq(tops.slice(torch.from_numpy(m), *bounds), jops.slice(jnp.asarray(m), *bounds))


def test_fill_and_eye():
    _eq(tops.fill((3, 4), 1.5), jops.fill((3, 4), 1.5))
    _eq(tops.fill((2, 2), 7, dtype=torch.int32), jops.fill((2, 2), 7, dtype=jnp.int32))
    _eq(tops.eye(5), jops.eye(5))


@pytest.mark.parametrize("along_rows", [True, False])
def test_linewise_op(m, along_rows):
    vec = np.arange(m.shape[1] if along_rows else m.shape[0], dtype=np.float32) - 2.0
    _eq(tops.linewise_op(m, vec, along_rows, lambda a, b: a * b + 1.0),
        jops.linewise_op(jnp.asarray(m), jnp.asarray(vec), along_rows,
                         lambda a, b: a * b + 1.0))
    with pytest.raises(RaftError, match="len"):
        tops.linewise_op(m, vec[:-1], along_rows, lambda a, b: a + b)


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.bool_])
def test_col_wise_sort(m, ascending, dtype):
    a = (np.abs(m) * 3).astype(dtype) if dtype != np.bool_ else m > 0
    ts, ti = tops.col_wise_sort(torch.from_numpy(a), ascending)
    js, ji = jops.col_wise_sort(jnp.asarray(a), ascending)
    _eq(ts, js)
    _eq(ti, ji)


@pytest.mark.parametrize("along_rows", [True, False])
def test_reverse(m, along_rows):
    _eq(tops.reverse(m, along_rows), jops.reverse(jnp.asarray(m), along_rows))


@pytest.mark.parametrize("shape", [(7, 9), (9, 7)])
def test_set_diagonal(shape):
    a = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    d = np.arange(9, dtype=np.float32)
    _eq(tops.set_diagonal(a, d), jops.set_diagonal(jnp.asarray(a), jnp.asarray(d)))
