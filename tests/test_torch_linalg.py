"""raft_tpu_torch.linalg against raft_tpu.linalg on the CPU.

The same numpy inputs, made from a seed, go through both packages. Products,
maps, norms and sums by key agree within rtol 1e-5 / atol 1e-6;
eigenvalues and singular values within rtol 1e-4, vectors up to sign
(|cos| >= 1 - 1e-4); least squares on full-rank, rank-deficient and wide
systems within rtol 1e-4 / atol 1e-5 (both are the minimum-norm SVD
solution).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import linalg as jl
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core import RaftError, Resources

CPU = Resources(device="cpu")
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


def cos_ok(got, want, axis=0):
    """Columns (axis=0) or rows (axis=1) equal up to sign."""
    g, w = _np(got).astype(np.float64), np.asarray(want).astype(np.float64)
    dots = np.abs((g * w).sum(axis)) / (np.linalg.norm(g, axis=axis) * np.linalg.norm(w, axis=axis))
    assert dots.min() >= 1 - 1e-4, dots.min()


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, True), (True, False)])
def test_gemm(rng, ta, tb):
    a = rng.standard_normal((7, 5) if ta else (5, 7)).astype(np.float32)
    b = rng.standard_normal((3, 7) if tb else (7, 3)).astype(np.float32)
    c = rng.standard_normal((5, 3)).astype(np.float32)
    kw = dict(alpha=2.0, beta=0.5, trans_a=ta, trans_b=tb)
    close(tl.gemm(a, b, c, res=CPU, **kw), jl.gemm(a, b, c, **kw))


def test_gemm_bf16_returns_its_type(rng):
    a = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32)).bfloat16()
    got = tl.gemm(a, b, res=CPU)
    assert got.dtype == torch.bfloat16
    want = jl.gemm(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                   jnp.asarray(b.float().numpy(), jnp.bfloat16))
    close(got.float(), np.asarray(want, np.float32))


@pytest.mark.parametrize("trans", [False, True])
def test_gemv_axpy_dot_transpose(rng, trans):
    a = rng.standard_normal((4, 6)).astype(np.float32)
    x = rng.standard_normal(4 if trans else 6).astype(np.float32)
    y = rng.standard_normal(6 if trans else 4).astype(np.float32)
    close(tl.gemv(a, x, y, alpha=1.5, beta=-2.0, trans=trans, res=CPU),
          jl.gemv(a, x, y, alpha=1.5, beta=-2.0, trans=trans))
    close(tl.axpy(2.0, a, a * 3, res=CPU), jl.axpy(2.0, a, a * 3))
    close(tl.dot(a, a[::-1].copy(), res=CPU), jl.dot(a, a[::-1].copy()))
    t = tl.transpose(a, res=CPU)
    assert t.is_contiguous()
    close(t, jl.transpose(a))


def test_maps_and_eltwise(rng):
    x = rng.random((5, 6)).astype(np.float32) + 0.5
    y = rng.random((5, 6)).astype(np.float32) + 0.5
    z = rng.random((5, 6)).astype(np.float32)
    close(tl.map(lambda a, b: a * b + 1, x, y, res=CPU), jl.map(lambda a, b: a * b + 1, x, y))
    close(tl.ternary_op(lambda a, b, c: a * b - c, x, y, z, res=CPU),
          jl.ternary_op(lambda a, b, c: a * b - c, x, y, z))
    close(tl.map_reduce(torch.square, torch.sum, x, res=CPU),
          jl.map_reduce(jnp.square, jnp.sum, x))
    for name in ("eltwise_add", "eltwise_sub", "eltwise_multiply", "eltwise_divide"):
        close(getattr(tl, name)(x, y, res=CPU), getattr(jl, name)(x, y))
    close(tl.power(x, 2.5, res=CPU), jl.power(x, 2.5))
    close(tl.sqrt(x, res=CPU), jl.sqrt(x))


@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_takes_dim(rng, axis):
    m = rng.standard_normal((4, 5)).astype(np.float32)
    close(tl.reduce(m, axis=axis, main_op=torch.square, final_op=torch.sqrt, res=CPU),
          jl.reduce(m, axis=axis, main_op=jnp.square, final_op=jnp.sqrt))
    close(tl.reduce(m, axis=axis, res=CPU), jl.reduce(m, axis=axis))
    close(tl.reduce(m, axis=axis, op=torch.amax, res=CPU), jl.reduce(m, axis=axis, op=jnp.max))


@pytest.mark.parametrize("kind", ["l1", "l2", "linf"])
def test_norms_and_normalize(rng, kind):
    m = rng.standard_normal((6, 8)).astype(np.float32)
    m[2] = 0.0                                    # a zero row: normalize's eps
    for sq in (True, False):
        close(tl.row_norm(m, kind, sqrt=sq, res=CPU), jl.row_norm(m, kind, sqrt=sq))
        close(tl.col_norm(m, kind, sqrt=sq, res=CPU), jl.col_norm(m, kind, sqrt=sq))
    close(tl.normalize(m, kind, res=CPU), jl.normalize(m, kind))
    with pytest.raises(RaftError, match="unknown norm type"):
        tl.norm(m, "l3", res=CPU)


@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_rows_and_cols_by_key(rng, weighted):
    m = rng.standard_normal((300, 8)).astype(np.float32)
    keys = rng.integers(0, 12, 300).astype(np.int32)
    keys[::17] = 12                               # outside [0, n_keys): adds nothing
    w = rng.random(300).astype(np.float32) if weighted else None
    close(tl.reduce_rows_by_key(m, keys, 12, weights=w, res=CPU),
          jl.reduce_rows_by_key(m, keys, 12, weights=w), atol=1e-5)
    ck = rng.integers(0, 3, 8).astype(np.int32)
    close(tl.reduce_cols_by_key(m, ck, 3, res=CPU), jl.reduce_cols_by_key(m, ck, 3))


def test_mse_and_matrix_vector_op(rng):
    a = rng.standard_normal((5, 4)).astype(np.float32)
    b = rng.standard_normal((5, 4)).astype(np.float32)
    close(tl.mean_squared_error(a, b, 0.5, res=CPU), jl.mean_squared_error(a, b, 0.5))
    v4, v5 = np.arange(4, dtype=np.float32), np.arange(5, dtype=np.float32)
    add = lambda x, y: x + y                       # noqa: E731
    close(tl.matrix_vector_op(a, v4, add, res=CPU), jl.matrix_vector_op(a, v4, add))
    close(tl.matrix_vector_op(a, v5, add, along_rows=False, res=CPU),
          jl.matrix_vector_op(a, v5, add, along_rows=False))
    with pytest.raises(RaftError, match="len n_cols"):
        tl.matrix_vector_op(a, v5, add, res=CPU)
    with pytest.raises(RaftError, match="len n_rows"):
        tl.matrix_vector_op(a, v4, add, along_rows=False, res=CPU)


def test_eigh_qr_svd(rng):
    a = rng.standard_normal((12, 12)).astype(np.float32)
    sym = a @ a.T
    w, v = tl.eigh(sym, res=CPU)
    jw, jv = jl.eigh(sym)
    close(w, jw, rtol=1e-4, atol=1e-4)
    cos_ok(v, jv)
    assert tl.eig_dc is tl.eigh
    t = rng.standard_normal((20, 6)).astype(np.float32)
    q, r = tl.qr(t, res=CPU)
    jq, jr = jl.qr(t)
    assert tuple(q.shape) == (20, 6) and tuple(r.shape) == (6, 6)
    cos_ok(q, jq)
    close(q @ r, t, rtol=1e-4, atol=1e-5)
    for full in (False, True):
        u, s, vt = tl.svd(t, full_matrices=full, res=CPU)
        ju, js, jvt = jl.svd(t, full_matrices=full)
        assert u.shape == ju.shape and vt.shape == jvt.shape
        close(s, js, rtol=1e-4, atol=1e-5)
        cos_ok(u[:, :6], np.asarray(ju)[:, :6])
        cos_ok(vt, jvt, axis=1)


def test_rsvd_of_a_low_rank_matrix(rng):
    """Rank 6 plus no noise: both sketches recover the exact top 6."""
    a = (rng.standard_normal((200, 6)) * np.array([9, 7, 5, 3, 2, 1])) @ rng.standard_normal((6, 40))
    a = a.astype(np.float32)
    u, s, vt = tl.rsvd(a, 6, seed=3, res=CPU)
    ju, js, jvt = jl.rsvd(a, 6, seed=3)
    assert tuple(u.shape) == (200, 6) and tuple(vt.shape) == (6, 40)
    close(s, js, rtol=1e-4, atol=1e-4)
    cos_ok(u, ju)
    cos_ok(vt, jvt, axis=1)


@pytest.mark.parametrize("case", ["tall", "rank_deficient", "wide", "vector_b"])
def test_lstsq_is_jax_minimum_norm_solution(rng, case):
    if case == "rank_deficient":
        a = rng.standard_normal((30, 3)) @ rng.standard_normal((3, 8))   # rank 3 of 8
    elif case == "wide":
        a = rng.standard_normal((6, 15))
    else:
        a = rng.standard_normal((30, 8))
    a = a.astype(np.float32)
    b = rng.standard_normal(a.shape[0] if case == "vector_b" else (a.shape[0], 2)).astype(np.float32)
    got, want = tl.lstsq(a, b, res=CPU), jl.lstsq(a, b)
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lower", [True, False])
def test_cholesky_r1_update(rng, lower):
    n = 10
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = g @ g.T + n * np.eye(n, dtype=np.float32)
    l = np.linalg.cholesky(a).astype(np.float32)
    l = l if lower else l.T.copy()
    x = rng.standard_normal(n).astype(np.float32)
    got = tl.cholesky_r1_update(l, x, uplo_lower=lower, res=CPU)
    close(got, jl.cholesky_r1_update(l, x, uplo_lower=lower), rtol=1e-5, atol=1e-5)
    lg = got.numpy().astype(np.float64)
    lg = lg if lower else lg.T
    np.testing.assert_allclose(lg @ lg.T, a + np.outer(x, x), rtol=1e-4, atol=1e-4)
    with pytest.raises(RaftError, match=r"L must be \(n,n\)"):
        tl.cholesky_r1_update(l, x[:5], res=CPU)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RaftError, match="CUDA"):
        tl.gemm(np.eye(2, dtype=np.float32), np.eye(2, dtype=np.float32))
