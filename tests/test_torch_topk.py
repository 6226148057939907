"""raft_tpu_torch.ops.topk against raft_tpu.ops.topk.topk_pallas.

The same seeded numpy matrices, with planted ties and ±inf, go through the
Pallas selector in interpret mode and through the port's plain version (the
CPU route of ``topk``): values and indices must be exactly equal. Rows with
NaN, which the Pallas kernel leaves undefined, are held against
``lax.top_k`` (the JAX package's ``select_k_impl(impl="xla")``).
"""

import numpy as np
import pytest
import torch

import importlib

import jax.numpy as jnp
from jax import lax

from raft_tpu.ops.topk import topk_pallas
from raft_tpu_torch.ops.topk import TOPK_MAX_K, top_k_lowest_index, topk, topk_plain

# the package re-exports the function select_k under the module's name
jax_sk = importlib.import_module("raft_tpu.matrix.select_k")


def _matrix(seed, m=6, n=700):
    rng = np.random.default_rng(seed)
    x = rng.random((m, n)).astype(np.float32)
    x[0, ::3] = 0.25                              # heavy ties
    x[1] = rng.integers(0, 12, n).astype(np.float32)
    x[2, 5:] = np.inf                             # fewer than k finite
    x[3, ::2] = -np.inf
    x[4, :40] = 3.2e38                            # clamps to 2.9e38
    x[4, 40:80] = -np.inf
    x[5, 100:130] = -0.0
    x[5, 130:160] = 0.0
    return x


@pytest.mark.parametrize("k,select_min", [(5, True), (5, False), (64, False),
                                          (100, True)])
def test_plain_matches_pallas(k, select_min):
    x = _matrix(k)
    jv, ji = topk_pallas(jnp.asarray(x), k, select_min=select_min, blk=256,
                         interpret=True)
    tv, ti = topk(torch.from_numpy(x), k, select_min=select_min)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_types_rank_as_float32(dtype):
    x = torch.from_numpy(_matrix(3)[:, :300]).to(dtype)
    v, i = topk_plain(x, 7, select_min=True)
    _, ref = top_k_lowest_index(-torch.clamp(x.float(), -2.9e38, 2.9e38), 7)
    assert v.dtype == dtype and torch.equal(i.long(), ref)
    assert torch.equal(v, torch.gather(x, 1, ref))


def test_top_k_lowest_index_ties_and_types():
    v = torch.tensor([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0]], dtype=torch.int32)
    vals, idx = top_k_lowest_index(v, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]] and vals.tolist() == [[3, 3, 3], [0, 0, 0]]
    f = torch.tensor([[0.5, -0.0, 0.0, float("inf"), 0.5]], dtype=torch.float64)
    assert top_k_lowest_index(f, 4)[1].tolist() == [[3, 0, 4, 1]]


def test_k_limits():
    from raft_tpu_torch.core import RaftError

    with pytest.raises(RaftError):
        topk(torch.zeros((2, 300)), TOPK_MAX_K + 1)
    with pytest.raises(RaftError):
        topk(torch.zeros((2, 300), dtype=torch.int32), 4)


def _nan_rows(seed, n=600):
    """Rows with NaN of both signs beside ±inf and ties (no -0 and no value
    past the ±2.9e38 clamp, where the kernel's contract and lax.top_k's
    total order part)."""
    rng = np.random.default_rng(seed)
    x = rng.random((5, n)).astype(np.float32)
    nan = np.float32(np.nan)
    x[0, ::7] = nan
    x[1, ::5] = -nan
    x[1, 3::11] = np.inf
    x[2, ::3] = nan
    x[2, 1::3] = -nan
    x[2, 2::9] = -np.inf
    x[3] = nan
    x[4, :50] = 0.5
    x[4, 50:60] = nan
    x[4, 60:70] = -np.inf
    return x


def test_issue_row_ranks_nan_as_lax_top_k():
    x = np.array([[1, np.nan, 0.5, -np.inf, 2]], np.float32)
    _, i = topk_plain(torch.from_numpy(x), 3, select_min=False)
    assert i.tolist() == [[1, 4, 0]]
    assert np.asarray(lax.top_k(jnp.asarray(x), 3)[1]).tolist() == [[1, 4, 0]]


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 9, 64])
def test_nan_rows_match_lax_top_k(k, select_min):
    """NaN ranks by its bits, +NaN above +inf and -NaN below -inf: the
    plain version (the kernel's contract on the card) and lax.top_k, through
    the JAX package's select_k_impl(impl="xla"), give the same ids and the
    same value bits."""
    x = _nan_rows(k)
    jv, ji = jax_sk.select_k_impl(jnp.asarray(x), None, k, select_min, impl="xla")
    tv, ti = topk_plain(torch.from_numpy(x), k, select_min=select_min)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_nan_rows_rank_as_float32(dtype):
    x = torch.from_numpy(_nan_rows(5)).to(dtype)
    v, i = topk_plain(x, 9, select_min=False)
    _, ref = topk_plain(x.to(torch.float32), 9, select_min=False)
    assert torch.equal(i, ref)
    assert torch.equal(v.view(torch.int16), torch.gather(x, 1, ref.long()).view(torch.int16))


@pytest.mark.parametrize("select_min", [True, False])
def test_wrapper_payload_matches_pallas_select(select_min):
    """topk's one-call interface (values, and payload ids when given) on a
    CPU tensor against the JAX select_k_impl(impl="pallas") in interpret
    mode, with int32 and int64 payloads."""
    x = _matrix(11, m=6, n=500)
    ids = np.random.default_rng(12).permutation(x.size).reshape(x.shape).astype(np.int32)
    jv, ji = jax_sk.select_k_impl(jnp.asarray(x), jnp.asarray(ids), 10, select_min,
                                  impl="pallas")
    for payload in (torch.from_numpy(ids), torch.from_numpy(ids).long()):
        tv, ti = topk(torch.from_numpy(x), 10, select_min=select_min, in_idx=payload)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tv, tc = topk(torch.from_numpy(x), 10, select_min=select_min)
    np.testing.assert_array_equal(np.take_along_axis(ids, tc.numpy().astype(np.int64), 1),
                                  np.asarray(ji))


def test_payload_checks():
    from raft_tpu_torch.core import RaftError

    x = torch.zeros((2, 300))
    with pytest.raises(RaftError):
        topk(x, 4, in_idx=torch.zeros((2, 299), dtype=torch.int32))
    with pytest.raises(RaftError):
        topk(x, 4, in_idx=torch.zeros((2, 300)))
