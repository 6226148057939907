"""raft_tpu_torch.matrix.select_k against raft_tpu.matrix.select_k.

Seeded numpy inputs go through both on the CPU: float and integer values,
payload indices, ties, and the forced kernel route (the port's ``topk`` on a
CPU tensor runs its plain version; the JAX side runs its Pallas selector in
interpret mode). Everything must agree exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors.brute_force import knn_merge_parts as jax_merge
from raft_tpu_torch.core import Resources
from raft_tpu_torch.matrix.select_k import (select_k, select_k_impl,
                                            set_wide_cols_threshold,
                                            wide_cols_threshold, wide_dispatch_ok)
from raft_tpu_torch.neighbors.brute_force import knn_merge_parts
from raft_tpu_torch.ops.topk import TOPK_MAX_K

# the packages re-export the function select_k under the module's name
jax_sk = importlib.import_module("raft_tpu.matrix.select_k")
sk_mod = importlib.import_module("raft_tpu_torch.matrix.select_k")
CPU = Resources(device="cpu")


def _values(dtype, seed=0, shape=(7, 500)):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = rng.integers(info.min, int(info.max) + 1, shape, dtype=dtype)
        v[0, ::5] = info.min                   # ties at both ends
        v[1, ::7] = info.max
        return v
    v = rng.random(shape).astype(dtype)
    v[0, ::4] = 0.5
    v[2, 10:20] = np.inf
    return v


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.int8])
@pytest.mark.parametrize("select_min", [True, False])
def test_matches_jax(dtype, select_min):
    v = _values(dtype)
    jv, ji = jax_sk.select_k(jnp.asarray(v), 9, select_min=select_min)
    tv, ti = select_k(v, 9, select_min=select_min, res=CPU)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_payload_indices_match_jax():
    v = _values(np.float32, seed=1)
    ids = np.random.default_rng(2).permutation(v.size).reshape(v.shape).astype(np.int32)
    jv, ji = jax_sk.select_k(jnp.asarray(v), 11, indices=jnp.asarray(ids))
    tv, ti = select_k(v, 11, indices=ids, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kernel_route_matches_pallas_route():
    v = _values(np.float32, seed=3)
    ids = np.arange(v.size, dtype=np.int32).reshape(v.shape)[:, ::-1].copy()
    jv, ji = jax_sk.select_k_impl(jnp.asarray(v), jnp.asarray(ids), 12, True,
                                  impl="pallas")
    tv, ti = select_k_impl(torch.from_numpy(v), torch.from_numpy(ids).long(), 12,
                           True, impl="kernel")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_merge_parts_matches_jax():
    rng = np.random.default_rng(4)
    d = np.sort(rng.random((3, 5, 8)).astype(np.float32), axis=2)
    i = rng.integers(0, 1000, (3, 5, 8)).astype(np.int32)
    jd, ji = jax_merge(jnp.asarray(d), jnp.asarray(i), 6)
    td, ti = knn_merge_parts(d, i, 6, res=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_wide_dispatch_rule():
    """The default is the card's measured crossover, 1,024 columns; the
    CAGRA entry pool (16,384) and the IVF-PQ chunk rows (~10k) are above it."""
    assert wide_cols_threshold() == sk_mod.WIDE_SELECT_COLS_DEFAULT == 1024
    assert wide_dispatch_ok(1024, 10, torch.float32, "cuda")
    assert wide_dispatch_ok(1024, 256, torch.bfloat16, torch.device("cuda:0"))
    assert wide_dispatch_ok(16384, 32, torch.float32, "cuda")
    assert not wide_dispatch_ok(1023, 10, torch.float32, "cuda")
    assert not wide_dispatch_ok(1024, 257, torch.float32, "cuda")
    assert not wide_dispatch_ok(1024, 10, torch.int32, "cuda")
    assert not wide_dispatch_ok(1024, 10, torch.float32, "cpu")
    set_wide_cols_threshold(100)
    try:
        assert wide_cols_threshold() == 100
        assert wide_dispatch_ok(100, 5, torch.float16, "cuda")
    finally:
        set_wide_cols_threshold(None)
    assert sk_mod.SELECT_K_DISPATCH_MAX_K == TOPK_MAX_K


def test_cuda_default_raises_without_card():
    from raft_tpu_torch.core import RaftError

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RaftError, match="CUDA"):
        select_k(np.zeros((2, 10), np.float32), 3)


def _special_rows(dtype, seed=6, n=400):
    """NaN of both signs, ±inf and -0 beside +0, in the plain route's rows."""
    rng = np.random.default_rng(seed)
    v = rng.random((6, n)).astype(np.float32)
    nan = np.float32(np.nan)
    v[0, ::6] = nan
    v[0, 1::6] = -nan
    v[1, ::4] = np.inf
    v[1, 1::4] = -np.inf
    v[2, ::3] = -0.0
    v[2, 1::3] = 0.0
    v[3, :200] = -0.0
    v[3, 200:] = 0.0
    v[4] = nan
    v[5, ::2] = -nan
    v[5, 1::5] = -0.0
    v[5, 2::5] = -np.inf
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 7, 150])
def test_plain_route_ranks_special_values_as_lax_top_k(dtype, select_min, k):
    """The plain route ranks as lax.top_k does (NaN by its bits, -0 below
    +0, ±inf at the ends), with the same value bits and payload ids."""
    import ml_dtypes

    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    v = _special_rows(dt)
    ids = np.random.default_rng(7).permutation(v.size).reshape(v.shape).astype(np.int32)
    jv, ji = jax_sk.select_k_impl(jnp.asarray(v), jnp.asarray(ids), k, select_min,
                                  impl="xla")
    tv_in = torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16) if dtype == "bfloat16" \
        else torch.from_numpy(v)
    tv, ti = select_k_impl(tv_in, torch.from_numpy(ids), k, select_min, impl="torch")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    as_int = np.uint16 if dtype == "bfloat16" else np.uint32
    got = tv.view(torch.int16).numpy() if dtype == "bfloat16" else tv.numpy()
    np.testing.assert_array_equal(got.view(as_int), np.asarray(jv).view(as_int))


@pytest.mark.parametrize("payload", [np.int32, np.int64])
def test_kernel_route_payload_types_match_pallas_route(payload):
    """select_k_impl's kernel route is one topk call: values, and the
    payload's ids at the chosen columns, as the JAX pallas route."""
    v = _values(np.float32, seed=8)
    ids = np.random.default_rng(9).integers(0, 1 << 30, v.shape).astype(payload)
    jv, ji = jax_sk.select_k_impl(jnp.asarray(v), jnp.asarray(ids.astype(np.int32)), 20,
                                  False, impl="pallas")
    tv, ti = select_k_impl(torch.from_numpy(v), torch.from_numpy(ids), 20, False,
                           impl="kernel")
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
