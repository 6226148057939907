"""raft_tpu_torch.ops.fused_knn against raft_tpu.ops.fused_knn.

The same numpy inputs (seeded) go through the JAX wrapper, whose Pallas
kernel runs in interpret mode on the CPU, and through the port, whose CPU
tensors take the kernel's plain version. Float modes are held to the JAX
tests' ``assert_knn_equiv`` rule at rtol=1e-5 (the two sum the products in
different orders, so near-ties may swap); mode s8 sums integers exactly and
must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops.fused_knn import fused_knn as jax_fused_knn
from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain, shapes_eligible
from test_fused_knn import assert_knn_equiv

N, D, M, K = 600, 72, 40, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    x = rng.random((N, D), np.float32)
    q = rng.random((M, D), np.float32)
    keep = rng.random(N) < 0.5
    xi = rng.integers(-128, 128, (N, D), dtype=np.int8)
    qi = rng.integers(-128, 128, (M, D), dtype=np.int8)
    return x, q, keep, xi, qi


def _both(x, q, k, **kw):
    jkw = dict(kw)
    if "keep_mask" in jkw:
        jkw["keep_mask"] = jnp.asarray(jkw["keep_mask"])
    jd, ji = jax_fused_knn(jnp.asarray(x), jnp.asarray(q), k, interpret=True,
                           nblk=256, **jkw)
    td, ti = fused_knn(torch.from_numpy(x), torch.from_numpy(q), k, **kw)
    return (td.numpy(), ti.numpy()), (np.asarray(jd), np.asarray(ji))


@pytest.mark.parametrize("kw", [
    dict(metric="l2", mode="f32"),
    dict(metric="l2", mode="f32", sqrt=True),
    dict(metric="ip", mode="f32"),
    dict(metric="l2", mode="f32x3"),
    dict(metric="l2", mode="bf16"),
    dict(metric="l2", mode="f32", filtered=True),
], ids=["l2", "sqrt", "ip", "f32x3", "bf16", "filter"])
def test_float_modes_match_jax(data, kw):
    x, q, keep, _, _ = data
    kw = dict(kw)
    if kw.pop("filtered", False):
        kw["keep_mask"] = keep
    (td, ti), (jd, ji) = _both(x, q, K, **kw)
    assert td.dtype == np.float32 and ti.dtype == np.int32
    assert_knn_equiv(td, ti, jd, ji, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_s8_exact(data, metric):
    _, _, keep, xi, qi = data
    (td, ti), (jd, ji) = _both(xi, qi, K, metric=metric, mode="s8",
                               keep_mask=keep)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)


def test_underfill_matches_jax(data, check_filter_underfill):
    x, q, _, _, _ = data
    keep = np.zeros(N, bool)
    keep[[3, 50, 599]] = True          # three admissible rows, k = 10
    for metric in ("l2", "ip"):
        (td, ti), (jd, ji) = _both(x, q, K, metric=metric, keep_mask=keep)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-5)
        check_filter_underfill(td, ti, [3, 50, 599], select_min=metric == "l2")


def test_plain_is_the_cpu_route(data):
    x, q, _, _, _ = data
    a = fused_knn(torch.from_numpy(x), torch.from_numpy(q), 64, metric="ip")
    b = fused_knn_plain(torch.from_numpy(x), torch.from_numpy(q), 64, metric="ip")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_contract_checks(data):
    from raft_tpu_torch.core import RaftError

    x, q, _, xi, qi = data
    with pytest.raises(RaftError, match="k in"):
        fused_knn(torch.from_numpy(x), torch.from_numpy(q), 65)
    with pytest.raises(RaftError, match="int8"):
        fused_knn(torch.from_numpy(x), torch.from_numpy(q), 5, mode="s8")
    assert shapes_eligible(4096, 64, 64) and not shapes_eligible(4095, 64, 10)
    assert not shapes_eligible(5000, 63, 10) and not shapes_eligible(5000, 64, 65)
