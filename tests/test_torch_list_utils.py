"""raft_tpu_torch.neighbors._list_utils and .distance.fused_nn against the
JAX package's: list positions, the capacity split and the search-tile plan
are deterministic and must agree exactly; the fused nearest-neighbour
assignment agrees up to near ties."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance import fused_nn as jfnn
from raft_tpu.neighbors import _list_utils as jlu
from raft_tpu_torch.core import Resources
from raft_tpu_torch.distance import fused_nn as tfnn
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import _list_utils as tlu

CPU = Resources(device="cpu")


@pytest.fixture(autouse=True)
def _jax_kernel_route(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FUSED_KNN_INTERPRET", "1")


def _skewed_labels(n=3000, n_lists=20, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.pareto(1.5, n_lists) + 0.05
    return rng.choice(n_lists, n, p=p / p.sum()).astype(np.int32)


def test_list_positions_and_order_split_match_jax():
    labels = _skewed_labels()
    jp, jc = jlu.list_positions(jnp.asarray(labels), 20)
    tp, tc = tlu.list_positions(torch.from_numpy(labels), 20)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    cap = tlu.list_cap_target(3000, 20, 1.3)
    assert cap == jlu.list_cap_target(3000, 20, 1.3)
    jl, jrep = jlu.split_oversized(jnp.asarray(labels), 20, cap)
    tl, trep = tlu.split_oversized(torch.from_numpy(labels), 20, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(trep, jrep)


def test_bound_capacity_matches_jax():
    labels = _skewed_labels(seed=1)
    j = jlu.bound_capacity(jnp.asarray(labels), 20, 1.3)
    t = tlu.bound_capacity(torch.from_numpy(labels), 20, 1.3)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2:4] == j[2:4] and t[4] is None and j[4] is None
    small = np.arange(200, dtype=np.int32) % 20        # nothing to split
    assert tlu.bound_capacity(torch.from_numpy(small), 20)[1:] == (None, 20, 16, None)


def test_spatial_split_makes_slabs():
    """A list of at least 8x the bound splits along its principal axis: each
    sub-list is a contiguous range of the projection (the JAX package's power
    iteration starts from other random numbers, so the axis' sign may
    differ; the split itself must not)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    x[:, 0] *= 10.0                                     # one clear principal axis
    labels = np.concatenate([np.zeros(1000, np.int32), 1 + np.arange(1000) % 39]
                            ).astype(np.int32)          # list 0: 15x the bound of 65
    jl, jrep, jn, jcap, jsp = jlu.bound_capacity(jnp.asarray(labels), 40, 1.3, x=jnp.asarray(x))
    tl, trep, tn, tcap, tsp = tlu.bound_capacity(torch.from_numpy(labels), 40, 1.3,
                                                 x=torch.from_numpy(x))
    assert tsp[0] and not tsp[1:].any()
    assert (tn, tcap) == (jn, jcap)
    np.testing.assert_array_equal(trep, jrep)
    np.testing.assert_array_equal(tsp, jsp)
    tl = tl.numpy()
    for part in (tl, np.asarray(jl)):
        order = np.argsort(x[labels == 0, 0])
        sub = part[labels == 0][order]
        assert (np.all(np.diff(sub) >= 0) or np.all(np.diff(sub) <= 0)), "not slabs"
    np.testing.assert_array_equal(np.bincount(tl), np.bincount(np.asarray(jl)))


@pytest.mark.parametrize("m,n_probes,k,cap,budget", [
    (10_000, 8, 40, 1272, 2 << 30), (10_000, 8, 40, 1272, 64 << 20),
    (50, 20, 10, 168, 2 << 30), (3, 16, 500, 40, 1 << 20), (1000, 6, 10, 4000, 1 << 24),
])
def test_plan_search_tiles_matches_jax(m, n_probes, k, cap, budget):
    per = tlu.pq_scan_bytes_per_probe_row(cap, 64, 16)
    assert per == jlu.pq_scan_bytes_per_probe_row(cap, 64, 16)
    assert (tlu.plan_search_tiles(m, n_probes, k, cap, per, budget, 128)
            == jlu.plan_search_tiles(m, n_probes, k, cap, per, budget, 128))


def test_assign_to_lists_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    c = rng.normal(size=(12, 16)).astype(np.float32)
    for mt in (DistanceType.L2Expanded, DistanceType.InnerProduct):
        got = tlu.assign_to_lists(torch.from_numpy(x), torch.from_numpy(c), mt, 64)
        want = jlu.assign_to_lists(jnp.asarray(x), jnp.asarray(c), mt, 64)
        assert got.dtype == torch.int32
        assert np.mean(got.numpy() != np.asarray(want)) <= 0.004   # near ties only


@pytest.mark.parametrize("n,d", [(300, 16), (4200, 64)])   # GEMM route, fused route
@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_matches_jax(n, d, sqrt):
    rng = np.random.default_rng(n)
    x = rng.random((120, d)).astype(np.float32)
    y = rng.random((n, d)).astype(np.float32)
    td, ti = tfnn.fused_l2_nn(x, y, sqrt=sqrt, res=CPU)
    jd, ji = jfnn.fused_l2_nn(jnp.asarray(x), jnp.asarray(y), sqrt=sqrt)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    same = ti.numpy() == np.asarray(ji)
    # a differing index must be a tie within the tolerance
    exact = ((x[~same, None, :] - y[None]) ** 2).sum(-1)
    rows = np.nonzero(~same)[0]
    np.testing.assert_allclose(exact[np.arange(len(rows)), ti.numpy()[rows]],
                               exact[np.arange(len(rows)), np.asarray(ji)[rows]], rtol=1e-5)
    np.testing.assert_array_equal(tfnn.fused_l2_nn_argmin(x, y, res=CPU).numpy(), ti.numpy())
