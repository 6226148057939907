"""raft_tpu_torch's masked L2 nearest neighbour, Gram matrices, epsilon
neighbourhood and dispersion against the JAX package's, on seeded numpy
inputs on the CPU. Distances within rtol 1e-5 (products summed in different
orders); argmin ids equal except where two distances tie within that
tolerance; adjacency equal except for pairs within 1e-5 of the radius."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance import kernels as jk
from raft_tpu.distance import masked_nn as jmn
from raft_tpu.neighbors import epsilon_neighborhood as jeps
from raft_tpu.sparse.convert import dense_to_csr
from raft_tpu.sparse.types import CsrMatrix
from raft_tpu.stats import metrics as jstats
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.distance import KernelParams, KernelType, gram_matrix, kernel_factory
from raft_tpu_torch.distance import masked_nn as tmn
from raft_tpu_torch.neighbors import eps_neighbors_l2sq
from raft_tpu_torch.stats import dispersion

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return rng.random((45, 12), np.float32), rng.random((70, 12), np.float32)


@pytest.mark.parametrize("sqrt", [False, True])
def test_masked_l2_nn_matches_jax(data, sqrt):
    x, y = data
    rng = np.random.default_rng(5)
    ends = np.array([9, 10, 33, 50, 70])        # a one-row group
    adj = rng.random((45, 5)) < 0.4
    adj[3] = False                              # no admissible group
    adj[4] = [False, True, False, False, False]
    y[20] = y[21]                               # a tie inside group 2
    jd, ji = jmn.masked_l2_nn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(adj), ends,
                              sqrt=sqrt)
    small = Resources(device="cpu", workspace_bytes=8 * 70 * 3 * 4)   # 8-row tiles
    for res in (CPU, small):
        td, ti = tmn.masked_l2_nn(x, y, adj, ends, sqrt=sqrt, res=res)
        assert td.dtype == torch.float32 and ti.dtype == torch.int32
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[3] == -1 and np.isinf(td[3].item()) and ti[4] == 9


def test_masked_l2_nn_contract_errors(data):
    x, y = data
    adj = np.ones((45, 2), bool)
    for ends in ([30, 60], [40, 30, 70][:2], [0, 70]):
        with pytest.raises(RaftError, match="group_idxs"):
            tmn.masked_l2_nn(x, y, adj, ends, res=CPU)
    with pytest.raises(RaftError, match="adj"):
        tmn.masked_l2_nn(x, y, adj[:, :1], [30, 70], res=CPU)


@pytest.mark.parametrize("kernel,degree,gamma,coef0", [
    (KernelType.LINEAR, 3, 1.0, 0.0), (KernelType.POLYNOMIAL, 3, 0.5, 1.0),
    (KernelType.POLYNOMIAL, 2, 1.0, -0.5), (KernelType.TANH, 3, 0.2, 0.1),
    (KernelType.RBF, 3, 0.7, 0.0)])
def test_gram_matrix_matches_jax(data, kernel, degree, gamma, coef0):
    x, y = data
    jp = jk.KernelParams(jk.KernelType(kernel.value), degree, gamma, coef0)
    tp = KernelParams(kernel, degree, gamma, coef0)
    for yy in (y, None):
        ref = np.asarray(jk.gram_matrix(jp, jnp.asarray(x),
                                        None if yy is None else jnp.asarray(yy)))
        got = gram_matrix(tp, x, yy, res=CPU)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    if kernel == KernelType.RBF:
        nx, ny = (x * x).sum(1) + 0.25, (y * y).sum(1)
        ref = np.asarray(jk.kernel_factory(jp)(jnp.asarray(x), jnp.asarray(y),
                                               norm_x=jnp.asarray(nx), norm_y=jnp.asarray(ny)))
        got = kernel_factory(tp)(x, y, norm_x=nx, norm_y=ny, res=CPU)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_gram_matrix_csr_not_yet_ported(data):
    x, _ = data
    csr = dense_to_csr(jnp.asarray(x))
    assert isinstance(csr, CsrMatrix)
    with pytest.raises(RaftError, match="not yet ported"):
        gram_matrix(KernelParams(), csr, res=CPU)


@pytest.mark.parametrize("self_pairs", [False, True])
def test_eps_neighbors_matches_jax(data, self_pairs):
    x, y = data
    yy = None if self_pairs else y
    eps = 1.1
    ja, jv = jeps.eps_neighbors_l2sq(jnp.asarray(x), None if yy is None else jnp.asarray(yy),
                                     eps)
    ta, tv = eps_neighbors_l2sq(x, yy, eps, res=CPU)
    assert ta.dtype == torch.bool and tv.dtype == torch.int32
    ja, jv = np.asarray(ja), np.asarray(jv)
    d2 = (((x[:, None, :].astype(np.float64) - (x if yy is None else y)[None]) ** 2).sum(-1))
    edge = np.abs(d2 - eps) < 1e-5 * eps
    assert ((ta.numpy() == ja) | edge).all() and not edge.any()
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tv[-1] == ta.sum() and (tv[:-1].numpy() == ta.numpy().sum(1)).all()
    if self_pairs:
        assert ta.diagonal().all()


def test_dispersion_matches_jax(data):
    x, _ = data
    c, sizes = x[:6], np.array([3, 0, 5, 1, 9, 2], np.float32)
    for g in (None, x[7]):
        ref = float(jstats.dispersion(jnp.asarray(c), jnp.asarray(sizes),
                                      None if g is None else jnp.asarray(g)))
        got = dispersion(c, sizes, g, res=CPU)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_entry_points_default_to_cuda(data):
    """Without a handle every new entry point asks for the card, and raises
    where there is none: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from raft_tpu_torch.cluster import KMeansParams, kmeans
    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.spatial import haversine_knn

    x, y = data
    calls = [lambda: tmn.masked_l2_nn(x, y, np.ones((45, 1), bool), [70]),
             lambda: gram_matrix(KernelParams(), x),
             lambda: eps_neighbors_l2sq(x, y, 1.0),
             lambda: dispersion(x[:3], np.ones(3)),
             lambda: pairwise_distance(x, y, "l1"),
             lambda: kmeans.fit(KMeansParams(n_clusters=3), x),
             lambda: ivf_flat.build(ivf_flat.IndexParams(n_lists=4), x),
             lambda: haversine_knn(x[:, :2], y[:, :2], 3)]
    for call in calls:
        with pytest.raises(RaftError, match="CUDA"):
            call()
