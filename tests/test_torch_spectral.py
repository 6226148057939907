"""raft_tpu_torch.spectral against raft_tpu.spectral on the same graphs (CPU).

The port's eigensolver starts from JAX's own start vector
(``jax.random.normal(as_key(EigenSolverConfig.seed))``, passed as ``v0=``).
Tolerances: eigenpairs as ``eigsh``'s (eigenvalues rtol 1e-4, atol 1e-5;
eigenvectors |cos| >= 0.999; restarts within 1); labels ARI >= 0.99 against
JAX's, since the k-means draws differ (a torch generator);
``analyze_partition`` / ``analyze_modularity`` on JAX's own labels rtol
1e-5. The JAX file's cases (tests/test_spectral.py) run on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps

from raft_tpu import sparse as J
from raft_tpu import spectral as JSp
from raft_tpu.random.rng import as_key
from raft_tpu_torch import sparse as T
from raft_tpu_torch import spectral as TSp
from raft_tpu_torch.core import RaftError, Resources

CPU = Resources(device="cpu")


def ari(a, b):
    """Adjusted Rand index from the contingency table."""
    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1)

    def pairs(v):
        return (v * (v - 1) / 2).sum()

    s, sa, sb = pairs(table), pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / pairs(np.array([len(ai)]))
    return (s - expected) / (0.5 * (sa + sb) - expected)


def _blocks(seed, n_blocks=2, n_per=24, p_in=0.85, p_out=0.02):
    rng = np.random.default_rng(seed)
    n = n_blocks * n_per
    dense = (rng.random((n, n)) < p_out).astype(np.float32)
    for b in range(n_blocks):
        s = slice(b * n_per, (b + 1) * n_per)
        dense[s, s] = rng.random((n_per, n_per)) < p_in
    dense = np.triu(dense, 1)
    dense = dense + dense.T
    for i in range(n):
        dense[i, (i + 1) % n] = dense[(i + 1) % n, i] = max(dense[i, (i + 1) % n], 0.05)
    np.fill_diagonal(dense, 0.0)
    return dense, np.repeat(np.arange(n_blocks), n_per)


def _pair(dense):
    sp = sps.csr_matrix(dense)
    j = J.from_scipy(sp, cap=sp.nnz + 8)
    t = T.make_csr(**{f: np.asarray(getattr(j, f)) for f in ("indptr", "indices", "data")},
                   shape=j.shape, res=CPU)
    return j, t


def _same_eigs(jo, to):
    np.testing.assert_allclose(to.eigenvalues.numpy(), np.asarray(jo.eigenvalues), rtol=1e-4,
                               atol=1e-5)
    jv, tv = np.asarray(jo.eigenvectors), to.eigenvectors.numpy()
    cos = np.abs((jv * tv).sum(0)) / (np.linalg.norm(jv, axis=0) * np.linalg.norm(tv, axis=0))
    assert (cos >= 0.999).all(), cos
    assert abs(jo.n_eigen_restarts - to.n_eigen_restarts) <= 1


# 48 vertices in each, so the JAX programs of one shape are shared; the
# 3- and 4-block cases each compile JAX k-means and Lanczos programs of
# their own (~6-9 s a case), so they run in the slow tier
CASES = [(2, 24, 1), pytest.param(3, 16, 2, marks=pytest.mark.slow),
         pytest.param(4, 12, 3, marks=pytest.mark.slow)]


@pytest.mark.parametrize("n_blocks,n_per,seed", CASES)
def test_partition_matches_jax(n_blocks, n_per, seed):
    dense, truth = _blocks(seed, n_blocks, n_per)
    j, t = _pair(dense)
    cfg = dict(n_eig_vecs=n_blocks, tol=1e-6)
    jo = JSp.partition(j, n_blocks, eigen_cfg=JSp.EigenSolverConfig(**cfg))
    v0 = np.asarray(jax.random.normal(as_key(JSp.EigenSolverConfig().seed), (len(truth),),
                                      jnp.float32))
    to = TSp.partition(t, n_blocks, eigen_cfg=TSp.EigenSolverConfig(**cfg), v0=v0)
    _same_eigs(jo, to)
    assert ari(to.labels.numpy(), np.asarray(jo.labels)) >= 0.99
    assert ari(to.labels.numpy(), truth) >= 0.95
    # the analyses on JAX's own labels
    labels = np.asarray(jo.labels)
    je, jc = JSp.analyze_partition(j, n_blocks, labels)
    te, tc = TSp.analyze_partition(t, n_blocks, labels)
    np.testing.assert_allclose([float(te), float(tc)], [float(je), float(jc)], rtol=1e-5)
    np.testing.assert_allclose(float(TSp.analyze_modularity(t, n_blocks, labels)),
                               float(JSp.analyze_modularity(j, n_blocks, labels)), rtol=1e-5)


@pytest.mark.parametrize("n_blocks,n_per,seed", CASES)
def test_modularity_maximization_matches_jax(n_blocks, n_per, seed):
    dense, truth = _blocks(seed, n_blocks, n_per)
    j, t = _pair(dense)
    cfg = dict(n_eig_vecs=n_blocks, tol=1e-6)
    jo = JSp.modularity_maximization(j, n_blocks, eigen_cfg=JSp.EigenSolverConfig(**cfg))
    v0 = np.asarray(jax.random.normal(as_key(JSp.EigenSolverConfig().seed), (len(truth),),
                                      jnp.float32))
    to = TSp.modularity_maximization(t, n_blocks, eigen_cfg=TSp.EigenSolverConfig(**cfg),
                                     v0=v0, res=CPU)
    _same_eigs(jo, to)
    assert ari(to.labels.numpy(), np.asarray(jo.labels)) >= 0.99
    assert ari(to.labels.numpy(), truth) >= 0.9


@pytest.mark.parametrize("k", [2, 3])
def test_analyze_matches_jax(k):
    """The analyses on labels drawn for both packages alike."""
    dense, _ = _blocks(4)
    j, t = _pair(dense)
    labels = np.random.default_rng(k).integers(0, k, dense.shape[0])
    je, jc = JSp.analyze_partition(j, k, labels)
    te, tc = TSp.analyze_partition(t, k, labels)
    np.testing.assert_allclose([float(te), float(tc)], [float(je), float(jc)], rtol=1e-5)
    # a random labelling's modularity is ~0, a difference of near-equal sums
    np.testing.assert_allclose(float(TSp.analyze_modularity(t, k, labels)),
                               float(JSp.analyze_modularity(j, k, labels)), rtol=1e-5,
                               atol=1e-7)


def test_analyze_partition_counts_the_cut():
    dense, truth = _blocks(5)
    _, t = _pair(dense)
    n = dense.shape[0]
    edge_cut, cost = TSp.analyze_partition(t, 2, truth)
    np.testing.assert_allclose(float(edge_cut), dense[: n // 2, n // 2:].sum(), rtol=1e-4)
    assert float(cost) > 0
    rand_cut, _ = TSp.analyze_partition(t, 2, np.random.default_rng(0).integers(0, 2, n))
    assert float(edge_cut) < float(rand_cut)


def test_modularity_matches_the_formula():
    dense, _ = _blocks(6, n_per=12)
    _, t = _pair(dense)
    labels = np.random.default_rng(1).integers(0, 3, dense.shape[0])
    d = dense.sum(1)
    same = labels[:, None] == labels[None, :]
    ref = ((dense - np.outer(d, d) / d.sum()) * same).sum() / d.sum()
    np.testing.assert_allclose(float(TSp.analyze_modularity(t, 3, labels)), ref, rtol=1e-4,
                               atol=1e-5)


def test_partition_of_a_knn_graph():
    """The phase-c pipeline at a small size: blobs -> knn_graph ->
    symmetrize -> partition, labels against the blobs."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3
    lab = rng.integers(0, 4, 400)
    x = centers[lab] + rng.standard_normal((400, 8)).astype(np.float32)
    import torch

    g = T.knn_graph(T.dense_to_csr(torch.from_numpy(x)), 10, res=CPU)
    a = T.symmetrize(T.coo_to_csr(g))
    out = TSp.partition(a, 4, v0=np.ones(400, np.float32) + rng.random(400, np.float32))
    assert ari(out.labels.numpy(), lab) >= 0.95


def test_checks():
    with pytest.raises(RaftError, match="CsrMatrix"):
        TSp.partition(np.eye(4), 2)
    _, t = _pair(_blocks(8)[0])
    with pytest.raises(RaftError, match="cuda|lives on"):
        TSp.partition(t, 2, res=Resources(device="cuda"))
