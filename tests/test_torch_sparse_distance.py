"""raft_tpu_torch.sparse's pairwise distances, kNN, kNN graph and component
repair against raft_tpu.sparse on the same padded CSR arrays (CPU), and
``gram_matrix`` of CSR inputs against the dense call.

Tolerances: each of the 18 sparse metrics at the dense file's bounds
(tests/test_torch_pairwise.py: rtol 1e-5, 1e-4 for KL divergence and
Jensen-Shannon, atol 1e-5); sparse ``knn`` / ``knn_graph``: ids equal
except where distances tie within 1e-6, distances rtol 1e-5 (atol 1e-6:
the port scores unexpanded L2 by its expanded form, whose zero is rounding
noise); ``connect_components``: edges equal, weights rtol 1e-5; the CSR
``gram_matrix`` against the dense one rtol 1e-5. The JAX file's own cases
(tests/test_sparse_distance.py) carry over against numpy.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from raft_tpu import sparse as J
from raft_tpu.distance.types import DistanceType as JDT
from raft_tpu_torch import sparse as T
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.distance import KernelParams, KernelType, gram_matrix
from raft_tpu_torch.distance import pairwise_distance as dense_pairwise
from raft_tpu_torch.distance.types import DistanceType

CPU = Resources(device="cpu")

# the 18 of SPARSE_SUPPORTED, by name or enum (the JAX file's list, whose
# first four name two metrics twice, with the expanded L2 pair instead)
METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, "sqeuclidean", "euclidean",
           "inner_product", "l1", "canberra", "chebyshev",
           "lp", "jaccard", "cosine", "hellinger", "dice", "correlation", "russellrao",
           "hamming", "jensenshannon", "kl_divergence"]
BINARY = ("jaccard", "dice", "russellrao", "hamming")
LOOSE = ("jensenshannon", "kl_divergence")


def _name(m):
    return m if isinstance(m, str) else m.name


def _jax_metric(m):
    return m if isinstance(m, str) else JDT(int(m))


def _rand_csr(seed, n, d, density=0.3, binary=False):
    raw = sps.random(n, d, density=density, random_state=np.random.RandomState(seed),
                     format="csr", dtype=np.float32)
    raw.data = np.ones_like(raw.data) if binary else np.abs(raw.data) + 0.05
    j = J.from_scipy(raw, cap=raw.nnz + 3)
    t = T.make_csr(**{f: np.asarray(getattr(j, f)) for f in ("indptr", "indices", "data")},
                   shape=j.shape, res=CPU)
    return raw, j, t


def test_every_sparse_metric_is_supported():
    assert len(T.SPARSE_SUPPORTED) == 18 and len(METRICS) == 18
    assert {int(m) for m in T.SPARSE_SUPPORTED} == {int(m) for m in J.SPARSE_SUPPORTED}
    from raft_tpu_torch.distance.types import resolve_metric

    assert {resolve_metric(m) for m in METRICS} == set(T.SPARSE_SUPPORTED)


@pytest.mark.parametrize("metric", METRICS, ids=_name)
def test_pairwise_matches_jax(metric):
    binary = _name(metric) in BINARY
    _, jx, tx = _rand_csr(1, 18, 25, binary=binary)
    _, jy, ty = _rand_csr(2, 14, 25, binary=binary)
    ref = np.asarray(J.pairwise_distance(jx, jy, metric=_jax_metric(metric)))
    got = T.pairwise_distance(tx, ty, metric=metric, res=CPU)
    assert got.dtype == torch.float32 and got.shape == (18, 14)
    rtol = 1e-4 if _name(metric) in LOOSE else 1e-5
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "l1", "cosine", "jensenshannon"])
def test_pairwise_matches_dense(metric):
    """The port's sparse call equals its dense call on the densified rows."""
    x_sp, _, tx = _rand_csr(3, 18, 25)
    y_sp, _, ty = _rand_csr(4, 14, 25)
    got = T.pairwise_distance(tx, ty, metric=metric, res=CPU).numpy()
    ref = dense_pairwise(x_sp.toarray(), y_sp.toarray(), metric=metric, res=CPU).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_small_workspace_tiles_answer_as_one():
    """An 8-row tile (the last one padded) gives one tile's answer."""
    _, _, tx = _rand_csr(5, 21, 30)
    small = Resources(device="cpu", workspace_bytes=8 * 21 * 32 * 4)
    for metric in ("l1", "inner_product"):
        np.testing.assert_allclose(T.pairwise_distance(tx, metric=metric, res=small).numpy(),
                                   T.pairwise_distance(tx, metric=metric, res=CPU).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_self_distance():
    _, _, t = _rand_csr(6, 12, 10)
    out = T.pairwise_distance(t, metric="sqeuclidean", res=CPU).numpy()
    assert out.shape == (12, 12)
    np.testing.assert_allclose(np.diag(out), 0, atol=1e-5)


@pytest.mark.parametrize("width", [None, 3])
def test_csr_to_ell_matches_jax(width):
    sp, j, t = _rand_csr(7, 9, 13)
    ji, jv = J.csr_to_ell(j, width)
    ti, tv = T.csr_to_ell(t, width)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if width is None:
        dense = np.zeros((9, 14), np.float32)
        np.add.at(dense, (np.arange(9)[:, None], ti.numpy()), tv.numpy())
        np.testing.assert_allclose(dense[:, :13], sp.toarray(), rtol=1e-6)


def test_unsupported_metric_raises():
    _, _, t = _rand_csr(8, 5, 5)
    with pytest.raises(RaftError, match="unsupported"):
        T.pairwise_distance(t, metric="haversine", res=CPU)
    with pytest.raises(RaftError, match="unsupported"):
        T.knn(t, t, 2, metric="braycurtis", res=CPU)


def _assert_knn_equiv(td, ti, jd, ji, tie=1e-6, rtol=1e-5, atol=1e-6):
    """Distances within rtol; ids equal except where the JAX row's distances
    tie within ``tie`` at the differing slots."""
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=atol)
    for r in np.nonzero((ti != ji).any(1))[0]:
        bad = ti[r] != ji[r]
        if set(ti[r]) == set(ji[r]):
            continue
        # a differing id must sit where two candidates tie (the k-th slot's
        # distance reached by another row)
        kth = jd[r, bad]
        assert np.all(np.abs(td[r, bad] - kth) <= tie + rtol * np.abs(kth)), (r, ti[r], ji[r])


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "l1",
                                    "cosine", "hellinger"])
@pytest.mark.parametrize("k", [1, 5])
def test_knn_matches_jax(metric, k):
    _, jd_, td_ = _rand_csr(9, 60, 20)
    _, jq, tq = _rand_csr(10, 9, 20)
    jd, ji = J.knn(jd_, jq, k, metric=metric)
    td, ti = T.knn(td_, tq, k, metric=metric, res=CPU)
    assert ti.dtype == torch.int32 and td.shape == (9, k)
    _assert_knn_equiv(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji))


def test_knn_select_routes_agree():
    """The plain select route and the kernel's (its plain version on the
    CPU) give the same ids and distances."""
    _, _, td_ = _rand_csr(11, 80, 20)
    _, _, tq = _rand_csr(12, 7, 20)
    a = T.knn(td_, tq, 6, metric="inner_product", select_impl="torch", res=CPU)
    b = T.knn(td_, tq, 6, metric="inner_product", select_impl="kernel", res=CPU)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_knn_vs_numpy():
    ds_sp, _, ds = _rand_csr(13, 60, 20)
    q_sp, _, q = _rand_csr(14, 9, 20)
    d, i = T.knn(ds, q, k=5, metric="sqeuclidean", res=CPU)
    full = ((q_sp.toarray()[:, None, :] - ds_sp.toarray()[None]) ** 2).sum(-1)
    expect_i = np.argsort(full, axis=1, kind="stable")[:, :5]
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, expect_i, 1), rtol=1e-4,
                               atol=1e-4)
    for r in range(9):
        assert set(i.numpy()[r]) == set(expect_i[r])


@pytest.mark.parametrize("k", [3, 7])
def test_knn_graph_matches_jax(k):
    _, j, t = _rand_csr(15, 30, 12)
    jg = J.knn_graph(j, k=k, metric="sqeuclidean")
    tg = T.knn_graph(t, k=k, metric="sqeuclidean", res=CPU)
    assert tg.shape == (30, 30) and int(tg.nnz) == 30 * k
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    rows = tg.rows.numpy()
    assert (rows != tg.cols.numpy()).all(), "self edges must be excluded"
    np.testing.assert_array_equal(np.bincount(rows, minlength=30), k)
    _assert_knn_equiv(tg.vals.numpy().reshape(30, k), tg.cols.numpy().reshape(30, k),
                      np.asarray(jg.vals).reshape(30, k), np.asarray(jg.cols).reshape(30, k))


@pytest.mark.parametrize("n_comp", [2, 5])
def test_connect_components_matches_jax(n_comp):
    rng = np.random.default_rng(n_comp)
    x = np.concatenate([rng.normal(5 * c, 0.1, (8, 3)) for c in range(n_comp)]).astype(np.float32)
    colors = np.repeat(np.arange(n_comp), 8).astype(np.int32)
    a = J.connect_components(jnp.asarray(x), jnp.asarray(colors))
    b = T.connect_components(x, colors, res=CPU)
    for f in ("rows", "cols", "nnz"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
    np.testing.assert_allclose(b.vals.numpy(), np.asarray(a.vals), rtol=1e-5)
    ne = int(b.nnz)
    assert ne == n_comp
    assert (colors[b.rows.numpy()[:ne]] != colors[b.cols.numpy()[:ne]]).all()


@pytest.mark.parametrize("kernel", list(KernelType), ids=lambda k: k.value)
def test_gram_matrix_of_csr_equals_dense(kernel):
    x_sp, _, tx = _rand_csr(16, 15, 40)
    y_sp, _, ty = _rand_csr(17, 11, 40)
    p = KernelParams(kernel=kernel, degree=2, gamma=0.5, coef0=1.0)
    for y, yd in ((ty, y_sp.toarray()), (None, None)):
        got = gram_matrix(p, tx, y, res=CPU).numpy()
        ref = gram_matrix(p, x_sp.toarray(), yd, res=CPU).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    mixed = gram_matrix(p, tx, y_sp.toarray(), res=CPU).numpy()
    np.testing.assert_allclose(mixed, gram_matrix(p, x_sp.toarray(), y_sp.toarray(),
                                                  res=CPU).numpy(), rtol=1e-5, atol=1e-7)
