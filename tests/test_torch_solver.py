"""raft_tpu_torch.solver against raft_tpu.solver on the same inputs (CPU).

Tolerances: MST ``src`` / ``dst`` / ``n_edges`` / ``colors`` equal and
weights bit for bit on the same COO; ``eigsh`` started from JAX's own
``v0`` (``jax.random.normal(as_key(seed))``): eigenvalues rtol 1e-4 (atol
1e-5, for the zero eigenvalue of a Laplacian), eigenvectors |cos| >= 0.999,
restarts equal within 1; ``lap_solve`` on integer costs (single and
batched): assignments and objective equal, duals rtol 1e-6. The JAX files'
own cases (tests/test_solver.py, tests/test_lap.py) run against scipy on
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csgraph
import torch
from scipy.optimize import linear_sum_assignment

from raft_tpu import solver as JS
from raft_tpu import sparse as J
from raft_tpu.random.rng import as_key
from raft_tpu_torch import solver as TS
from raft_tpu_torch import sparse as T
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.solver import lap as tlap

CPU = Resources(device="cpu")


def _random_graph(seed, n, density=0.3, connected=True):
    a = sps.random(n, n, density=density, random_state=np.random.RandomState(seed),
                   format="csr", dtype=np.float32)
    a.data = np.abs(a.data) + 0.01
    a = (a + a.T) / 2
    if connected:
        ring = sps.csr_matrix((np.full(n, 0.5, np.float32), (np.arange(n), (np.arange(n) + 1) % n)),
                              shape=(n, n))
        a = (a + ring + ring.T).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    return a.tocsr().astype(np.float32)


def _pair(a, cap_extra=5):
    j = J.from_scipy(a, cap=a.nnz + cap_extra)
    t = T.make_csr(**{f: np.asarray(getattr(j, f)) for f in ("indptr", "indices", "data")},
                   shape=j.shape, res=CPU)
    return j, t


def _same_mst(jo, to):
    for f in jo._fields:
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


class TestMst:
    @pytest.mark.parametrize("n", [8, 30, 64])
    def test_matches_jax_and_scipy(self, n):
        a = _random_graph(n, n)
        j, t = _pair(a)
        to = TS.mst(t)
        _same_mst(JS.mst(j), to)
        ne = int(to.n_edges)
        assert ne == n - 1
        np.testing.assert_allclose(float(to.weights[:ne].sum()),
                                   csgraph.minimum_spanning_tree(a).sum(), rtol=1e-5)
        assert (np.diff(to.weights[:ne].numpy()) >= 0).all()

    def test_coo_input_with_ties(self):
        """Equal weights everywhere: the (weight, id) rank decides, as in JAX."""
        a = _random_graph(3, 20)
        a.data[:] = 1.0
        j, _ = _pair(a)
        jc = J.csr_to_coo(j)
        tc = T.make_coo(np.asarray(jc.rows), np.asarray(jc.cols), np.asarray(jc.vals),
                        jc.shape, nnz=int(jc.nnz), res=CPU)
        _same_mst(JS.mst(jc), TS.mst(tc))

    def test_forest_on_disconnected(self):
        n, half = 12, 6
        d = np.zeros((n, n), np.float32)
        d[:half, :half] = 1.0
        d[half:, half:] = 2.0
        np.fill_diagonal(d, 0.0)
        jo = JS.mst(J.dense_to_csr(jnp.asarray(d)))
        to = TS.mst(T.dense_to_csr(torch.from_numpy(d)))
        _same_mst(jo, to)
        assert int(to.n_edges) == n - 2
        colors = to.colors.numpy()
        assert len(np.unique(colors)) == 2 and len(np.unique(colors[:half])) == 1

    def test_n_vertices(self):
        a = _random_graph(4, 10)
        j, t = _pair(a)
        _same_mst(JS.mst(j, n_vertices=13), TS.mst(t, n_vertices=13))
        with pytest.raises(RaftError, match="n_vertices"):
            TS.mst(t, n_vertices=5)


def _jax_v0(seed, n):
    return np.asarray(jax.random.normal(as_key(seed), (n,), jnp.float32))


def _same_eigs(jw, jv, jr, tw, tv, tr):
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)
    cos = np.abs((np.asarray(jv) * tv.numpy()).sum(0)) / (
        np.linalg.norm(np.asarray(jv), axis=0) * np.linalg.norm(tv.numpy(), axis=0))
    assert (cos >= 0.999).all(), cos
    assert abs(int(jr) - int(tr)) <= 1, (jr, tr)


def _two_block(seed, n_per=20, p_in=0.85, p_out=0.02):
    rng = np.random.default_rng(seed)
    n = 2 * n_per
    dense = (rng.random((n, n)) < p_out).astype(np.float32)
    dense[:n_per, :n_per] = rng.random((n_per, n_per)) < p_in
    dense[n_per:, n_per:] = rng.random((n_per, n_per)) < p_in
    dense = np.triu(dense, 1)
    dense = dense + dense.T
    for i in range(n):
        dense[i, (i + 1) % n] = dense[(i + 1) % n, i] = max(dense[i, (i + 1) % n], 0.05)
    np.fill_diagonal(dense, 0.0)
    return dense


class TestLanczos:
    @pytest.mark.parametrize("which", ["SA", "LA"])
    def test_dense_matches_jax(self, which):
        rng = np.random.default_rng(5)
        n = 60
        a = rng.standard_normal((n, n)).astype(np.float32)
        a = a @ a.T / n + np.diag(np.linspace(0.5, 5.0, n)).astype(np.float32)
        jw, jv, jr = JS.eigsh(a, k=4, which=which, tol=1e-8, max_iter=2000)
        tw, tv, tr = TS.eigsh(torch.from_numpy(a), k=4, which=which, tol=1e-8, max_iter=2000,
                              v0=_jax_v0(42, n))
        _same_eigs(jw, jv, jr, tw, tv, tr)
        ref = np.linalg.eigvalsh(a)
        np.testing.assert_allclose(tw.numpy(), ref[:4] if which == "SA" else ref[-4:],
                                   rtol=2e-3, atol=2e-3)
        resid = a @ tv.numpy() - tv.numpy() * tw.numpy()[None, :]
        assert np.linalg.norm(resid, axis=0).max() < 5e-2

    def test_sparse_laplacian_matches_jax(self):
        dense = _two_block(6)
        cap = int((dense > 0).sum()) + 8
        j, t = _pair(sps.csr_matrix(dense), cap - int((dense > 0).sum()))
        jl, tl = J.laplacian(j), T.laplacian(t)
        jw, jv, jr = JS.eigsh(jl, k=3, which="SA", tol=1e-7, max_iter=3000)
        tw, tv, tr = TS.eigsh(tl, k=3, which="SA", tol=1e-7, max_iter=3000,
                              v0=_jax_v0(42, dense.shape[0]))
        _same_eigs(jw, jv, jr, tw, tv, tr)
        ref = np.linalg.eigvalsh(np.diag(dense.sum(1)) - dense)[:3]
        np.testing.assert_allclose(tw.numpy(), ref, rtol=5e-3, atol=5e-3)
        assert abs(float(tw[0])) < 1e-3

    def test_callable_operator_and_wrappers(self):
        n = 32
        d = torch.linspace(1.0, 10.0, n)
        w, _, _ = TS.eigsh(lambda x: d * x, n=n, k=2, which="SA", tol=1e-8, res=CPU)
        np.testing.assert_allclose(w.numpy(), d[:2].numpy(), rtol=1e-3, atol=1e-3)
        # at tol 1e-8 the residual test reads float32 noise and the two
        # packages' restart counts wander apart; 1e-6 is above it
        jw, jv, jr = JS.compute_largest_eigenvectors(np.diag(d.numpy()), k=2, tol=1e-6)
        tw, tv, tr = TS.compute_largest_eigenvectors(torch.diag(d), k=2, tol=1e-6,
                                                     v0=_jax_v0(42, n))
        _same_eigs(jw, jv, jr, tw, tv, tr)
        tw2, _, _ = TS.compute_smallest_eigenvectors(torch.diag(d), k=2, tol=1e-8, seed=3)
        np.testing.assert_allclose(tw2.numpy(), d[:2].numpy(), rtol=1e-3, atol=1e-3)

    def test_seed_draws_are_reproducible(self):
        a = torch.diag(torch.linspace(1.0, 5.0, 24))
        r1 = TS.eigsh(a, k=2, seed=9)
        r2 = TS.eigsh(a, k=2, seed=9)
        assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])

    def test_checks(self):
        with pytest.raises(RaftError, match="1 <= k < n"):
            TS.eigsh(torch.eye(4), k=4)
        with pytest.raises(RaftError, match="which"):
            TS.eigsh(torch.eye(6), k=2, which="LM")
        with pytest.raises(RaftError, match="n is required"):
            TS.eigsh(lambda x: x, k=2)


class TestLap:
    @pytest.mark.parametrize("n", [4, 16, 64])
    def test_integer_costs_match_jax_and_scipy(self, n):
        cost = np.random.default_rng(n).integers(0, 100, (n, n)).astype(np.float32)
        jo = JS.lap_solve(jnp.asarray(cost))
        to = TS.lap_solve(torch.from_numpy(cost))
        for f in ("row_assignment", "col_assignment", "objective", "converged"):
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                          err_msg=f)
        for f in ("row_duals", "col_duals"):
            np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                       rtol=1e-6)
        ri, ci = linear_sum_assignment(cost)
        assert float(to.objective) == cost[ri, ci].sum()
        ra = to.row_assignment.numpy()
        assert sorted(ra.tolist()) == list(range(n))
        assert (to.col_assignment.numpy()[ra] == np.arange(n)).all()

    @pytest.mark.parametrize("maximize", [False, True])
    def test_batched_matches_jax(self, maximize):
        cost = np.random.default_rng(7).integers(0, 100, (5, 20, 20)).astype(np.float32)
        jo = JS.lap_solve(jnp.asarray(cost), maximize=maximize)
        to = TS.lap_solve(cost, maximize=maximize, res=CPU)
        for f in jo._fields:
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                          err_msg=f)
        for i in range(5):
            ri, ci = linear_sum_assignment(cost[i], maximize=maximize)
            assert float(to.objective[i]) == cost[i][ri, ci].sum()

    def test_stop_flag_cadence_changes_nothing(self, monkeypatch):
        """Reading the stop flag every round or every 32 gives the same
        answer: a finished problem is frozen."""
        cost = np.random.default_rng(8).integers(0, 50, (3, 12, 12)).astype(np.float32)
        a, sa = tlap._lap(torch.from_numpy(cost), None, False, None, None)
        monkeypatch.setattr(tlap, "ROUNDS_PER_READ", 1)
        b, sb = tlap._lap(torch.from_numpy(cost), None, False, None, None)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert sa["rounds"] == sb["rounds"] and sb["reads"] >= sa["reads"]

    def test_iteration_cap_matches_jax(self):
        cost = np.random.default_rng(9).integers(0, 100, (2, 16, 16)).astype(np.float32)
        jo = JS.lap_solve(jnp.asarray(cost), max_iter=7)
        to = TS.lap_solve(torch.from_numpy(cost), max_iter=7)
        assert not to.converged.any()
        for f in jo._fields:
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                          err_msg=f)

    def test_float_costs_near_optimal(self):
        n = 48
        cost = np.random.default_rng(10).random((n, n)).astype(np.float32)
        to = TS.lap_solve(torch.from_numpy(cost), eps=1e-4)
        ri, ci = linear_sum_assignment(cost)
        assert float(to.objective) <= cost[ri, ci].sum() + n * 1e-4 + 1e-4
        u = to.row_duals.numpy()[:, None]
        v = to.col_duals.numpy()[None, :]
        assert np.all(u + v <= cost + 1e-4 + 1e-5)

    def test_single_and_checks(self):
        out = TS.lap_solve(torch.tensor([[[3.0]], [[5.0]]]))
        assert out.row_assignment.shape == (2, 1) and out.converged.all()
        np.testing.assert_array_equal(out.objective.numpy(), [3.0, 5.0])
        with pytest.raises(RaftError, match="square"):
            TS.lap_solve(torch.zeros((3, 4)))
