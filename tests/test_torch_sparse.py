"""raft_tpu_torch.sparse's containers, conversions, structural ops and linear
algebra against raft_tpu.sparse, on the same padded arrays (CPU).

Each JAX matrix's padded fields are handed to the port
(``make_csr(**fields)`` / ``make_coo(..., nnz=)``), so both packages start
from one matrix. Tolerances: integer outputs (sorts, conversions, dedupe,
filter / slice, transpose, the structure of ``symmetrize`` / ``laplacian``,
degrees) equal; float sums (``spmv``, ``spmm``, ``sum_duplicates``,
``degree``-weighted sums, norms) rtol 1e-6; the rest of the values equal.
The JAX file's own cases (tests/test_sparse.py) run against scipy on both
packages.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from raft_tpu import sparse as J
from raft_tpu_torch import sparse as T
from raft_tpu_torch.core import RaftError, Resources

CPU = Resources(device="cpu")
SUM_RTOL = 1e-6
CSR_FIELDS = ("indptr", "indices", "data")
COO_FIELDS = ("rows", "cols", "vals", "nnz")


def _scipy(seed, n, m, density=0.2):
    sp = sps.random(n, m, density=density, random_state=np.random.RandomState(seed),
                    format="csr", dtype=np.float32)
    sp.data = sp.data.astype(np.float32) + 0.1       # no explicit zeros
    return sp


# one capacity (and few shapes) throughout, so JAX compiles each op once
CAP = 80


def _pair_csr(sp):
    """(JAX CsrMatrix, port CsrMatrix) over the same padded fields."""
    j = J.from_scipy(sp, cap=CAP)
    t = T.make_csr(**{f: np.asarray(getattr(j, f)) for f in CSR_FIELDS}, shape=j.shape,
                   res=CPU)
    return j, t


def _port_coo(j):
    return T.make_coo(np.asarray(j.rows), np.asarray(j.cols), np.asarray(j.vals), j.shape,
                      nnz=int(j.nnz), res=CPU)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _equal(j, t, fields):
    for f in fields:
        a, b = _np(getattr(j, f)), _np(getattr(t, f))
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert tuple(j.shape) == tuple(t.shape)


def _dup_coo(seed, n=9, m=7, nnz=40, cap=47):
    """A JAX COO with many repeated (row, col) pairs, unsorted, padded."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, m, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return J.make_coo(rows, cols, vals, (n, m), cap=cap)


class TestTypes:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_csr_fields_todense_and_row_ids(self, seed):
        j, t = _pair_csr(_scipy(seed, 12, 15))
        _equal(j, t, CSR_FIELDS)
        assert t.cap == j.cap and int(t.nnz) == int(j.nnz)
        np.testing.assert_array_equal(t.row_ids().numpy(), np.asarray(j.row_ids()))
        np.testing.assert_array_equal(t.valid_mask().numpy(), np.asarray(j.valid_mask()))
        np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_coo_from_scipy_and_padded_fields(self, seed):
        sp = sps.random(12, 15, density=0.3, format="coo", dtype=np.float32,
                        random_state=np.random.RandomState(seed))
        j = J.from_scipy(sp, cap=CAP)
        t = T.from_scipy(sp, cap=CAP, res=CPU)
        _equal(j, t, COO_FIELDS)
        _equal(j, _port_coo(j), COO_FIELDS)
        np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))

    def test_duplicates_sum_in_entry_order(self):
        """todense of repeated entries equals JAX's scatter-add bit for bit
        (a sequential sum in entry order)."""
        j = _dup_coo(3)
        t = _port_coo(j)
        np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))
        # and the order is the entries': a float32 loop gives the same bits
        ref = np.zeros((9, 7), np.float32)
        nnz = int(j.nnz)
        for r, c, v in zip(np.asarray(j.rows)[:nnz], np.asarray(j.cols)[:nnz],
                           np.asarray(j.vals)[:nnz]):
            ref[r, c] = np.float32(ref[r, c] + v)
        np.testing.assert_array_equal(t.todense().numpy(), ref)

    def test_to_numpy_round_trips(self):
        j, t = _pair_csr(_scipy(4, 12, 15))
        back = T.make_csr(**t.to_numpy(), res=CPU)
        _equal(t, back, CSR_FIELDS)
        coo = _port_coo(J.csr_to_coo(j))
        _equal(coo, T.make_coo(**coo.to_numpy(), res=CPU), COO_FIELDS)
        # the JAX package takes the port's fields back
        jj = J.CsrMatrix(*(jnp.asarray(v) for k, v in t.to_numpy().items() if k != "shape"),
                         t.shape)
        _equal(j, jj, CSR_FIELDS)

    def test_make_checks_and_default_device(self):
        with pytest.raises(RaftError, match="cap"):
            T.make_coo([0, 1], [0, 1], [1.0, 2.0], (2, 2), cap=1, res=CPU)
        with pytest.raises(RaftError, match="indptr"):
            T.make_csr([0, 1], [0], [1.0], (2, 2), res=CPU)
        if not torch.cuda.is_available():
            with pytest.raises(RaftError, match="CUDA"):
                T.make_coo([0], [0], [1.0], (1, 1))
        t = T.make_coo(np.array([0]), np.array([1]), np.array([2.0]), (2, 2), res=CPU)
        assert t.vals.dtype == torch.float32 and t.device.type == "cpu"


class TestConvert:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sort_coo_with_duplicates(self, seed):
        j = _dup_coo(seed)
        _equal(J.sort_coo(j), T.sort_coo(_port_coo(j)), COO_FIELDS)

    @pytest.mark.parametrize("assume_sorted", [False, True])
    def test_coo_to_csr(self, assume_sorted):
        sp = sps.random(12, 15, density=0.25, format="coo", dtype=np.float32,
                        random_state=np.random.RandomState(5))
        j = J.from_scipy(sp.tocoo(), cap=CAP)
        if assume_sorted:
            j = J.sort_coo(j)
        _equal(J.coo_to_csr(j, assume_sorted), T.coo_to_csr(_port_coo(j), assume_sorted),
               CSR_FIELDS)

    def test_csr_to_coo(self):
        j, t = _pair_csr(_scipy(6, 12, 15))
        _equal(J.csr_to_coo(j), T.csr_to_coo(t), COO_FIELDS)

    @pytest.mark.parametrize("cap", [None, 20, 5])
    def test_dense_to_coo_and_csr(self, cap):
        rng = np.random.default_rng(7)
        x = rng.random((9, 7), dtype=np.float32)
        x[x < 0.5] = 0
        xt = torch.from_numpy(x)
        _equal(J.dense_to_coo(jnp.asarray(x), cap), T.dense_to_coo(xt, cap), COO_FIELDS)
        _equal(J.dense_to_csr(jnp.asarray(x), cap), T.dense_to_csr(xt, cap), CSR_FIELDS)
        if cap is None:
            assert int(T.dense_to_csr(xt).nnz) == (x != 0).sum()
            np.testing.assert_array_equal(T.csr_to_dense(T.dense_to_csr(xt)).numpy(), x)
            np.testing.assert_array_equal(T.coo_to_dense(T.dense_to_coo(xt)).numpy(), x)

    def test_adj_to_csr(self):
        adj = np.random.default_rng(8).random((6, 6)) < 0.4
        j = J.adj_to_csr(jnp.asarray(adj))
        t = T.adj_to_csr(torch.from_numpy(adj))
        _equal(j, t, CSR_FIELDS)
        np.testing.assert_array_equal(t.todense().numpy() != 0, adj)


class TestOps:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sum_duplicates(self, seed):
        j = J.sort_coo(_dup_coo(seed))
        a, b = J.sum_duplicates(j), T.sum_duplicates(_port_coo(j))
        _equal(a, b, ("rows", "cols", "nnz"))
        np.testing.assert_allclose(b.vals.numpy(), np.asarray(a.vals), rtol=SUM_RTOL)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_max_duplicates(self, seed):
        j = J.sort_coo(_dup_coo(seed))
        _equal(J.max_duplicates(j), T.max_duplicates(_port_coo(j)), COO_FIELDS)

    def test_sum_duplicates_small_case(self):
        rows = np.array([0, 0, 1, 1, 1, 2], np.int32)
        cols = np.array([1, 1, 0, 0, 2, 2], np.int32)
        vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
        out = T.sum_duplicates(T.sort_coo(T.make_coo(rows, cols, vals, (3, 3), cap=10,
                                                     res=CPU)))
        assert int(out.nnz) == 4
        expect = np.zeros((3, 3), np.float32)
        np.add.at(expect, (rows, cols), vals)
        np.testing.assert_array_equal(out.todense().numpy(), expect)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_filter_and_remove_zeros(self, seed):
        j = _dup_coo(seed)
        j = J.CooMatrix(j.rows, j.cols, j.vals.at[::3].set(0.0), j.nnz, j.shape)
        t = _port_coo(j)
        _equal(J.remove_zeros(j), T.remove_zeros(t), COO_FIELDS)
        keep = np.asarray(j.vals) > 0
        _equal(J.filter_entries(j, jnp.asarray(keep)),
               T.filter_entries(t, torch.from_numpy(keep)), COO_FIELDS)

    @pytest.mark.parametrize("start,stop", [(3, 8), (0, 12), (11, 12)])
    def test_slice_rows(self, start, stop):
        j, _ = _pair_csr(_scipy(9, 12, 15))
        jc = J.csr_to_coo(j)
        _equal(J.slice_rows(jc, start, stop), T.slice_rows(_port_coo(jc), start, stop),
               COO_FIELDS)


class TestLinalg:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_spmm_and_spmv(self, seed):
        j, t = _pair_csr(_scipy(seed, 12, 15))
        rng = np.random.default_rng(seed)
        b = rng.random((15, 6), dtype=np.float32)
        v = rng.random(15, dtype=np.float32)
        np.testing.assert_allclose(T.spmm(t, torch.from_numpy(b)).numpy(),
                                   np.asarray(J.spmm(j, jnp.asarray(b))), rtol=SUM_RTOL)
        np.testing.assert_allclose(T.spmv(t, torch.from_numpy(v)).numpy(),
                                   np.asarray(J.spmv(j, jnp.asarray(v))), rtol=SUM_RTOL)
        sp = _scipy(seed, 12, 15)
        np.testing.assert_allclose(T.spmm(t, torch.from_numpy(b)).numpy(), sp @ b,
                                   rtol=1e-5, atol=1e-5)

    def test_add(self):
        ja, ta = _pair_csr(_scipy(10, 12, 12))
        jb, tb = _pair_csr(_scipy(11, 12, 12))
        a, b = J.add(ja, jb), T.add(ta, tb)
        _equal(a, b, ("indptr", "indices"))
        np.testing.assert_allclose(b.data.numpy(), np.asarray(a.data), rtol=SUM_RTOL)

    def test_degree(self):
        j, t = _pair_csr(_scipy(12, 12, 12))
        np.testing.assert_array_equal(T.degree(t).numpy(), np.asarray(J.degree(j)))
        jc = J.csr_to_coo(j)
        np.testing.assert_array_equal(T.degree(_port_coo(jc)).numpy(), np.asarray(J.degree(jc)))

    @pytest.mark.parametrize("norm", ["l1", "l2", "linf"])
    def test_row_norm_and_normalize(self, norm):
        j, t = _pair_csr(_scipy(13, 12, 15, density=0.4))
        np.testing.assert_allclose(T.row_norm(t, norm).numpy(), np.asarray(J.row_norm(j, norm)),
                                   rtol=SUM_RTOL)
        a, b = J.normalize_rows(j, norm), T.normalize_rows(t, norm)
        _equal(a, b, ("indptr", "indices"))
        np.testing.assert_allclose(b.data.numpy(), np.asarray(a.data), rtol=SUM_RTOL)

    def test_unknown_norm_raises(self):
        _, t = _pair_csr(_scipy(13, 12, 12))
        with pytest.raises(RaftError, match="unknown norm"):
            T.row_norm(t, "l3")

    @pytest.mark.parametrize("shape", [(12, 15), (15, 12)])
    def test_transpose(self, shape):
        j, t = _pair_csr(_scipy(14, *shape))
        _equal(J.transpose(j), T.transpose(t), CSR_FIELDS)

    @pytest.mark.parametrize("mode", ["sum", "max"])
    def test_symmetrize(self, mode):
        j, t = _pair_csr(_scipy(15, 12, 12))
        a, b = J.symmetrize(j, mode), T.symmetrize(t, mode)
        _equal(a, b, ("indptr", "indices"))
        np.testing.assert_allclose(b.data.numpy(), np.asarray(a.data), rtol=SUM_RTOL)

    @pytest.mark.parametrize("normalized", [False, True])
    def test_laplacian(self, normalized):
        j, t = _pair_csr(_scipy(16, 12, 12))
        js, ts = J.symmetrize(j, "sum"), T.symmetrize(t, "sum")
        a, b = J.laplacian(js, normalized), T.laplacian(ts, normalized)
        _equal(a, b, ("indptr", "indices"))
        np.testing.assert_allclose(b.data.numpy(), np.asarray(a.data), rtol=SUM_RTOL, atol=1e-7)
        dense = ts.todense().numpy()
        d = dense.sum(1)
        if normalized:
            dinv = np.where(d > 0, 1 / np.sqrt(d), 0)
            expect = np.eye(12) - dinv[:, None] * dense * dinv[None, :]
        else:
            expect = np.diag(d) - dense
        np.testing.assert_allclose(b.todense().numpy(), expect, rtol=1e-5, atol=1e-5)
