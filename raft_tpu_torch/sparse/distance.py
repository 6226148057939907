"""Sparse pairwise distances.

Counterpart of raft_tpu/sparse/distance.py (reference: raft/sparse/distance/
distance.cuh, pairwiseDistance and its supported-metric list :37-54). The
rows of ``x`` go through a fixed-width ELL layout, one row tile at a time,
into a dense block (:func:`_densify`) scored against the densified ``y`` by
the dense layer's own metric functions (``distance/pairwise.py``), so sparse
and dense inputs give the same numbers. The tile is ``_choose_tile``'s, as
in the JAX package, and a short last tile is padded to the tile's rows, so
every tile has the JAX tile's shape.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance import pairwise as _pw
from ..distance.types import DistanceType, resolve_metric
from .types import CsrMatrix, scatter_sum_dense

__all__ = ["pairwise_distance", "csr_to_ell", "SPARSE_SUPPORTED"]

_f32 = torch.float32

# reference: sparse/distance/distance.cuh:37-54
SPARSE_SUPPORTED = frozenset({
    DistanceType.L2Expanded,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.InnerProduct,
    DistanceType.L1,
    DistanceType.Canberra,
    DistanceType.Linf,
    DistanceType.LpUnexpanded,
    DistanceType.JaccardExpanded,
    DistanceType.CosineExpanded,
    DistanceType.HellingerExpanded,
    DistanceType.DiceExpanded,
    DistanceType.CorrelationExpanded,
    DistanceType.RusselRaoExpanded,
    DistanceType.HammingUnexpanded,
    DistanceType.JensenShannon,
    DistanceType.KLDivergence,
})

# the metrics scored by a (tile, m, d) broadcast; the rest are GEMM-shaped
_ELEMENTWISE = frozenset({
    DistanceType.L1, DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
    DistanceType.Linf, DistanceType.Canberra, DistanceType.LpUnexpanded,
    DistanceType.HammingUnexpanded, DistanceType.JensenShannon,
})


def csr_to_ell(csr: CsrMatrix, width: int | None = None):
    """CSR -> fixed-width ELL: (idx (n, w) padded with shape[1], val (n, w)).
    ``width`` defaults to the longest row (read back once)."""
    n, m = csr.shape
    deg = csr.indptr[1:] - csr.indptr[:-1]
    w = int(width) if width is not None else (int(deg.max()) if csr.cap and n else 0)
    w = max(w, 1)
    pos = torch.arange(csr.cap, dtype=torch.int64, device=csr.device)
    rows = csr.row_ids().to(torch.int64)
    within = pos - csr.indptr.to(torch.int64)[torch.clamp_max(rows, n)]
    ok = (rows < n) & (within < w)
    flat = torch.where(ok, rows * w + within, n * w)
    idx = torch.full((n * w + 1,), m, dtype=torch.int32, device=csr.device)
    val = torch.zeros((n * w + 1,), dtype=csr.data.dtype, device=csr.device)
    idx[flat] = csr.indices
    val[flat] = csr.data
    return idx[:-1].reshape(n, w), val[:-1].reshape(n, w)


def _densify(ell_idx, ell_val, d: int):
    """(t, w) ELL rows -> (t, d) float32 dense block; padding (idx == d)
    is dropped, repeated columns sum in a fixed order."""
    t, w = ell_idx.shape
    rows = torch.arange(t, dtype=torch.int32, device=ell_idx.device)[:, None].expand(t, w)
    return scatter_sum_dense(rows.reshape(-1), ell_idx.reshape(-1),
                             ell_val.reshape(-1).to(_f32), (t, d))


def _dense_block(metric: DistanceType, metric_arg: float, xd, yd):
    """A dense (t, d) block against dense (m, d), by the dense layer's metric
    functions."""
    if metric == DistanceType.L2Expanded:
        return _pw._l2_expanded(xd, yd, sqrt=False)
    if metric == DistanceType.L2SqrtExpanded:
        return _pw._l2_expanded(xd, yd, sqrt=True)
    if metric in _pw._EXPANDED:
        return _pw._EXPANDED[metric](xd, yd)
    ew = {
        DistanceType.L1: _pw._ew_l1,
        DistanceType.L2Unexpanded: _pw._ew_l2(False),
        DistanceType.L2SqrtUnexpanded: _pw._ew_l2(True),
        DistanceType.Linf: _pw._ew_linf,
        DistanceType.Canberra: _pw._ew_canberra,
        DistanceType.LpUnexpanded: _pw._ew_lp(metric_arg),
        DistanceType.HammingUnexpanded: _pw._ew_hamming,
        DistanceType.JensenShannon: _pw._ew_jensenshannon,
    }[metric]
    return ew(xd[:, None, :], yd[None, :, :])


def ell_tiles(idx, val, tile: int, d: int):
    """(idx, val) tiles of ``tile`` rows, the last padded to ``tile`` rows
    of padding entries (idx == d), as the JAX package pads them."""
    n = idx.shape[0]
    for i in range(0, n, tile):
        ti, tv = idx[i:i + tile], val[i:i + tile]
        short = tile - ti.shape[0]
        if short:
            ti = torch.cat([ti, ti.new_full((short, ti.shape[1]), d)])
            tv = torch.cat([tv, tv.new_zeros((short, tv.shape[1]))])
        yield ti, tv


def _tile_for(metric: DistanceType, m: int, n: int, d: int, res: Resources) -> int:
    return _pw._choose_tile(m, n, d if metric in _ELEMENTWISE else 1, res.workspace_bytes)


def on_device_of(x, res: Resources | None) -> Resources:
    """The handle for work on sparse ``x``'s device: ``res`` (which must
    name that device) or the default handle, for its workspace budget."""
    if res is not None:
        res.check_holds(x.device, "the sparse matrix")
    return res or default_resources()


def _checked(x: CsrMatrix, y: CsrMatrix, metric):
    mt = resolve_metric(metric)
    expects(mt in SPARSE_SUPPORTED, "metric %s unsupported for sparse inputs", mt.name)
    expects(x.shape[1] == y.shape[1], "feature dims must match: %d vs %d",
            x.shape[1], y.shape[1])
    expects(x.device == y.device, "x lives on %s, y on %s", x.device, y.device)
    return mt


def pairwise_distance(x: CsrMatrix, y: CsrMatrix | None = None, metric="euclidean",
                      metric_arg: float = 2.0, res: Resources | None = None):
    """All-pairs distances between CSR row sets (reference:
    raft::sparse::distance::pairwiseDistance, sparse/distance/distance.cuh:60),
    on the matrices' device (a ``res`` naming another device raises; it
    gives the workspace budget). Returns an (n, m) float32 dense tensor, equal to the dense
    ``pairwise_distance`` of the densified inputs."""
    y = x if y is None else y
    mt = _checked(x, y, metric)
    res = on_device_of(x, res)
    d = x.shape[1]
    xi, xv = csr_to_ell(x)
    yd = y.todense().to(_f32)
    tile = _tile_for(mt, x.shape[0], y.shape[0], d, res)
    out = [_dense_block(mt, float(metric_arg), _densify(ti, tv, d), yd)
           for ti, tv in ell_tiles(xi, xv, tile, d)]
    return torch.cat(out)[:x.shape[0]]
