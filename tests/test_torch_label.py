"""raft_tpu_torch.label against raft_tpu.label on the CPU, exactly.

The same numpy labels, made from a seed, go through both packages; every
output is equal, element for element. ``merge_labels`` also gives the
partition of the union graph's connected components (scipy).
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csgraph
import torch

import jax.numpy as jnp

from raft_tpu import label as jlab
from raft_tpu_torch import label as tlab
from raft_tpu_torch.core import RaftError, Resources

# the module, which the function of the same name shadows in the package
tmerge = importlib.import_module("raft_tpu_torch.label.merge_labels")

CPU = Resources(device="cpu")
MAX = np.iinfo(np.int32).max


def eq(got, want):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def test_unique_labels(rng):
    y = rng.choice([-4, 0, 3, 17, 99], 500).astype(np.int32)
    eq(tlab.unique_labels(y, res=CPU), jlab.unique_labels(y))
    out, n = tlab.unique_labels_padded(y, res=CPU)
    jout, jn = jlab.unique_labels_padded(jnp.asarray(y))
    assert n.dtype == torch.int32 and int(n) == int(jn) == 5
    eq(out, jout)
    yf = rng.choice([0.5, -1.0, 2.25], 50).astype(np.float32)
    eq(tlab.unique_labels_padded(yf, res=CPU)[0], jlab.unique_labels_padded(jnp.asarray(yf))[0])


def test_ovr_labels(rng):
    y = rng.integers(0, 4, 40).astype(np.int32)
    uniq = np.arange(4, dtype=np.int32)
    for idx in range(4):
        eq(tlab.get_ovr_labels(y, uniq, idx, res=CPU),
           jlab.get_ovr_labels(jnp.asarray(y), jnp.asarray(uniq), idx))
    eq(tlab.get_ovr_labels(y, uniq, 1, one=5, zero=-1, res=CPU),
       jlab.get_ovr_labels(jnp.asarray(y), jnp.asarray(uniq), 1, one=5, zero=-1))
    with pytest.raises(RaftError, match=r"ovr index 4 out of range \[0, 4\)"):
        tlab.get_ovr_labels(y, uniq, 4, res=CPU)


@pytest.mark.parametrize("zero_based", [False, True])
def test_make_monotonic(rng, zero_based):
    y = rng.choice([7, 3, 3, 100, -2, 55], (30, 4)).astype(np.int32)
    got = tlab.make_monotonic(y, zero_based=zero_based, res=CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == (30, 4)
    eq(got, jlab.make_monotonic(y, zero_based=zero_based))
    # a filter keeps the sentinel -2 as it is; it shifts no kept label
    eq(tlab.make_monotonic(y, filter_op=lambda t: t >= 0, zero_based=zero_based, res=CPU),
       jlab.make_monotonic(y, filter_op=lambda t: t >= 0, zero_based=zero_based))
    yf = rng.choice([0.5, -1.5, 8.0], 25).astype(np.float32)
    eq(tlab.make_monotonic(yf, filter_op=lambda t: t > 0, res=CPU),
       jlab.make_monotonic(yf, filter_op=lambda t: t > 0))


def test_merge_small_cases():
    cases = [([1, 1, 3, 3], [1, 2, 2, 4], [True] * 4),
             ([1, 1, 3, 3], [1, 3, 3, 3], [True, False, True, True]),
             ([1, MAX, 3, 3], [1, 1, MAX, 3], [True, True, True, False])]
    for a, b, m in cases:
        a, b, m = np.asarray(a, np.int32), np.asarray(b, np.int32), np.asarray(m)
        eq(tlab.merge_labels(a, b, m, res=CPU), jlab.merge_labels(a, b, m))
    with pytest.raises(RaftError, match="shape mismatch"):
        tlab.merge_labels(np.ones(3, np.int32), np.ones(4, np.int32), np.ones(3, bool), res=CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_is_union_graph_components(seed):
    n = 300
    a = sps.random(n, n, density=0.004, random_state=seed, format="csr")
    b = sps.random(n, n, density=0.004, random_state=seed + 100, format="csr")
    _, ca = csgraph.connected_components(a + a.T, directed=False)
    _, cb = csgraph.connected_components(b + b.T, directed=False)
    _, cu = csgraph.connected_components(a + a.T + b + b.T, directed=False)
    # canonical 1..N labels: the smallest vertex of the component, plus 1
    first = lambda c: np.array([np.flatnonzero(c == c[i])[0] + 1 for i in range(n)], np.int32)  # noqa: E731
    la, lb = first(ca), first(cb)
    mask = np.random.default_rng(seed).random(n) < 0.9
    la[::37] = MAX                                 # unlabelled points
    got = tlab.merge_labels(la, lb, mask, res=CPU)
    eq(got, jlab.merge_labels(la, lb, mask))
    out, rounds = tmerge._merge(torch.from_numpy(la), torch.from_numpy(lb),
                                torch.from_numpy(mask), MAX)
    assert torch.equal(out, got) and rounds >= 1
    # all kept: the partition is the union graph's
    full = tlab.merge_labels(first(ca), lb, np.ones(n, bool), res=CPU).numpy()
    assert all(((full == full[i]) == (cu == cu[i])).all() for i in range(n))
