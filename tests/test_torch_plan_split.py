"""Lists that split past ``obs.mem.plan()``'s price: the JAX package's build
holds them; the port's build holds to the price.

``plan()`` prices ``n_lists`` lists at the capacity bound; a list past the
bound splits into more lists of that capacity. On uniform uint8 rows at
d = 128, with about 190 trainset rows a list and four k-means iterations
(the ratio of ``chip_smoke.py``'s 10M x 128 cell: 200k trainset rows for
1,024 lists), both packages' trainers leave many lists past the bound. The
JAX build splits them at the bound and holds more than 1.2x the price. The
port's build splits them at ``_list_utils.priced_capacity``, the largest
capacity whose split holds at most 1.2x the price, which is the JAX bound
wherever the JAX split stays within 1.2x. The port's trainer draws other rows than the JAX one, so
the two packages' list counts at the bound are held close, not equal;
``tests/plan_split_witness.py`` repeats this at 2M and 10M rows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.obs import mem as jmem
from raft_tpu_torch.core import Resources, chunked
from raft_tpu_torch.neighbors import _list_utils as lu
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.obs import mem

pytestmark = pytest.mark.ooc

N, D = 60_000, 128
PARAMS = dict(n_lists=256, kmeans_n_iters=4, kmeans_trainset_fraction=0.8, seed=0)
CPU = Resources(device="cpu")


def _index_bytes(ix) -> int:
    return sum(int(np.prod(a.shape)) * np.dtype(str(a.dtype).split(".")[-1]).itemsize
               for a in (ix.centers, ix.list_data, ix.list_ids, ix.list_norms, ix.list_sizes))


def _parent_sizes(ix) -> np.ndarray:
    """Rows of each list asked: sub-lists of one list share its center and
    sit next to each other."""
    c = torch.as_tensor(np.array(ix.centers))
    new = torch.ones(c.shape[0], dtype=torch.bool)
    new[1:] = (c[1:] != c[:-1]).any(dim=1)
    parent = torch.cumsum(new.to(torch.int64), 0) - 1
    sizes = torch.as_tensor(np.array(ix.list_sizes)).to(torch.int64)
    return torch.zeros(int(parent[-1]) + 1, dtype=torch.int64).index_add_(0, parent,
                                                                         sizes).numpy()


def _price():
    price = mem.plan("ivf_flat", ivf_flat.IndexParams(**PARAMS), N, D, dtype="uint8")
    return price, price["breakdown"]["list_data"] // (PARAMS["n_lists"] * D)


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).integers(0, 256, (N, D), dtype=np.uint8)


@pytest.fixture(scope="module")
def builds(rows):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = ivf_flat.build(ivf_flat.IndexParams(**PARAMS), rows, res=CPU)
    finally:
        torch.set_num_threads(threads)
    return port, jflat.build(jflat.IndexParams(**PARAMS), rows)


def test_plan_prices_the_lists_asked_in_both_packages():
    price, cap = _price()
    want = jmem.plan("ivf_flat", jflat.IndexParams(**PARAMS), N, D, dtype="uint8")
    assert price["index_bytes"] == want["index_bytes"]
    assert cap * PARAMS["n_lists"] * D == price["breakdown"]["list_data"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_both_builds_split_past_the_price(builds, package):
    """Both trainers leave lists whose split at the bound holds more than 1.2x
    plan()'s list slots: the JAX build holds that split, the port's build
    re-splits below the bound."""
    ix = builds[0 if package == "port" else 1]
    price, cap = _price()
    sizes = _parent_sizes(ix)
    assert len(sizes) == PARAMS["n_lists"] and int(sizes.sum()) == N
    assert lu._slots(sizes, cap) > 1.2 * PARAMS["n_lists"] * cap, package
    assert int(ix.list_data.shape[0]) > PARAMS["n_lists"]
    if package == "jax":
        assert int(ix.list_data.shape[1]) == cap
        assert _index_bytes(ix) > 1.2 * price["index_bytes"], _index_bytes(ix)
    else:
        assert int(ix.list_data.shape[1]) < cap


def test_the_two_builds_split_alike(builds):
    """Split at the bound, the port's lists are within 10% as many as the
    JAX build's."""
    port, jax_ix = builds
    _, cap = _price()
    at_bound = int(np.maximum(1, -(-_parent_sizes(port) // cap)).sum())
    assert abs(at_bound - int(jax_ix.list_data.shape[0])) <= 0.1 * int(
        jax_ix.list_data.shape[0]), (at_bound, int(jax_ix.list_data.shape[0]))


def test_port_build_holds_to_the_price(builds):
    """The port's list slots, at priced_capacity of its list sizes, and the
    bytes of its per-slot arrays stay within 1.2x plan()'s."""
    port = builds[0]
    price, cap = _price()
    sizes = _parent_sizes(port)
    slots = int(port.list_data.shape[0]) * int(port.list_data.shape[1])
    assert int(port.list_data.shape[1]) == lu.priced_capacity(sizes, cap)
    assert slots == lu._slots(sizes, int(port.list_data.shape[1]))
    assert slots <= 1.2 * PARAMS["n_lists"] * cap
    per_slot = sum(int(np.prod(a.shape)) * a.element_size()
                   for a in (port.list_data, port.list_ids, port.list_norms))
    bk = price["breakdown"]
    assert per_slot <= 1.2 * (bk["list_data"] + bk["list_ids"] + bk["list_norms"])
    assert int(port.list_sizes.sum()) == N and int(port.list_sizes.max()) <= port.capacity


def test_priced_split_streams_bit_for_bit(builds, rows):
    """A streamed build lands on the same priced split and the same
    searches as the in-core one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        streamed = ivf_flat.build(ivf_flat.IndexParams(**PARAMS),
                                  chunked.ChunkedReader(rows, chunk_rows=15_000), res=CPU)
        port = builds[0]
        for name in ("centers", "list_data", "list_ids", "list_norms", "list_sizes"):
            assert torch.equal(getattr(streamed, name), getattr(port, name)), name
        q = rows[::600]
        sp = ivf_flat.SearchParams(n_probes=16)
        got, want = (ivf_flat.search(sp, ix, q, 10, res=CPU) for ix in (streamed, port))
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1][:, 0] == torch.arange(0, N, 600)).all())   # each row finds itself


@pytest.mark.parametrize("case", ["within", "past", "tiny"])
def test_priced_capacity(case):
    """The bound while its split stays within 1.2x the price; past it the
    largest multiple of 8 whose split does; where none does, the one with
    the fewest slots."""
    if case == "within":
        sizes, cap = np.array([100] * 9 + [150]), 128       # 11 lists of 128: 1.1x
        assert lu.priced_capacity(sizes, cap) == cap
    elif case == "past":
        sizes, cap = np.array([100, 100, 140, 140, 20, 20]), 112   # 8 x 112: 1.33x
        got = lu.priced_capacity(sizes, cap)
        assert got == 80 and lu._slots(sizes, got) <= 1.2 * 6 * cap
        assert all(lu._slots(sizes, c) > 1.2 * 6 * cap for c in range(got + 8, cap + 1, 8))
    else:
        assert lu.priced_capacity(np.array([1, 30]), 8) == 8
