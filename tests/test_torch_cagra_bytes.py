"""CAGRA's byte build: raft_tpu_torch.neighbors.cagra.build over int8 and
uint8 datasets against raft_tpu's.

Both packages store a byte dataset as signed bytes (uint8 shifted by -128)
and build the graph on its float32 image (raft_tpu/neighbors/cagra.py:
622-650), so the port's byte build equals its build of that image, graph
for graph. The JAX package's byte index loads into the port from its file
(byte for byte both ways) and searches the same; the port's own byte build
is held to the JAX build's recall against the stored bytes' exact
neighbours. The port's search over int8 rows runs ``cagra_hop``'s plain
version on CPU tensors (the kernel on the card, tests/test_torch_gpu.py).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.neighbors import cagra as jc
from raft_tpu.random.rng import as_key
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import cagra as tc

CPU = Resources(device="cpu")
PARAMS = dict(intermediate_graph_degree=32, graph_degree=16, seed=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain hop is thousands of small ops: one torch thread a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    x = rng.random((1500, 16))
    q = rng.random((40, 16))
    xs, qs = (np.round(a * 255 - 128).astype(np.int8) for a in (x, q))
    xu, qu = (np.round(a * 255).astype(np.uint8) for a in (x, q))
    d2 = ((qs.astype(np.float64)[:, None] - xs[None]) ** 2).sum(-1)
    return xs, qs, xu, qu, np.argsort(d2, axis=1, kind="stable")[:, :10]


@pytest.fixture(scope="module")
def jax_index(data):
    xs = data[0]
    return jc.build(jc.IndexParams(**PARAMS), jnp.asarray(xs))


@pytest.fixture(scope="module")
def port_index(data):
    return tc.build(tc.IndexParams(**PARAMS), data[0], res=CPU)


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / gt.shape[1]
                    for r in range(gt.shape[0])])


@pytest.mark.parametrize("kind", ["int8", "uint8"])
def test_byte_build_is_the_float_images_graph(data, port_index, kind):
    xs, _, xu, _, _ = data
    if kind == "int8":
        index, image = port_index, xs.astype(np.float32)
    else:
        index = tc.build(tc.IndexParams(**PARAMS), xu, res=CPU)
        image = xu.astype(np.float32) - 128.0
    assert index.dataset.dtype == torch.int8 and index.data_kind == kind
    assert torch.equal(index.dataset.to(torch.float32), torch.from_numpy(image))
    float_built = tc.build(tc.IndexParams(**PARAMS), image, res=CPU)
    assert torch.equal(index.graph, float_built.graph)
    assert index.seed_pool_hint == float_built.seed_pool_hint


def test_jax_byte_index_loads_and_searches_the_same(data, jax_index, tmp_path):
    _, qs, _, _, _ = data
    path = str(tmp_path / "jax.bin")
    jc.save(jax_index, path)
    tindex = tc.load(path, res=CPU)
    assert tindex.dataset.dtype == torch.int8 and tindex.data_kind == "int8"
    buf = io.BytesIO()
    tc.write_index(buf, tindex)
    assert buf.getvalue() == open(path, "rb").read()
    # the port's search handed the entry pool the JAX package draws
    pool, seed = 1024, 7
    jd, ji = jc.search(jc.SearchParams(itopk_size=32, seed_pool=pool, seed=seed,
                                       hop_impl="xla"), jax_index, jnp.asarray(qs), 10)
    pool_ids = np.array(jax.random.choice(as_key(seed), tindex.size, (pool,), replace=False))
    for impl in ("xla", "fused_arena"):
        td, ti = tc._cagra_search(tindex, torch.from_numpy(qs), 10, 32, 42, 1, False,
                                  seed_pool=pool, hop_impl=impl, pool_ids=pool_ids)
        assert _recall(ti, np.asarray(ji)) >= 0.99, impl
        np.testing.assert_allclose(np.sort(td.numpy(), 1), np.sort(np.asarray(jd), 1),
                                   rtol=1e-4, atol=1e-4)


def test_port_byte_index_loads_in_jax(data, port_index, tmp_path):
    _, qs, _, _, _ = data
    path = str(tmp_path / "port.bin")
    tc.save(port_index, path)
    jindex = jc.load(path)
    assert jindex.data_kind == "int8" and str(jindex.dataset.dtype) == "int8"
    np.testing.assert_array_equal(np.asarray(jindex.graph), port_index.graph.numpy())
    buf = io.BytesIO()
    jc.write_index(buf, jindex)
    assert buf.getvalue() == open(path, "rb").read()


def test_port_byte_build_recall_matches_jax(data, jax_index, port_index):
    """Against the stored bytes' exact neighbours, on the kernel hop route
    (int8 rows) and the "xla" route."""
    _, qs, _, _, gt = data
    _, ji = jc.search(jc.SearchParams(itopk_size=32), jax_index, jnp.asarray(qs), 10)
    for impl in ("fused_arena", "xla"):
        _, ti = tc.search(tc.SearchParams(itopk_size=32, hop_impl=impl), port_index, qs, 10,
                          res=CPU)
        assert _recall(ti, gt) >= _recall(ji, gt) - 0.03, impl


def test_byte_index_takes_its_own_dtype(data, port_index):
    _, qs, _, qu, _ = data
    with pytest.raises(RaftError, match="stores int8"):
        tc.search(tc.SearchParams(itopk_size=32), port_index, qu, 10, res=CPU)
    d_b, i_b = tc.search(tc.SearchParams(itopk_size=32), port_index, qs, 10, res=CPU)
    d_f, i_f = tc.search(tc.SearchParams(itopk_size=32), port_index, qs.astype(np.float32), 10,
                         res=CPU)
    assert torch.equal(i_b, i_f) and torch.equal(d_b, d_f)
