"""raft_tpu_torch.parallel.cagra against raft_tpu.parallel.cagra.

A sharded index the JAX package builds (``build`` over
``Comms(Mesh(devices[:S]), "data")``, S = 2 and 4) is carried to the port
(``parallel.cagra.from_state``) and searched by the port's ranks, each
shard's beam handed the entry pool the JAX package draws for the same seed
(as tests/test_torch_cagra.py holds single-device CAGRA): ids equal, and
distances within rtol 1e-4 / atol 1e-4, on the ``"xla"`` hop route and on
the ``cagra_hop`` kernel's route (its plain version here, the JAX kernel in
interpret mode). The port's own ``build`` and ``build_merged`` are held at
the JAX tests' recall floors (tests/test_comms.py:523-, tests/test_cagra.py
:596-679), and ``merged_builder`` folds a ``MutableIndex`` across the ranks.

The port's world is one RankPool of four spawned gloo ranks on the CPU.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from raft_tpu.comms import Comms as JComms
from raft_tpu.neighbors import cagra as jc
from raft_tpu.parallel import cagra as jpcagra
from raft_tpu.random.rng import as_key
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.core.platform import RankPool
from raft_tpu_torch.neighbors import cagra as tc
from raft_tpu_torch.parallel import cagra as tpcagra

import torch_rank_tasks as tasks

CPU = Resources(device="cpu")
PARAMS = dict(graph_degree=8, intermediate_graph_degree=16, build_n_lists=4,
              build_n_probes=4)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu", timeout_s=120) as p:
        yield p


def jcomms(S):
    return JComms(Mesh(np.array(jax.devices()[:S]), ("data",)), "data")


def on(pool, S, fn, *args, **kwargs):
    out = pool.run(fn, S, *args, **kwargs)
    assert all(o is None for o in out[S:]), out[S:]
    for o in out[1:S]:                      # every rank answers alike
        if isinstance(o, tuple):
            for a, b in zip(out[0], o):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    return out[0]


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / gt.shape[1]
                    for r in range(gt.shape[0])])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    x = rng.random((512, 16)).astype(np.float32)
    q = rng.random((16, 16)).astype(np.float32)
    d2 = ((q.astype(np.float64)[:, None] - x.astype(np.float64)[None]) ** 2).sum(-1)
    return x, q, d2


@pytest.fixture(scope="module")
def jax_sharded(data):
    x, _, _ = data
    return {S: jpcagra.build(jcomms(S), jc.IndexParams(**PARAMS), x) for S in (2, 4)}


def _jax_entries(params, rows):
    """The entry ids the JAX package's beam draws for ``params`` over a
    shard of ``rows`` rows (the scored pool, or the shared random entries)."""
    seed_pool = jc.resolve_seed_pool(params)
    width, deg = params.search_width, PARAMS["graph_degree"]
    n_init = min(max(params.itopk_size, width * deg), rows)
    pool = min(seed_pool, rows)
    size = pool if pool > n_init else n_init
    return np.array(jax.random.choice(as_key(params.seed), rows, (size,), replace=False))


@pytest.mark.parametrize("S,impl", [(2, "xla"), (4, "xla"), (2, "fused_arena")])
def test_search_on_jax_shards_matches_jax(pool, data, jax_sharded, monkeypatch, S, impl):
    if impl != "xla":
        monkeypatch.setenv("RAFT_TPU_CAGRA_HOP_INTERPRET", "1")
    _, q, _ = data
    jindex = jax_sharded[S]
    sp = dict(itopk_size=16, hop_impl=impl)
    jd, ji = jpcagra.search(jcomms(S), jc.SearchParams(**sp), jindex, q, k=5)
    entries = _jax_entries(jc.SearchParams(**sp), jindex.rows_per_shard)
    meta = dict(metric=int(jindex.metric), data_kind=jindex.data_kind)
    td, ti = on(pool, S, tasks.cagra_search_state, np.asarray(jindex.dataset),
                np.asarray(jindex.graph), meta, sp, q, 5, pool_ids=entries)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [2, 4])
def test_build_and_search_recall(pool, data, S):
    x, q, d2 = data
    idx = on(pool, S, tasks.call, "parallel.cagra.build", tc.IndexParams(**PARAMS), x, res=CPU)
    assert idx.n_shards == S and idx.rows_per_shard == 512 // S
    assert tuple(idx.graph.shape) == (S, 512 // S, PARAMS["graph_degree"])
    g = idx.graph.numpy()
    assert g.min() >= 0 and g.max() < 512 // S              # shard-local ids
    # every shard keeps its rows in the original order
    np.testing.assert_array_equal(idx.dataset.numpy().reshape(512, 16), x)
    d, i = on(pool, S, tasks.call, "parallel.cagra.search",
              tc.SearchParams(itopk_size=16), idx, q, 5)
    gt = np.argsort(d2, axis=1)[:, :5]
    assert _recall(i, gt) > 0.95
    # global ids agree with the distances reported for them
    np.testing.assert_allclose(np.take_along_axis(d2, i.numpy(), 1), d.numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def mdata():
    rng = np.random.default_rng(3)
    centers = rng.random((16, 16)).astype(np.float32) * 10
    return (centers[rng.integers(0, 16, 2000)]
            + 0.3 * rng.standard_normal((2000, 16))).astype(np.float32)


MERGED = dict(intermediate_graph_degree=16, graph_degree=8, build_chunk=1024, seed=0)


def test_build_merged_structure_and_recall(pool, mdata):
    n = len(mdata)
    merged = on(pool, 4, tasks.call, "parallel.cagra.build_merged",
                tc.IndexParams(**MERGED), mdata, res=CPU)
    assert tuple(merged.dataset.shape) == (n, 16)
    assert tuple(merged.graph.shape) == (n, 8)
    g = merged.graph.numpy()
    assert g.min() >= 0 and g.max() < n
    for lo, hi in tpcagra._shard_bounds(n, 4):
        assert g[lo:hi].min() >= lo and g[lo:hi].max() < hi, (lo, hi)   # no cross-shard edge
    np.testing.assert_array_equal(merged.dataset.numpy(), mdata)
    single = tc.build(tc.IndexParams(**MERGED), mdata, res=CPU)
    q = mdata[:64]
    d2 = ((q.astype(np.float64)[:, None] - mdata.astype(np.float64)[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :5]
    sp = tc.SearchParams(itopk_size=16, hop_impl="xla")
    r_merged = _recall(tc.search(sp, merged, q, 5)[1], gt)
    r_single = _recall(tc.search(sp, single, q, 5)[1], gt)
    assert r_merged > 0.8, r_merged
    assert r_merged >= r_single - 0.03, (r_merged, r_single)


def test_build_merged_uneven_rows_and_degree_bound(pool, mdata):
    bounds = tpcagra._shard_bounds(2001, 8)
    assert bounds == jpcagra._shard_bounds(2001, 8)
    assert bounds[0] == (0, 251) and bounds[-1] == (1751, 2001)
    with pytest.raises(RaftError, match="graph_degree"):
        pool.run(tasks.call, 4, "parallel.cagra.build_merged",
                 tc.IndexParams(intermediate_graph_degree=16, graph_degree=8, seed=0),
                 mdata[:20], res=CPU)                      # 5-row shards


def test_merged_builder_folds_a_mutable_index(pool, mdata):
    """A rebuild compaction through merged_builder, every rank folding at
    once: the rows written before the fold are found after it."""
    n0 = 1600
    q = mdata[n0:n0 + 16]
    outs = pool.run(tasks.merged_fold, 2, mdata, n0, tc.IndexParams(**MERGED), q, 5)
    assert outs[2:] == [None, None]
    for o in outs[:2]:
        assert o["mode"] == "rebuild" and o["sealed_rows"] == len(mdata)
        for d, i in (o["before"], o["after"]):
            # each query is a row written before the fold: found at rank 0
            np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(n0, n0 + 16))
            np.testing.assert_allclose(d.numpy()[:, 0], 0.0, atol=1e-3)
    torch.testing.assert_close(outs[0]["after"][1], outs[1]["after"][1], rtol=0, atol=0)


def test_no_rank_left_running(pool):
    """Keep last in the file: the pool closes and leaves no rank behind."""
    pool.close()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and [p for p in multiprocessing.active_children()
                                           if p.name.startswith("raft-rank-")]:
        time.sleep(0.05)
    assert not [p.name for p in multiprocessing.active_children()
                if p.name.startswith("raft-rank-")]
