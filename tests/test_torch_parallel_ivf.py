"""raft_tpu_torch.parallel.ivf against raft_tpu.parallel.ivf.

Searches run on indexes the JAX package built and saved (raft_tpu/13) and
the port's ranks loaded; the port's answers are held against the JAX
driver's over ``Comms(Mesh(devices[:S]), "data")`` at S = 2 and 4,
non-divisible list counts (padded with empty lists) and a pq8-split index
included: ids equal, distances within rtol 1e-5 (IVF-PQ's, which the port's
scan kernel route and the JAX one-hot contraction sum in other orders, at
atol 1e-4). The port's distributed builds (their random streams
differ from the JAX package's) are held at the JAX tests' recall floors
(tests/test_comms.py:263-520), and the distributed fill, given the same
centers, puts every row in the same list slot as the JAX fill.

The port's world is one RankPool of four spawned gloo ranks on the CPU.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from raft_tpu.comms import Comms as JComms
from raft_tpu.distance.types import DistanceType as JDistanceType
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors._list_utils import assign_to_lists as j_assign
from raft_tpu.parallel import ivf as jivf
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.core.platform import RankPool
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.refine import refine as trefine

import torch_rank_tasks as tasks

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu", timeout_s=120) as p:
        yield p


def jcomms(S):
    return JComms(Mesh(np.array(jax.devices()[:S]), ("data",)), "data")


def on(pool, S, fn, *args, **kwargs):
    out = pool.run(fn, S, *args, **kwargs)
    assert all(o is None for o in out[S:]), out[S:]
    for o in out[1:S]:                       # every rank answers alike
        if isinstance(o, tuple):
            for a, b in zip(out[0], o):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            for f in ("centers", "list_ids", "list_sizes"):
                torch.testing.assert_close(getattr(o, f), getattr(out[0], f), rtol=0, atol=0)
    return out[0]


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / gt.shape[1]
                    for r in range(gt.shape[0])])


def _truth(x, q, k):
    d2 = ((q.astype(np.float64)[:, None] - x.astype(np.float64)[None]) ** 2).sum(-1)
    return np.sort(d2, 1)[:, :k], np.argsort(d2, 1, kind="stable")[:, :k]


# ---------------------------------------------------------------------------
# searches on JAX-built indexes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    x = rng.random((2048, 16)).astype(np.float32)
    q = rng.random((40, 16)).astype(np.float32)
    return x, q


FLAT = {"l2_32": dict(n_lists=32, seed=0), "l2_19": dict(n_lists=19, seed=0),
        "ip_32": dict(n_lists=32, seed=0, metric="inner_product", split_factor=1000.0),
        "ip_split": dict(n_lists=32, seed=0, metric="inner_product")}
PQ = {"pq4_16": dict(n_lists=16, pq_dim=8, pq_bits=4, seed=0),
      "pq4_13": dict(n_lists=13, pq_dim=8, pq_bits=4, seed=0),
      "pq8split_16": dict(n_lists=16, pq_dim=8, pq_bits=8, seed=0)}


@pytest.fixture(scope="module")
def jax_files(data, tmp_path_factory):
    """name -> (JAX index, path of its raft_tpu/13 file)."""
    x, _ = data
    out = {}
    for name, cfg in FLAT.items():
        index = jflat.build(jflat.IndexParams(**cfg), jnp.asarray(x))
        out[name] = (index, str(tmp_path_factory.mktemp("jax") / f"{name}.bin"))
        jflat.save(index, out[name][1])
    for name, cfg in PQ.items():
        index = jpq.build(jpq.IndexParams(**cfg), jnp.asarray(x[:1024]))
        out[name] = (index, str(tmp_path_factory.mktemp("jax") / f"{name}.bin"))
        jpq.save(index, out[name][1])
    return out


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name,n_probes", [("l2_32", 4), ("l2_19", 3), ("ip_32", 4)])
def test_flat_search_on_jax_index_matches_jax(pool, data, jax_files, S, name, n_probes):
    _, q = data
    jindex, path = jax_files[name]
    jd, ji = jivf.search(jcomms(S), jflat.SearchParams(n_probes=n_probes), jindex, q, 8)
    td, ti = on(pool, S, tasks.ivf_search_loaded, "ivf_flat", path,
                dict(n_probes=n_probes), q, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    if name == "l2_19":
        assert (ti.numpy() >= 0).all()         # the padding lists never win


def test_inner_product_needs_divisible_lists(pool, data, jax_files):
    """Inner product has no worst-ranked padding center: both packages refuse
    a list count (here split by the build) the ranks do not divide."""
    from raft_tpu.core import RaftError as JRaftError

    _, q = data
    jindex, path = jax_files["ip_split"]
    assert jindex.n_lists % 4 != 0
    with pytest.raises(JRaftError, match="divisible by the mesh axis"):
        jivf.search(jcomms(4), jflat.SearchParams(n_probes=4), jindex, q, 8)
    with pytest.raises(RaftError, match="divisible by the mesh axis"):
        pool.run(tasks.ivf_search_loaded, 4, "ivf_flat", path, dict(n_probes=4), q, 8)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name,n_probes", [("pq4_16", 2), ("pq4_13", 1), ("pq8split_16", 16)])
def test_pq_search_on_jax_index_matches_jax(pool, data, jax_files, S, name, n_probes):
    _, q = data
    jindex, path = jax_files[name]
    jd, ji = jivf.search_pq(jcomms(S), jpq.SearchParams(n_probes=n_probes), jindex, q, 5)
    td, ti = on(pool, S, tasks.ivf_search_loaded, "ivf_pq", path,
                dict(n_probes=n_probes), q, 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert (ti.numpy() >= 0).all()


# ---------------------------------------------------------------------------
# the distributed fill, given the same centers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 4])
def test_fill_puts_every_row_in_the_jax_slot(pool, data, S):
    x, _ = data
    L = 16
    rng = np.random.default_rng(3)
    centers = x[rng.choice(len(x), L, replace=False)]
    counts = np.bincount(np.asarray(j_assign(x, centers, JDistanceType.L2Expanded, 256)),
                         minlength=L)
    cap = int(-(-max(counts.max(), 8) // 8) * 8)
    jc = jcomms(S)

    def step(xs, ids):
        lab = j_assign(xs, centers, JDistanceType.L2Expanded, 256)
        gpos = jivf._global_positions(jc, lab, L)
        data_b, idb = jivf._fill_blocks(jc, [(xs, jnp.float32), (ids + 1, jnp.int32)],
                                        lab, gpos, L, cap)
        return idb - 1, data_b

    ji, jdata = jax.jit(jc.shard_map(step, in_specs=(JP("data"), JP("data")),
                                     out_specs=(JP("data"), JP("data"))))(
        x, np.arange(len(x), dtype=np.int32))
    ti, tdata = on(pool, S, tasks.ivf_fill, x, centers, L, cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tdata.numpy(), np.asarray(jdata))
    stored = ti.numpy()
    assert sorted(stored[stored >= 0].tolist()) == list(range(len(x)))


# ---------------------------------------------------------------------------
# the distributed builds, at the JAX tests' recall floors
# ---------------------------------------------------------------------------


def _all_rows_once(index, n):
    ids = index.list_ids.numpy()
    assert int(index.list_sizes.sum()) == n
    assert sorted(ids[ids >= 0].tolist()) == list(range(n))


@pytest.mark.parametrize("S,mode", [(2, "full"), (4, "full"), (4, "minibatch")])
def test_flat_build_exhaustive_is_exact(pool, S, mode):
    rng = np.random.default_rng(S)
    x = rng.random((2048, 16)).astype(np.float32)
    q = rng.random((40, 16)).astype(np.float32)
    kw = dict(kmeans_train_mode="minibatch", kmeans_batch_rows=512) if mode == "minibatch" else {}
    idx = on(pool, S, tasks.call, "parallel.ivf.build", tflat.IndexParams(n_lists=32, seed=0,
                                                                           **kw), x)
    assert idx.n_lists == 32
    _all_rows_once(idx, len(x))
    want, _ = _truth(x, q, 8)
    d, _ = on(pool, S, tasks.call, "parallel.ivf.search", tflat.SearchParams(n_probes=32 // S),
              idx, q, 8)
    np.testing.assert_allclose(np.sort(d.numpy(), 1), want, atol=1e-3, rtol=1e-3)
    # the single-device search takes the distributed build's index as it is
    d1, _ = tflat.search(tflat.SearchParams(n_probes=32), idx, q, 8, res=CPU)
    np.testing.assert_allclose(np.sort(d1.numpy(), 1), want, atol=1e-3, rtol=1e-3)


def test_flat_extend(pool):
    rng = np.random.default_rng(4)
    n = 1024
    x = rng.random((2 * n, 8)).astype(np.float32)
    q = x[:16]
    idx = on(pool, 4, tasks.call, "parallel.ivf.build", tflat.IndexParams(n_lists=16, seed=0),
             x[:n])
    idx2 = on(pool, 4, tasks.call, "parallel.ivf.extend", idx, x[n:])
    _all_rows_once(idx2, 2 * n)
    d, _ = on(pool, 4, tasks.call, "parallel.ivf.search", tflat.SearchParams(n_probes=4),
              idx2, q, 4)                      # 4 of 4 lists a rank: exhaustive
    want, _ = _truth(x, q, 4)
    np.testing.assert_allclose(np.sort(d.numpy(), 1), want, atol=1e-3, rtol=1e-3)


def test_flat_build_uint8(pool):
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (1024, 16), dtype=np.uint8)
    q = x[:20]
    idx = on(pool, 4, tasks.call, "parallel.ivf.build", tflat.IndexParams(n_lists=16, seed=0), x)
    assert idx.data_kind == "uint8" and idx.list_data.dtype == torch.int8
    d, _ = on(pool, 4, tasks.call, "parallel.ivf.search", tflat.SearchParams(n_probes=4),
              idx, q, 4)                       # exhaustive
    want, _ = _truth(x, q, 4)
    np.testing.assert_allclose(np.sort(d.numpy(), 1), want, atol=1e-3, rtol=1e-3)


def _zipf_blobs(seed: int, n: int = 4096, d: int = 16, blobs: int = 24):
    """Blobs whose sizes fall as 1/rank: clusters of very unequal weight."""
    rng = np.random.default_rng(seed)
    centers = rng.random((blobs, d)).astype(np.float32) * 10
    w = 1.0 / np.arange(1, blobs + 1)
    labels = rng.choice(blobs, n, p=w / w.sum())
    return (centers[labels] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("S", [2, 4])
def test_build_list_skew_matches_jax(pool, S):
    """The distributed build splits no list, so its list skew is what the
    balanced psum-EM leaves. Over six Zipf-weighted blob sets the port's
    mean max/mean list size is within 25% of the JAX driver's (their random
    streams differ, so no one set agrees)."""
    def skew(sizes):
        s = np.asarray(sizes, np.float64)
        return s.max() / s.mean()

    jr, tr = [], []
    for seed in range(6):
        x = _zipf_blobs(seed)
        jr.append(skew(jivf.build(jcomms(S), jflat.IndexParams(n_lists=32, seed=seed),
                                  x).list_sizes))
        tr.append(skew(on(pool, S, tasks.call, "parallel.ivf.build",
                          tflat.IndexParams(n_lists=32, seed=seed), x).list_sizes))
    assert abs(np.mean(tr) / np.mean(jr) - 1.0) <= 0.25, (tr, jr)


@pytest.fixture(scope="module")
def blob_set():
    rng = np.random.default_rng(8)
    centers = rng.random((16, 16)).astype(np.float32) * 10
    x = (centers[rng.integers(0, 16, 2048)]
         + 0.3 * rng.standard_normal((2048, 16))).astype(np.float32)
    return x, x[:32], _truth(x, x[:32], 5)[1]


@pytest.mark.parametrize("mode", ["full", "minibatch"])
def test_pq_build_recall_parity(pool, blob_set, mode):
    """Raw PQ recall at parity with a single-device build of the same config
    (pq4 on this config is coarse: the bar is the build, not the quantizer),
    and the refined operating point too."""
    x, q, gt = blob_set
    kw = dict(kmeans_train_mode="minibatch", kmeans_batch_rows=512) if mode == "minibatch" else {}
    params = tpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=4, seed=0, **kw)
    idx = on(pool, 4, tasks.call, "parallel.ivf.build_pq", params, x)
    _all_rows_once(idx, len(x))
    _, i_dist = on(pool, 4, tasks.call, "parallel.ivf.search_pq",
                   tpq.SearchParams(n_probes=2), idx, q, 5)
    one = tpq.build(params, x, res=CPU)
    _, i_ref = tpq.search(tpq.SearchParams(n_probes=16), one, q, 5)
    assert _recall(i_dist, gt) > _recall(i_ref, gt) - 0.1
    if mode == "full":
        _, cand = on(pool, 4, tasks.call, "parallel.ivf.search_pq",
                     tpq.SearchParams(n_probes=2), idx, q, 20)
        _, i_rf = trefine(x, q, cand, 5, res=CPU)
        _, cand1 = tpq.search(tpq.SearchParams(n_probes=16), one, q, 20)
        _, i_rf1 = trefine(x, q, cand1, 5, res=CPU)
        assert _recall(i_rf, gt) > _recall(i_rf1, gt) - 0.1
        assert _recall(i_rf, gt) > 0.6
        # the single-device search takes the distributed build's index
        _, i_one = tpq.search(tpq.SearchParams(n_probes=16), idx, q, 5)
        assert _recall(i_one, gt) > _recall(i_ref, gt) - 0.1


def test_pq_build_uint8(pool):
    rng = np.random.default_rng(9)
    centers = rng.integers(60, 196, (16, 16))
    x = np.clip(centers[rng.integers(0, 16, 2048)] + rng.normal(0, 10, (2048, 16)),
                0, 255).astype(np.uint8)
    q = x[:32]
    _, gt = _truth(x, q, 10)
    params = tpq.IndexParams(n_lists=16, pq_dim=8, seed=0)
    idx = on(pool, 4, tasks.call, "parallel.ivf.build_pq", params, x)
    assert idx.data_kind == "uint8"
    _all_rows_once(idx, len(x))
    _, ids = on(pool, 4, tasks.call, "parallel.ivf.search_pq", tpq.SearchParams(n_probes=16),
                idx, q, 10)
    one = tpq.build(params, x, res=CPU)
    _, i_ref = tpq.search(tpq.SearchParams(n_probes=16), one, q, 10)
    assert _recall(ids, gt) > _recall(i_ref, gt) - 0.1
    assert _recall(ids, gt) > 0.5


def test_pq8_split_build(pool):
    rng = np.random.default_rng(10)
    x = rng.random((1024, 16)).astype(np.float32)
    idx = on(pool, 4, tasks.call, "parallel.ivf.build_pq",
             tpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=8, seed=0), x)
    assert idx.pq_split
    assert tuple(idx.list_consts.shape) == tuple(idx.list_ids.shape)
    _, i = on(pool, 4, tasks.call, "parallel.ivf.search_pq", tpq.SearchParams(n_probes=2),
              idx, x[:8], 3)
    assert (i.numpy()[:, 0] == np.arange(8)).mean() > 0.7


def test_build_guards(pool):
    rng = np.random.default_rng(12)
    with pytest.raises(RaftError, match="divide the mesh axis"):
        pool.run(tasks.call, 4, "parallel.ivf.build", tflat.IndexParams(n_lists=16, seed=0),
                 rng.random((1001, 8)).astype(np.float32))
    with pytest.raises(RaftError, match="n_lists"):
        pool.run(tasks.call, 4, "parallel.ivf.build", tflat.IndexParams(n_lists=18, seed=0),
                 rng.random((1024, 8)).astype(np.float32))


def test_no_rank_left_running(pool):
    """Keep last in the file: the pool closes and leaves no rank behind."""
    pool.close()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and [p for p in multiprocessing.active_children()
                                           if p.name.startswith("raft-rank-")]:
        time.sleep(0.05)
    assert not [p.name for p in multiprocessing.active_children()
                if p.name.startswith("raft-rank-")]
