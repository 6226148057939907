"""raft_tpu_torch.comms, core.platform, parallel.knn, parallel.kmeans,
``Resources(mesh=)`` and the mesh's ``comms=`` against raft_tpu.

The port's world is one :class:`~raft_tpu_torch.core.platform.RankPool` of
four spawned gloo ranks on the CPU a module (~4 s to spawn); a case over S
ranks uses the first S of them (``bootstrap.local_mesh("data", S)``). The
JAX side runs on the virtual devices tests/conftest.py forces, with
``Comms(Mesh(devices[:S]), "data")``. Inputs come from a numpy seed; the
tolerances are the slice's: collectives exact for gathers, permutations,
min / max, broadcasts and integer sums, rtol 1e-6 for float sums and 1e-5
for products; ``parallel.knn`` ids equal and distances within rtol 1e-5;
k-means at the JAX tests' quality level (its random streams differ) and
``predict`` from carried-over centers exact in labels.
"""

import dataclasses
import multiprocessing
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from raft_tpu import parallel as jparallel
from raft_tpu.cluster import KMeansParams as JKMeansParams
from raft_tpu.comms import Comms as JComms
from raft_tpu_torch.cluster import kmeans as tkmeans
from raft_tpu_torch.comms import bootstrap
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.core.platform import RankPool
from raft_tpu_torch.parallel._progcache import ProgramCache, memo

import torch_rank_tasks as tasks

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu", timeout_s=120) as p:
        yield p


def jcomms(S):
    return JComms(Mesh(np.array(jax.devices()[:S]), ("data",)), "data")


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """The JAX drivers memoize their programs by communicator value: drop
    this file's at its end, so a JAX test later in the same process that
    counts one communicator's programs (tests/test_comms.py's release
    check) starts from none."""
    yield
    for S in (1, 2, 4):
        jparallel.release_programs(jcomms(S))


def on(pool, S, fn, *args, **kwargs):
    """``fn`` over the first S ranks: their results (the rest return None)."""
    out = pool.run(fn, S, *args, **kwargs)
    assert all(o is None for o in out[S:]), out[S:]
    return out[:S]


def same(outs):
    """Every rank's answer, required equal; rank 0's."""
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    return outs[0]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 4])
def test_run_all_on_every_rank(pool, S):
    outs = on(pool, S, tasks.run_all)
    for r, o in enumerate(outs):
        assert all(o["results"].values()), o
        assert o["rank"] == r and isinstance(o["rank"], int)
        assert o["size"] == S
        assert o["devices"] == ["cpu"] * S
        assert o["backend"] == "gloo"
        assert o["stats"]["host_hops"] == 0   # host tensors take no hop


def test_commsplit_2d(pool):
    outs = pool.run(tasks.commsplit_2d)
    for r, o in enumerate(outs):
        assert o["split"], o
        assert all(o["row"].values()) and all(o["col"].values()), o
        assert o["sizes"] == (2, 2)
        assert o["ranks"] == (r // 2, r % 2)


OPS = ["sum", "isum", "min", "max", "prod", "bcast", "reduce", "allgather",
       "allgather_tiled", "gather", "reducescatter", "ppermute", "ppermute_partial",
       "shift", "alltoall"]


def _jax_collective(c, op, b):
    S = c.size()
    return {
        "sum": lambda: c.allreduce(b, "sum"),
        "isum": lambda: c.allreduce(b, "sum"),
        "min": lambda: c.allreduce(b, "min"),
        "max": lambda: c.allreduce(b, "max"),
        "prod": lambda: c.allreduce(b, "prod"),
        "bcast": lambda: c.bcast(b, root=S - 1),
        "reduce": lambda: c.reduce(b, root=S - 1),
        "allgather": lambda: c.allgather(b),
        "allgather_tiled": lambda: c.allgather(b, tiled=True),
        "gather": lambda: c.gather(b, root=0, tiled=True),
        "reducescatter": lambda: c.reducescatter(b),
        "ppermute": lambda: c.ppermute(b, [(i, S - 1 - i) for i in range(S)]),
        "ppermute_partial": lambda: c.ppermute(b, [(0, S - 1)]),
        "shift": lambda: c.shift(b, 1),
        "alltoall": lambda: c.alltoall(b),
    }[op]()


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax_shard_map(pool, S, op):
    rng = np.random.default_rng(S * 100 + OPS.index(op))
    shape = (S * S * 2, 3)
    if op == "isum":
        x = rng.integers(-1000, 1000, shape).astype(np.int32)
    elif op == "prod":
        x = (rng.uniform(0.5, 1.5, shape) * rng.choice([-1, 1], shape)).astype(np.float32)
        x[0, 0] = 0.0                      # a zero anywhere zeroes its column
    elif op in ("sum", "reduce", "reducescatter"):
        # positive terms: no cancellation, so rtol bounds the summation order
        x = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    jc = jcomms(S)
    want = np.asarray(jc.shard_map(lambda b: _jax_collective(jc, op, b),
                                   in_specs=JP("data"), out_specs=JP("data"))(x))
    got = same([(o,) for o in on(pool, S, tasks.collective, "sum" if op == "isum" else op,
                                 x)])[0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if op in ("sum", "reduce", "reducescatter"):      # float sums
        np.testing.assert_allclose(got, want, rtol=1e-6)
    elif op == "prod":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_documented_edge_semantics(pool):
    """reduce lands on every rank, gather returns full copies everywhere,
    PROD handles zeros and signs, alltoall requires divisibility (the JAX
    package's TestDocumentedEdgeSemantics)."""
    x = np.arange(4, dtype=np.float32).reshape(4, 1)
    got = on(pool, 4, tasks.collective, "reduce", x)[0].numpy()
    np.testing.assert_array_equal(got, np.full((4, 1), 6.0, np.float32))
    g = on(pool, 4, tasks.collective, "gather", x)[0].numpy()
    np.testing.assert_array_equal(g, np.tile(x, (4, 1)))
    vals = np.array([2.0, -1.0, 3.0, -2.0], np.float32).reshape(4, 1)
    p = on(pool, 4, tasks.collective, "prod", vals)[0].numpy()
    np.testing.assert_allclose(p, np.full((4, 1), 12.0), rtol=1e-5)
    vals[3] = 0.0
    p = on(pool, 4, tasks.collective, "prod", vals)[0].numpy()
    np.testing.assert_array_equal(p, np.zeros((4, 1), np.float32))
    msgs = on(pool, 4, tasks.alltoall_indivisible)
    assert all("must divide" in m for m in msgs), msgs


def test_collective_counters_count_each_executed_call(pool):
    """The JAX package's counter names and labels; the port counts each
    executed collective (the JAX package each traced one), and nothing
    with metrics disabled."""
    from raft_tpu.obs import metrics as jmetrics

    jc = jcomms(2)
    jmetrics.enable()
    jcalls = jmetrics.counter("raft_tpu_collective_calls_total")
    jc.shard_map(lambda b: jc.allreduce(b), in_specs=JP("data"),
                 out_specs=JP("data"))(np.ones((2, 4), np.float32))
    jkeys = [k for k in jcalls.series() if ("op", "allreduce") in k]
    assert jkeys
    jlabels = {name for name, _ in jkeys[0]}
    for o in on(pool, 2, tasks.counters):
        calls_b, bytes_b = o["before"]
        calls_m, bytes_m = o["mid"]
        key = next(k for k in calls_m if ("op", "allreduce") in k and ("size", "2") in k)
        assert {name for name, _ in key} == jlabels == {"op", "axis", "size"}
        assert dict(key) == {"op": "allreduce", "axis": "data", "size": "2"}
        assert calls_m[key] - calls_b.get(key, 0.0) == 2.0
        assert bytes_m[key] - bytes_b.get(key, 0.0) == 2 * 16
        assert o["after"] == o["mid"]                 # disabled: nothing counted
        assert o["stats"]["calls"] == 2 and o["stats"]["bytes"] == 32


def test_release_programs_drops_exactly_one_communicators_entries(pool):
    rng = np.random.default_rng(5)
    x = rng.random((160, 8)).astype(np.float32)
    q = rng.random((4, 8)).astype(np.float32)
    for o in on(pool, 2, tasks.release, x, q):
        assert o["hit"] == 1            # a second call finds the first's slice
        assert o["two"] == 2            # another index, another entry
        assert o["after_del"] == 1      # which goes with its index
        assert o["after_write"] == 1    # a write in place rebuilds the entry
        np.testing.assert_array_equal(o["got"][1].numpy(), o["want"][1].numpy())
        np.testing.assert_array_equal(o["got"][0].numpy(), o["want"][0].numpy())
        assert o["dropped"] == 1 and o["left"] == 0
        assert o["equal_other"]         # Comms compare by (mesh, axis), as JAX's
        assert o["maxsize"] == 256


@dataclasses.dataclass
class _Held:
    a: object
    tag: str = "x"


def test_program_cache_memo_is_weak_and_bounded():
    cache = ProgramCache(maxsize=2)
    a, b = _Held(torch.zeros(3)), _Held(torch.zeros(3))
    built = []
    assert memo(cache, "c", "t", a, lambda: built.append(1) or "A") == "A"
    assert memo(cache, "c", "t", a, lambda: built.append(1) or "B") == "A"
    assert built == [1]
    a.a.add_(1.0)                                   # written in place: built again
    assert memo(cache, "c", "t", a, lambda: "A2") == "A2"
    a.a = torch.zeros(3)                            # a field replaced: built again
    assert memo(cache, "c", "t", a, lambda: "A3") == "A3"
    a.tag = "y"
    assert memo(cache, "c", "t", a, lambda: "A4") == "A4"
    assert memo(cache, "c", "t", a, lambda: "A5") == "A4" and len(cache) == 1
    memo(cache, "c", "t", b, lambda: "B")
    memo(cache, "d", "t", b, lambda: "B")
    assert len(cache) == 2 and cache.keys_for("c") == [("c", "t", id(b))]  # LRU bound
    del b
    assert len(cache) == 0                          # the entries went with b
    assert cache.release("d") == 0 and cache.keys_for("c") == []
    assert memo(cache, "c", "t", [1, 2], lambda: "list") == "list"   # no dataclass: not kept
    arr = _Held(np.zeros(3))                        # an array changes unseen: not kept
    assert memo(cache, "c", "t", arr, lambda: "np") == "np"
    assert cache.keys_for("c") == []


def test_knn_searches_a_dataset_written_in_place(pool):
    """parallel.knn slices the dataset on every call: a dataset written in
    place between two calls is searched as it is now, as brute_force.knn
    searches it."""
    rng = np.random.default_rng(23)
    x = rng.random((96, 8)).astype(np.float32)
    q = rng.random((6, 8)).astype(np.float32)
    for S in (2, 4):
        for per_rank in on(pool, S, tasks.knn_in_place, x, q, 4):
            for (gd, gi), (wd, wi) in per_rank:      # a tensor, then an array
                np.testing.assert_array_equal(gi.numpy(), wi.numpy())
                np.testing.assert_allclose(gd.numpy(), wd.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the handle, the bootstrap, the platform
# ---------------------------------------------------------------------------


def test_resources_mesh_and_comms(pool):
    r = Resources(device="cpu")
    assert not r.comms_initialized and r.device_count == 1 and r.mesh is None
    with pytest.raises(RaftError, match="communicator was not initialized"):
        r.get_comms()
    r.set_comms("c")
    assert r.comms_initialized and r.get_comms() == "c"
    for o in on(pool, 4, tasks.resources_mesh):
        assert o == dict(count=4, same=True, initialized=True)


def test_cuda_world_without_a_card_raises():
    """A world asked for on CUDA where there is none raises before joining
    anything: it does not run on the CPU."""
    import torch.distributed as dist

    assert not torch.cuda.is_available()
    with pytest.raises(RaftError, match="no CUDA device"):
        bootstrap.initialize("127.0.0.1:1", 1, 0, device="cuda")
    with pytest.raises(RaftError, match="no CUDA device"):
        bootstrap.local_mesh()
    assert not dist.is_initialized() and bootstrap.rank_device() is None


def test_a_failing_task_raises_with_its_rank_and_the_pool_survives(pool):
    with pytest.raises(RaftError, match="rank 1"):
        pool.run(tasks.fail_on, 1)
    assert all(o["results"]["allreduce"] for o in on(pool, 4, tasks.run_all))


def test_run_ranks_joins_every_rank():
    threads = {t.ident for t in threading.enumerate()}
    children = {p.pid for p in multiprocessing.active_children()}
    with RankPool(2, device="cpu", timeout_s=60) as two:
        out = two.run(tasks.rank_and_world)
    assert out == [(0, 2), (1, 2)]
    assert {p.pid for p in multiprocessing.active_children()} <= children
    assert {t.ident for t in threading.enumerate()} <= threads


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    from raft_tpu_torch.comms import Comms, bootstrap

    pid = int(sys.argv[1])
    bootstrap.initialize({coord!r}, num_processes=2, process_id=pid, device="cpu")
    comms = Comms(bootstrap.global_mesh(("data",)), "data")
    assert comms.size() == 2 and comms.rank() == pid
    total = comms.allreduce(torch.full((4,), float(pid + 1)))
    assert total.tolist() == [3.0] * 4, total
    bootstrap.shutdown()
    print("BOOTSTRAP_OK", pid, flush=True)
""")


def test_two_process_bootstrap_over_loopback(tmp_path):
    """Two processes join one world through ``initialize`` over loopback
    ``tcp://`` and all-reduce across it (tests/test_bootstrap.py's
    counterpart)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(REPO), coord=coord))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "RANK",
                                                                     "WORLD_SIZE"))}
    procs = [subprocess.Popen([sys.executable, str(script), str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert f"BOOTSTRAP_OK {pid}" in out


# ---------------------------------------------------------------------------
# parallel.knn
# ---------------------------------------------------------------------------


def _knn_case(pool, S, n, d, m, k, metric, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    q = rng.random((m, d)).astype(np.float32)
    jd, ji = jparallel.knn.knn(jcomms(S), x, q, k, metric=metric)
    td, ti = same(on(pool, S, tasks.call, "parallel.knn.knn", x, q, k, metric=metric))
    return x, q, (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("n", [800, 805])
def test_knn_matches_jax(pool, S, metric, n):
    _, _, (jd, ji), (td, ti) = _knn_case(pool, S, n, 16, 25, 10, metric, seed=n + S)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert ti.min() >= 0 and ti.max() < n             # no padded row leaks


def test_knn_fused_route_matches_jax(pool):
    """Shards of 4,096 x 64 take the fused route (the ``fused_knn`` kernel's
    plain version on the CPU); the JAX driver runs its XLA route here."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors.brute_force import _fused_eligible

    assert _fused_eligible(DistanceType.L2Expanded, 10, 4096, 64, "exact", "float32")
    _, _, (jd, ji), (td, ti) = _knn_case(pool, 2, 2 * 4096, 64, 16, 10, "sqeuclidean", 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_knn_k_must_fit_one_shard(pool):
    with pytest.raises(RaftError, match="per-shard"):
        pool.run(tasks.call, 4, "parallel.knn.knn", np.zeros((16, 4), np.float32),
                 np.zeros((2, 4), np.float32), 5)


def test_knn_padded_shards_underfill_nothing(pool, check_filter_underfill):
    """n = 9 over 4 ranks: the last shard is all padding (its local search
    underfills with -1 / +inf), and the merge still reports 9 real rows."""
    x, _, (jd, ji), (td, ti) = _knn_case(pool, 4, 9, 8, 6, 3, "sqeuclidean", 9)
    check_filter_underfill(td, ti, range(9), select_min=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# parallel.kmeans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blobs():
    from raft_tpu.random import make_blobs

    x, labels = make_blobs(1600, 8, n_clusters=4, cluster_std=0.3, seed=3)
    return np.asarray(x), np.asarray(labels)


def test_kmeans_recovers_blobs_and_matches_single_device_inertia(pool, blobs):
    from sklearn.metrics import adjusted_rand_score

    x, truth = blobs
    outs = on(pool, 4, tasks.call, "parallel.kmeans.fit",
              tkmeans.KMeansParams(n_clusters=4, seed=0), x)
    o = outs[0]
    for other in outs[1:]:
        torch.testing.assert_close(other.centroids, o.centroids, rtol=0, atol=0)
    assert tuple(o.centroids.shape) == (4, 8) and tuple(o.labels.shape) == (1600,)
    assert adjusted_rand_score(truth, o.labels.numpy()) > 0.95
    single = tkmeans.fit(tkmeans.KMeansParams(n_clusters=4, seed=0), x,
                         res=Resources(device="cpu"))
    jdist = jparallel.kmeans.fit(jcomms(4), JKMeansParams(n_clusters=4, seed=0), x)
    np.testing.assert_allclose(float(o.inertia), float(single.inertia), rtol=0.05)
    np.testing.assert_allclose(float(o.inertia), float(jdist.inertia), rtol=0.05)


def test_kmeans_minibatch_close_to_full(pool):
    rng = np.random.default_rng(11)
    centers = rng.random((4, 8)).astype(np.float32) * 8
    x = (centers[rng.integers(0, 4, 1024)]
         + 0.2 * rng.standard_normal((1024, 8))).astype(np.float32)
    full = on(pool, 2, tasks.call, "parallel.kmeans.fit",
              tkmeans.KMeansParams(n_clusters=4, seed=0, max_iter=30), x)[0]
    mb = on(pool, 2, tasks.call, "parallel.kmeans.fit",
            tkmeans.KMeansParams(n_clusters=4, seed=0, max_iter=30, train_mode="minibatch",
                                 batch_rows=256), x)[0]
    assert float(mb.inertia) < 1.10 * float(full.inertia)


@pytest.mark.parametrize("S", [2, 4])
def test_kmeans_predict_from_carried_centers_matches_jax(pool, blobs, S):
    x, _ = blobs
    jout = jparallel.kmeans.fit(jcomms(S), JKMeansParams(n_clusters=4, seed=0), x)
    centers = np.asarray(jout.centroids)
    jl, ji = jparallel.kmeans.predict(jcomms(S), x, centers)
    tl, ti = same(on(pool, S, tasks.call, "parallel.kmeans.predict", x, centers))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_kmeans_rows_must_divide(pool):
    with pytest.raises(RaftError, match="divide the mesh axis"):
        pool.run(tasks.call, 4, "parallel.kmeans.fit", tkmeans.KMeansParams(n_clusters=2),
                 np.zeros((10, 2), np.float32))


# ---------------------------------------------------------------------------
# the mesh's comms=
# ---------------------------------------------------------------------------


def test_sharded_mesh_comms_equals_devices(pool, tmp_path):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    for o in on(pool, 1, tasks.sharded_comms, x, q, 5, str(tmp_path)):
        for got in (o["got"], o["loaded"]):
            np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(o["want"][1]))
            np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(o["want"][0]))
        assert o["both"] is not None and "not both" in o["both"], o["both"]


def test_sharded_mesh_refuses_a_communicator_of_several_ranks(pool, tmp_path):
    """Each rank is a process of its own: a mesh built on every rank of a
    world of two would build every shard twice, on the other rank's device
    too, so comms= of several ranks is refused (the constructor and load)."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    for o in on(pool, 2, tasks.sharded_comms, x, x[:2], 3, str(tmp_path)):
        for what in ("init", "load"):
            assert o[what] is not None and "one rank, got 2" in o[what], o


# ---------------------------------------------------------------------------
# nothing left running (keep last in the file)
# ---------------------------------------------------------------------------


def test_no_rank_left_running(pool):
    pool.close()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and [p for p in multiprocessing.active_children()
                                           if p.name.startswith("raft-rank-")]:
        time.sleep(0.05)
    assert not [p.name for p in multiprocessing.active_children()
                if p.name.startswith("raft-rank-")]
