"""Tasks the spawned ranks of the parallel test files run.

``raft_tpu_torch.core.platform.RankPool`` pickles a task by its module and
name, so the tasks live in this module, which imports no JAX (each rank
imports it fresh). Every rank of the pool's world runs each task; a task
over the first ``S`` ranks returns ``None`` on the others.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from raft_tpu_torch.comms import bootstrap
from raft_tpu_torch.comms.comms import Comms, P
from raft_tpu_torch.core import Resources

CPU = Resources(device="cpu")


def comms_of(S: int, axis: str = "data"):
    """The communicator over the world's first ``S`` ranks (None on the rest)."""
    return bootstrap.local_mesh(axis, S, device="cpu")


def _resolve(dotted: str):
    mod, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(f"raft_tpu_torch.{mod}"), name)


def call(S: int, dotted: str, *args, **kwargs):
    """``raft_tpu_torch.<dotted>(comms, *args, **kwargs)`` over the first S ranks."""
    c = comms_of(S)
    return None if c is None else _resolve(dotted)(c, *args, **kwargs)


# -- collectives -----------------------------------------------------------------


def _collective(c: Comms, op: str, b):
    S = c.size()
    return {
        "sum": lambda: c.allreduce(b, "sum"),
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


def collective(S: int, op: str, x):
    """``op`` over each rank's block of ``x`` (P(axis) in, P(axis) out)."""
    c = comms_of(S)
    if c is None:
        return None
    return c.shard_map(lambda b: _collective(c, op, b), P("data"), P("data"))(x)


def run_all(S: int):
    from raft_tpu_torch.comms import test_utils

    c = comms_of(S)
    if c is None:
        return None
    return dict(results=test_utils.run_all(c), rank=c.rank(), size=c.size(),
                devices=[str(d) for d in c.devices], backend=c.backend, stats=c.stats())


def commsplit_2d():
    from raft_tpu_torch.comms import test_utils

    c = Comms(bootstrap.global_mesh(("row", "col"), (2, 2)), "row")
    sub = c.comm_split("col")
    return dict(split=test_utils.test_commsplit(c, "col"), row=test_utils.run_all(c),
                col=test_utils.run_all(sub), sizes=(c.size(), sub.size()),
                ranks=(c.rank(), sub.rank()))


def alltoall_indivisible(S: int):
    from raft_tpu_torch.core import RaftError

    c = comms_of(S)
    if c is None:
        return None
    try:
        c.shard_map(c.alltoall, P("data"), P("data"))(np.zeros((S * (S + 1), 1), np.float32))
    except RaftError as e:
        return str(e)
    return "no error"


def counters(S: int):
    """The collective counters around two executed all-reduces, then one with
    metrics disabled."""
    from raft_tpu_torch.obs import metrics

    c = comms_of(S)
    if c is None:
        return None
    calls = metrics.counter("raft_tpu_collective_calls_total")
    nbytes = metrics.counter("raft_tpu_collective_bytes_total")
    metrics.enable()
    before = (dict(calls.series()), dict(nbytes.series()))
    for _ in range(2):
        c.allreduce(torch.ones(4), "sum")
    mid = (dict(calls.series()), dict(nbytes.series()))
    metrics.disable()
    try:
        c.allreduce(torch.ones(4), "sum")
        after = (dict(calls.series()), dict(nbytes.series()))
    finally:
        metrics.enable()
    return dict(before=before, mid=mid, after=after, stats=c.stats())


def release(S: int, x, q):
    """release_programs drops exactly one communicator's memoized slices, an
    entry goes with its index, and an index written in place is sliced again."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel import ivf as pivf

    c = comms_of(S)
    if c is None:
        return None
    other = Comms(c.mesh, "data")
    sp = ivf_flat.SearchParams(n_probes=64)  # every list: exhaustive
    # an odd list count pads: a rank's slice is a copy, which must not go stale
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=7, seed=0), x, res=CPU)
    parallel.ivf.search(c, sp, index, q, 3)
    parallel.ivf.search(c, sp, index, q, 3)
    hit = len(pivf._PROGRAMS.keys_for(c))
    y = ivf_flat.build(ivf_flat.IndexParams(n_lists=7, seed=0), x[::-1].copy(), res=CPU)
    parallel.ivf.search(c, sp, y, q, 3)
    two = len(pivf._PROGRAMS.keys_for(c))
    del y
    after_del = len(pivf._PROGRAMS.keys_for(c))
    index.list_data.mul_(2.0)                 # in place: the memo must see it
    index.list_norms.mul_(4.0)
    got = parallel.ivf.search(c, sp, index, q, 3)
    want = ivf_flat.search(sp, index, q, 3, res=CPU)
    after_write = len(pivf._PROGRAMS.keys_for(c))
    dropped = parallel.release_programs(c)
    left = len(pivf._PROGRAMS.keys_for(c))
    return dict(hit=hit, two=two, after_del=after_del, after_write=after_write,
                dropped=dropped, left=left, got=got, want=want,
                equal_other=other == c, maxsize=pivf._PROGRAMS.maxsize)


def knn_in_place(S: int, x, q, k: int):
    """parallel.knn on a dataset written in place between two calls (a
    tensor and a numpy array), against brute_force.knn on what it holds now."""
    from raft_tpu_torch import parallel
    from raft_tpu_torch.neighbors import brute_force

    c = comms_of(S)
    if c is None:
        return None
    out = []
    for data in (torch.from_numpy(x.copy()), x.copy()):
        parallel.knn.knn(c, data, q, k)
        data[::3] += 0.5                      # in place, same object
        got = parallel.knn.knn(c, data, q, k)
        out.append((got, brute_force.knn(torch.as_tensor(data), q, k, res=CPU)))
    return out


# -- the mesh's comms= -------------------------------------------------------------


def sharded_comms(S: int, x, q, k: int, tmp: str):
    """ShardedMutableIndex(comms=) and load(comms=) against devices= over a
    communicator of one rank; over more ranks, the refusal's text."""
    from raft_tpu_torch.core import RaftError
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.stream import ShardedMutableIndex

    c = comms_of(S)
    if c is None:
        return None

    def build(rows):
        return brute_force.BruteForce().build(rows, res=CPU)

    n_shards = 2
    if S > 1:
        out = {}
        for what, fn in (("init", lambda: ShardedMutableIndex(x, n_shards=n_shards, build=build,
                                                               comms=c)),
                         ("load", lambda: ShardedMutableIndex.load(tmp, comms=c))):
            try:
                fn()
                out[what] = None
            except RaftError as e:
                out[what] = str(e)
        return out
    by_comms = ShardedMutableIndex(x, n_shards=n_shards, build=build, comms=c)
    by_devices = ShardedMutableIndex(x, n_shards=n_shards, build=build,
                                     devices=["cpu"] * n_shards)
    got = by_comms.search(q, k)
    want = by_devices.search(q, k)
    path = os.path.join(tmp, f"rank{c.rank()}")
    by_comms.save(path)
    loaded = ShardedMutableIndex.load(path, comms=c)
    both = None
    try:
        ShardedMutableIndex(x, n_shards=n_shards, build=build, comms=c, devices=["cpu"])
    except Exception as e:  # the refusal's type and text go back to the test
        both = f"{type(e).__name__}: {e}"
    return dict(got=got, want=want, loaded=loaded.search(q, k), both=both)


# -- CAGRA -------------------------------------------------------------------------


def cagra_search_state(S: int, dataset, graph, meta: dict, params_kw: dict, q, k: int,
                       pool_ids=None):
    """parallel.cagra's search over a carried-over sharded index."""
    from raft_tpu_torch.neighbors.cagra import SearchParams
    from raft_tpu_torch.parallel import cagra as pcagra

    c = comms_of(S)
    if c is None:
        return None
    index = pcagra.from_state({"dataset": dataset, "graph": graph}, device="cpu", **meta)
    return pcagra._search(c, SearchParams(**params_kw), index, q, k, pool_ids=pool_ids)


def merged_fold(S: int, x, n0: int, params, q, k: int):
    """A MutableIndex whose rebuild folds through merged_builder: its
    answers before and after the fold, and the fold's report."""
    from raft_tpu_torch.parallel import cagra as pcagra
    from raft_tpu_torch.stream import MutableIndex

    c = comms_of(S)
    if c is None:
        return None
    base = pcagra.build_merged(c, params, x[:n0], res=CPU)
    m = MutableIndex(base, builder=pcagra.merged_builder(c, params), retain_vectors=True,
                     dataset=x[:n0], delta_capacity=max(1024, len(x) - n0))
    m.upsert(x[n0:], ids=np.arange(n0, len(x)))
    before = m.search(q, k)
    report = m.compact("rebuild", res=CPU)
    return dict(before=before, after=m.search(q, k), mode=report["mode"],
                sealed_rows=m.stats()["sealed_rows"] if "sealed_rows" in m.stats() else None)


# -- IVF ---------------------------------------------------------------------------


def ivf_search_loaded(S: int, kind: str, path: str, params_kw: dict, q, k: int):
    """parallel.ivf.search / search_pq over an index file the JAX package saved."""
    from raft_tpu_torch.parallel import ivf as pivf

    c = comms_of(S)
    if c is None:
        return None
    mod = importlib.import_module(f"raft_tpu_torch.neighbors.{kind}")
    index = mod.load(path, res=CPU)
    if kind == "ivf_flat":
        return pivf.search(c, mod.SearchParams(**params_kw), index, q, k)
    return pivf.search_pq(c, mod.SearchParams(**params_kw), index, q, k, res=CPU)


def ivf_fill(S: int, x, centers, L: int, cap: int):
    """The distributed fill (_global_positions + _fill_blocks) of ``x``'s
    rows into the lists of ``centers``: the whole (list ids, rows) arrays."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors._list_utils import assign_to_lists
    from raft_tpu_torch.parallel import ivf as pivf

    c = comms_of(S)
    if c is None:
        return None
    xs, lo = pivf._rank_rows(c, x)
    labels = assign_to_lists(xs, c.put(centers), DistanceType.L2Expanded, 256)
    ids = torch.arange(lo, lo + xs.shape[0], dtype=torch.int32)
    data, idb, _ = pivf._fill_flat(c, xs.to(torch.float32), labels, ids, L, cap)
    return tuple(pivf._gather_lists(c, idb, data))


# -- the handle and the pool -------------------------------------------------------


def resources_mesh(S: int):
    c = comms_of(S)
    if c is None:
        return None
    r = Resources(device="cpu", mesh=c.mesh)
    r.set_comms(c)
    return dict(count=r.device_count, same=r.get_comms() is c,
                initialized=r.comms_initialized)


def fail_on(rank: int):
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"a task failed on rank {rank}")
    return dist.get_rank()


def rank_and_world():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()
