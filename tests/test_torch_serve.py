"""raft_tpu_torch.serve against raft_tpu.serve (tier-1 ``serve`` marker).

The deterministic cases of tests/test_serve.py, ported: an injected clock,
``start_workers=False`` and ``pump()`` assert every queue policy without a
wall-clock sleep. The two cases with threads (hot swap under load, worker
liveness) wait only on futures and joins with timeouts. Then parity: one
scripted request sequence runs through the JAX ``SearchService`` over a
JAX-built index and through the port's over the same index loaded from its
raft_tpu/13 file; flushes and buckets, answers (ids equal, distances within
rtol = atol = 1e-5), refusals, metrics and journal events must agree.
Everything here runs on the CPU: the port's searchers take their kernels'
plain versions on CPU tensors.
"""

import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import obs
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors._hooks import make_hook
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.serve import (DeadlineExceededError, IndexRegistry,
                                  MemoryBudgetError, MicroBatcher,
                                  OverloadedError, SearchService,
                                  ServiceClosedError, StagingBuffers,
                                  bucket_for, bucket_sizes, submit_with_retry)

pytestmark = pytest.mark.serve

CPU = Resources(device="cpu")
RTOL = ATOL = 1e-5


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def dataset(rng):
    return rng.standard_normal((512, 16)).astype(np.float32)


@pytest.fixture
def bf(dataset):
    return brute_force.BruteForce().build(dataset, res=CPU)


def det_service(bf_index, clock, *, max_batch=8, max_wait_us=1000.0,
                max_queue_rows=32, warm=False, **kw):
    """A deterministic service: injected clock, no worker threads."""
    svc = SearchService(max_batch=max_batch, max_wait_us=max_wait_us,
                        max_queue_rows=max_queue_rows, clock=clock,
                        start_workers=False, **kw)
    svc.publish("main", bf_index, k=5, warm=warm)
    return svc


def spy_hook(searcher, calls):
    """A hook that records each flush's row count and delegates."""

    def fn(queries, k):
        calls.append(int(queries.shape[0]))
        return searcher(queries, k)

    fn.kind, fn.dim, fn.query_dtype = "spy", searcher.dim, searcher.query_dtype
    fn.device = getattr(searcher, "device", None)
    return fn


# -- bucket ladder ----------------------------------------------------------

def test_bucket_ladder():
    assert bucket_sizes(64) == (1, 2, 4, 8, 16, 32, 64)
    assert bucket_sizes(1) == (1,)
    with pytest.raises(RaftError):
        bucket_sizes(48)
    assert [bucket_for(n, 64) for n in (1, 2, 3, 5, 33, 64)] == [1, 2, 4, 8, 64, 64]
    assert bucket_sizes(64) == jserve.bucket_sizes(64)


@pytest.mark.parametrize("name", [
    "SearchService", "SearchService.publish", "SearchService.submit",
    "SearchService.search", "SearchService.shutdown", "SearchService.upsert",
    "IndexRegistry", "IndexRegistry.publish", "IndexRegistry.lease",
    "MicroBatcher", "MicroBatcher.submit", "MicroBatcher.close", "MicroBatcher.pump",
    "StagingBuffers", "StagingBuffers.stage", "warm_staging", "bucket_sizes",
    "bucket_for", "submit_with_retry", "make_searcher"])
def test_public_signatures_match_jax(name):
    """The port's serve surface takes the JAX package's arguments (those the
    slice refuses raise "not yet ported", tested above)."""
    import inspect

    def resolve(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return inspect.signature(obj)

    from raft_tpu_torch import serve

    assert resolve(serve) == resolve(jserve)


# -- batching semantics -----------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_single_row_flushes_after_max_wait(bf, dataset, depth):
    clock = FakeClock()
    svc = det_service(bf, clock, max_wait_us=1000.0, pipeline_depth=depth)
    fut = svc.submit("main", dataset[:1], 5)
    assert svc.pump() == 0 and not fut.done()
    clock.advance(0.0011)
    assert svc.pump() == 1
    d, i = fut.result(timeout=0)
    assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
    assert d.shape == (1, 5) and int(i[0, 0]) == 0


def test_exactly_max_batch_flushes_immediately(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=8)
    futs = [svc.submit("main", dataset[j:j + 1], 5) for j in range(8)]
    assert svc.pump() == 8
    assert all(f.done() for f in futs)
    assert obs.quantile("raft_tpu_serve_batch_occupancy", 0.5,
                        stream="main.k5") == pytest.approx(1.0, abs=0.26)


@pytest.mark.parametrize("depth", [0, 2])
def test_scatter_matches_unbatched_results(bf, dataset, depth):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=16, pipeline_depth=depth)
    blocks = [dataset[0:3], dataset[3:4], dataset[4:9], dataset[9:16]]
    futs = [svc.submit("main", b, 5) for b in blocks]
    assert svc.pump() == 16
    ref_d, ref_i = (t.numpy() for t in bf.search(dataset[:16], 5))
    off = 0
    for b, f in zip(blocks, futs):
        d, i = f.result(timeout=0)
        np.testing.assert_array_equal(i, ref_i[off:off + len(b)])
        np.testing.assert_allclose(d, ref_d[off:off + len(b)], rtol=RTOL, atol=ATOL)
        off += len(b)


def test_partial_batch_pads_to_bucket(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=8)
    fut = svc.submit("main", dataset[:3], 5)
    clock.advance(0.01)
    assert svc.pump() == 3
    assert fut.result(timeout=0)[0].shape == (3, 5)
    q = obs.quantile("raft_tpu_serve_batch_occupancy", 0.5, stream="main.k5")
    assert 0.5 < q <= 1.0


def test_oversized_request_refused(bf, dataset):
    svc = det_service(bf, FakeClock(), max_batch=4)
    with pytest.raises(RaftError):
        svc.submit("main", dataset[:5], 5)


# -- deadlines --------------------------------------------------------------

def test_deadline_expiry_mid_queue_drops_before_batching(bf, dataset):
    calls = []
    clock = FakeClock()
    svc = SearchService(max_batch=8, max_wait_us=100.0, clock=clock,
                        start_workers=False)
    svc.publish("main", spy_hook(brute_force.batched_searcher(bf), calls), k=5,
                warm=False)
    f_dead = svc.submit("main", dataset[:2], 5, timeout_s=0.005)
    f_live = svc.submit("main", dataset[2:3], 5)
    clock.advance(0.01)
    assert svc.pump() == 1
    with pytest.raises(DeadlineExceededError):
        f_dead.result(timeout=0)
    assert f_live.result(timeout=0)[0].shape == (1, 5)
    assert calls == [1]


def test_submit_with_expired_timeout_fast_fails(bf, dataset):
    svc = det_service(bf, FakeClock())
    with pytest.raises(DeadlineExceededError):
        svc.submit("main", dataset[:1], 5, timeout_s=0.0)
    assert svc.queue_depth() == 0


def test_deadline_shorter_than_batching_budget_fails_promptly(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_wait_us=100_000.0)
    fut = svc.submit("main", dataset[:1], 5, timeout_s=0.005)
    clock.advance(0.006)
    assert svc.pump() == 0
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=0)


def test_expired_deadline_does_not_early_flush_queue_mates(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=8, max_wait_us=100_000.0)
    f_live = svc.submit("main", dataset[:1], 5)
    f_dead = svc.submit("main", dataset[1:2], 5, timeout_s=0.005)
    clock.advance(0.006)
    assert svc.pump() == 0
    with pytest.raises(DeadlineExceededError):
        f_dead.result(timeout=0)
    assert not f_live.done() and svc.queue_depth() == 1
    clock.advance(0.1)
    assert svc.pump() == 1
    assert f_live.result(timeout=0)[0].shape == (1, 5)


# -- admission control ------------------------------------------------------

def test_overload_fast_fail(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=4, max_queue_rows=6)
    for j in range(6):
        svc.submit("main", dataset[j:j + 1], 5)
    with pytest.raises(OverloadedError):
        svc.submit("main", dataset[:1], 5)
    svc2 = det_service(bf, clock, max_batch=4, max_queue_rows=6)
    svc2.submit("main", dataset[:4], 5)
    with pytest.raises(OverloadedError):
        svc2.submit("main", dataset[:3], 5)
    assert svc.pump(force=True) > 0
    while svc.pump(force=True):
        pass
    svc.submit("main", dataset[:1], 5)


def test_submit_with_retry_backs_off_then_admits(bf, dataset):
    """OverloadedError retries with backoff until a drain frees the queue;
    a spent deadline never retries."""
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=4, max_queue_rows=4)
    svc.submit("main", dataset[:4], 5)
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        svc.pump(force=True)   # the queue drains while the client waits

    fut = submit_with_retry(svc, "main", dataset[:1], 5, sleep=sleep, clock=clock)
    assert len(sleeps) == 1 and svc.queue_depth() == 1
    clock.advance(1.0)
    svc.pump()
    assert fut.result(timeout=0)[1].shape == (1, 5)
    svc.submit("main", dataset[:3], 5)
    with pytest.raises(DeadlineExceededError):
        submit_with_retry(svc, "main", dataset[:4], 5, timeout_s=1e-4,
                          base_s=1.0, sleep=sleep, clock=clock)


def test_unknown_name_rejected(bf, dataset):
    svc = det_service(bf, FakeClock())
    with pytest.raises(RaftError):
        svc.submit("nope", dataset[:1], 5)


def test_cancelled_future_dropped_not_crashing(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=8)
    f_cancel = svc.submit("main", dataset[:2], 5)
    f_live = svc.submit("main", dataset[2:3], 5)
    assert f_cancel.cancel()
    clock.advance(0.01)
    assert svc.pump() == 1
    assert f_live.result(timeout=0)[0].shape == (1, 5)
    assert svc.queue_depth() == 0


def test_unpublished_k_refused(bf, dataset):
    clock = FakeClock()
    svc = SearchService(max_batch=2, clock=clock, start_workers=False)
    svc.publish("main", bf, k=(5, 3), warm=False)
    svc.submit("main", dataset[:1], 3)
    with pytest.raises(RaftError):
        svc.submit("main", dataset[:1], 7)
    assert svc.queue_depth() == 1


# -- shutdown ---------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_shutdown_with_nonempty_queue_drains(bf, dataset, depth):
    svc = det_service(bf, FakeClock(), max_batch=8, pipeline_depth=depth)
    futs = [svc.submit("main", dataset[j:j + 1], 5) for j in range(3)]
    svc.shutdown(drain=True)
    for f in futs:
        assert f.result(timeout=0)[0].shape == (1, 5)
    with pytest.raises(ServiceClosedError):
        svc.submit("main", dataset[:1], 5)


def test_shutdown_without_drain_fails_pending(bf, dataset):
    svc = det_service(bf, FakeClock())
    futs = [svc.submit("main", dataset[j:j + 1], 5) for j in range(3)]
    svc.shutdown(drain=False)
    for f in futs:
        with pytest.raises(ServiceClosedError):
            f.result(timeout=0)
    assert svc.queue_depth() == 0


# -- registry / hot-swap ----------------------------------------------------

def test_publish_warms_every_bucket(bf):
    reg = IndexRegistry(buckets=(1, 2, 4))
    rep = reg.publish("main", bf, k=(5, 3))
    assert rep["version"] == 1
    for kk in (5, 3):
        assert sorted(rep["warm"][kk]) == [1, 2, 4]
        for phase in rep["warm"][kk].values():
            assert phase["wall_s"] >= 0.0 and set(phase) == {
                "wall_s", "compile_s", "trace_s", "programs", "cache_hits",
                "cache_misses"}
    bf2 = brute_force.BruteForce().build(bf.dataset.flip(0).contiguous(), res=CPU)
    rep2 = reg.publish("main", bf2, k=(5, 3))
    assert rep2["version"] == 2
    for kk in (5, 3):
        for phase in rep2["warm"][kk].values():
            assert phase["programs"] == 0 and phase["cache_misses"] == 0


def test_publish_warm_data_sample(bf, dataset):
    reg = IndexRegistry(buckets=(1, 2))
    rep = reg.publish("main", bf, k=5, warm_data=dataset[:50])
    assert sorted(rep["warm"][5]) == [1, 2]
    with pytest.raises(RaftError, match="warm sample"):
        reg.publish("other", bf, k=5,
                    warm_data=np.zeros((10, dataset.shape[1] + 1), np.float32))
    with pytest.raises(RaftError, match="dtype"):
        reg.publish("other2", bf, k=5, warm_data=dataset[:10].astype(np.int8))


def test_swap_retires_old_version_after_lease_drain(bf, dataset):
    reg = IndexRegistry(buckets=(1,))
    reg.publish("main", bf, k=5, warm=False)
    v1 = reg.active("main")
    with reg.lease("main") as leased:
        assert leased is v1
        reg.publish("main", brute_force.BruteForce().build(dataset, res=CPU), k=5,
                    warm=False)
        assert reg.live_versions("main") == (1, 2)
        assert leased.searcher is not None
    assert reg.live_versions("main") == (2,)
    assert v1.searcher is None


def test_lease_survives_retire_while_publish_mints_new_version(bf, dataset):
    reg = IndexRegistry(buckets=(1,))
    reg.publish("main", bf, k=5, warm=False)
    v1 = reg.active("main")
    with reg.lease("main") as leased:
        reg.publish("main", brute_force.BruteForce().build(dataset, res=CPU), k=5,
                    warm=False)
        v2 = reg.active("main")
        reg.publish("main", brute_force.BruteForce().build(dataset, res=CPU), k=5,
                    warm=False)
        assert reg.live_versions("main") == (1, 3)
        assert v2.searcher is None
        assert leased is v1 and leased.searcher is not None
        _, i = leased.searcher(dataset[:1], 5)
        assert tuple(i.shape) == (1, 5)
    assert reg.live_versions("main") == (3,)
    assert v1.searcher is None


def test_raising_searcher_releases_lease_and_version_retires(dataset):
    calls = []

    def boom(queries, k):
        calls.append(len(queries))
        raise RuntimeError("device fault mid-flush")

    clock = FakeClock()
    svc = SearchService(max_batch=4, max_wait_us=1.0, max_queue_rows=32,
                        clock=clock, start_workers=False)
    svc.publish("main", make_hook(boom, "custom", 16), k=5, warm=False)
    v1 = svc.registry.active("main")
    fut = svc.submit("main", dataset[:2], 5)
    clock.advance(1.0)
    svc.pump()
    with pytest.raises(RuntimeError, match="device fault"):
        fut.result(timeout=0)
    assert calls == [2] and v1.leases == 0
    svc.publish("main", make_hook(lambda q, k: boom(q, k), "custom", 16), k=5,
                warm=False)
    assert svc.registry.live_versions("main") == (2,)
    assert v1.searcher is None
    svc.shutdown()


def test_version_numbers_monotonic(bf):
    reg = IndexRegistry(buckets=(1,))
    reg.publish("main", bf, warm=False)
    reg.publish("main", bf, warm=False, version=7)
    with pytest.raises(RaftError):
        reg.publish("main", bf, warm=False, version=3)
    assert reg.active("main").version == 7


def test_contract_changing_republish_refused(bf, rng):
    reg = IndexRegistry(buckets=(1,))
    reg.publish("main", bf, k=5, warm=False)
    wide = brute_force.BruteForce().build(
        rng.standard_normal((64, 32)).astype(np.float32), res=CPU)
    with pytest.raises(RaftError):
        reg.publish("main", wide, k=5, warm=False)
    assert reg.active("main").version == 1


def test_publish_hook_with_search_params_refused(bf):
    reg = IndexRegistry(buckets=(1,))
    with pytest.raises(RaftError):
        reg.publish("main", brute_force.batched_searcher(bf), search_params=object(),
                    warm=False)


def test_external_registry_must_cover_service_buckets():
    reg = IndexRegistry(buckets=(1, 2, 4))
    with pytest.raises(RaftError):
        SearchService(reg, max_batch=8)
    SearchService(reg, max_batch=4).shutdown()


def test_not_yet_ported_surfaces(bf, dataset):
    """tune/ waits for a later slice: a tuned publish raises "not yet
    ported" before any state lands. The write path is ported: a duck-typed
    mutable publishes through its own searcher and opens upsert / delete,
    which a plain index under the name refuses."""
    reg = IndexRegistry(buckets=(1,))
    with pytest.raises(RaftError, match="not yet ported"):
        reg.publish("main", bf, tuned=True, warm=False)
    assert reg.names() == ()

    writes = []

    class Mutable:
        def upsert(self, rows, ids=None, res=None):
            writes.append(("upsert", len(rows)))
            return np.arange(len(rows))

        def delete(self, ids):
            writes.append(("delete", len(ids)))
            return 0

        def searcher(self):
            return brute_force.batched_searcher(bf)

    with pytest.raises(RaftError, match="bakes its search params"):
        reg.publish("main", Mutable(), search_params=object(), warm=False)
    reg.publish("main", Mutable(), warm=False)
    assert reg.names() == ("main",)
    svc = det_service(bf, FakeClock())
    with pytest.raises(RaftError, match="not a mutable"):
        svc.upsert("main", dataset[:1])
    with pytest.raises(RaftError, match="not a mutable"):
        svc.delete("main", [0])
    svc.publish("main", Mutable(), k=5, warm=False)
    svc.upsert("main", dataset[:2])
    svc.delete("main", [0])
    assert writes == [("upsert", 2), ("delete", 1)]
    svc.publish("main", bf, k=5, warm=False)       # a plain index closes it
    with pytest.raises(RaftError, match="not a mutable"):
        svc.upsert("main", dataset[:1])
    svc.shutdown()
    with pytest.raises(RaftError, match="not yet ported"):
        cagra.batched_searcher(dataclasses.replace(
            cagra.build(cagra.IndexParams(seed=0), dataset[:256], res=CPU),
            tuned={"itopk_size": 32}))


def test_publish_refused_over_memory_budget_zero_partial_state(bf, dataset):
    """memory_budget_bytes: a publish that would push the ledger past the
    budget raises MemoryBudgetError before the warm spend and the flip."""
    reg = IndexRegistry(buckets=(1,))
    gc.collect()
    gc.disable()      # no collection may release ledger entries mid-test
    try:
        used = obs.mem.totals()["device_bytes"]
        tight = Resources(device="cpu",
                          memory_budget_bytes=used + bf.dataset.nbytes - 1)
        with pytest.raises(MemoryBudgetError) as exc:
            reg.publish("main", bf, k=5, res=tight)
        assert isinstance(exc.value, OverloadedError)
        assert exc.value.site == "publish" and exc.value.need_bytes == bf.dataset.nbytes
        assert reg.names() == () and obs.mem.totals()["device_bytes"] == used
        roomy = dataclasses.replace(tight, memory_budget_bytes=used + bf.dataset.nbytes)
        reg.publish("main", bf, k=5, res=roomy, warm=False)
    finally:
        gc.enable()
    assert reg.active("main").version == 1
    assert obs.mem.unaccounted_index_bytes(bf) == 0


def test_hot_swap_under_concurrent_load_loses_nothing(bf, dataset):
    svc = SearchService(max_batch=8, max_wait_us=200.0, max_queue_rows=512)
    svc.publish("main", bf, k=5, warm=True)
    n_req, errors, done = 120, [], []
    lock = threading.Lock()

    def submitter(tid):
        for j in range(n_req // 4):
            r = (tid * 31 + j) % 500
            try:
                _, i = svc.submit("main", dataset[r:r + 1], 5).result(timeout=30)
                with lock:
                    done.append(int(i[0, 0]))
            except Exception as e:  # any failure is a test failure
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for _ in range(2):
        svc.publish("main", brute_force.BruteForce().build(dataset, res=CPU), k=5)
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "submitter wedged"
    svc.shutdown()
    assert errors == []
    assert len(done) == n_req
    assert len(svc.registry.live_versions("main")) == 1


# -- all four index kinds through the registry ------------------------------

def test_all_index_kinds_publishable(dataset):
    reg = IndexRegistry(buckets=(1, 2))
    idxs = {
        "bf": brute_force.BruteForce().build(dataset, res=CPU),
        "flat": ivf_flat.build(ivf_flat.IndexParams(n_lists=8, seed=0), dataset, res=CPU),
        "pq": ivf_pq.build(ivf_pq.IndexParams(n_lists=8, pq_bits=4, pq_dim=8, seed=0),
                           dataset, res=CPU),
        "cagra": cagra.build(cagra.IndexParams(seed=0), dataset, res=CPU),
    }
    params = {"flat": ivf_flat.SearchParams(n_probes=8),
              "pq": ivf_pq.SearchParams(n_probes=8),
              "cagra": cagra.SearchParams(itopk_size=32)}
    for name, idx in idxs.items():
        rep = reg.publish(name, idx, search_params=params.get(name), k=4)
        assert rep["version"] == 1 and 1 in rep["warm"][4]
        with reg.lease(name) as v:
            assert v.searcher.device == torch.device("cpu")
            d, i = v.searcher(dataset[:2], 4)
            assert tuple(d.shape) == (2, 4) and tuple(i.shape) == (2, 4)
            if name == "cagra":
                # the hook answers as search() with the same params
                rd, ri = cagra.search(params["cagra"], idx, dataset[:2], 4)
                assert torch.equal(i, ri) and torch.equal(d, rd)


def test_byte_index_serves_byte_queries(rng):
    xb = rng.integers(-128, 128, (256, 16), dtype=np.int8)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, list_dtype="int8", seed=0), xb,
                         res=CPU)
    assert idx.data_kind == "int8"
    clock = FakeClock()
    svc = SearchService(max_batch=2, clock=clock, start_workers=False)
    rep = svc.publish("bytes", idx, search_params=ivf_flat.SearchParams(n_probes=4), k=3)
    assert 1 in rep["warm"][3]
    fut = svc.submit("bytes", xb[:1], 3)
    clock.advance(1.0)
    assert svc.pump() == 1
    assert fut.result(timeout=0)[1].shape == (1, 3)
    with pytest.raises(RaftError):
        svc.submit("bytes", np.zeros((1, 16), np.float32), 3)


# -- direct batcher edge cases ----------------------------------------------

def test_batcher_flush_error_fails_whole_batch(dataset):
    def boom(q):
        raise ValueError("kernel exploded")

    clock = FakeClock()
    b = MicroBatcher(boom, max_batch=4, clock=clock, start=False)
    futs = [b.submit(dataset[:1]) for _ in range(2)]
    clock.advance(1.0)
    b.pump()
    for f in futs:
        with pytest.raises(ValueError):
            f.result(timeout=0)


def test_batcher_worker_thread_flushes(bf, dataset):
    b = MicroBatcher(lambda q: bf.search(q, 5), max_batch=4, max_wait_us=500.0,
                     start=True)
    worker = b._worker
    fut = b.submit(dataset[:1])
    d, i = fut.result(timeout=30)
    assert d.shape == (1, 5) and isinstance(d, np.ndarray)
    b.close(timeout_s=30)
    assert not worker.is_alive(), "the flush worker did not end"


def test_metrics_catalogue(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=4, max_queue_rows=4, warm=True)
    svc.submit("main", dataset[:1], 5)
    clock.advance(1.0)
    svc.pump()
    for j in range(4):
        svc.submit("main", dataset[j:j + 1], 5)
    with pytest.raises(OverloadedError):
        svc.submit("main", dataset[:1], 5)
    js = obs.to_json()
    for needed in (
            'raft_tpu_serve_queue_depth{stream="main.k5"}',
            'raft_tpu_serve_queue_wait_seconds_count{stream="main.k5"}',
            'raft_tpu_serve_flush_seconds_count{stream="main.k5"}',
            'raft_tpu_serve_batch_occupancy_count{stream="main.k5"}',
            'raft_tpu_serve_flush_total{bucket="1",stream="main.k5"}',
            'raft_tpu_serve_overload_total{name="main"}',
            'raft_tpu_serve_requests_total{stream="main.k5"}',
            'raft_tpu_serve_versions_live{name="main"}'):
        assert needed in js, f"missing {needed}"
    svc.shutdown(drain=True)


def test_queue_wait_vs_flush_decomposition(bf, dataset):
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=4)
    before = obs.to_json()
    svc.submit("main", dataset[:1], 5)
    clock.advance(0.25)
    svc.pump()
    d = obs.delta(before, obs.to_json())
    assert d.get('raft_tpu_serve_queue_wait_seconds_sum{stream="main.k5"}',
                 0.0) == pytest.approx(0.25)
    assert d.get('raft_tpu_serve_flush_seconds_count{stream="main.k5"}') == 1
    svc.shutdown(drain=True)


# -- staging ----------------------------------------------------------------

def test_full_buckets_back_to_back_equal_direct_search(bf, dataset):
    """Eight 8-row buckets staged back to back through the pipelined path
    (one staging buffer rotation and more) answer as direct searches do."""
    clock = FakeClock()
    svc = det_service(bf, clock, max_batch=8, max_queue_rows=64, pipeline_depth=2)
    futs = [svc.submit("main", dataset[j:j + 1], 5) for j in range(64)]
    flushed = 0
    while flushed < 64:
        n = svc.pump()
        assert n == 8
        flushed += n
    ref_d, ref_i = (t.numpy() for t in bf.search(dataset[:64], 5))
    got_d = np.concatenate([f.result(timeout=0)[0] for f in futs])
    got_i = np.concatenate([f.result(timeout=0)[1] for f in futs])
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_allclose(got_d, ref_d, rtol=RTOL, atol=ATOL)
    stats = svc.staging_stats()["main.k5"]
    assert stats["uploads"] == 8 and not stats["pinned"]
    svc.shutdown()


def test_staging_rotation_and_pad(dataset):
    st = StagingBuffers((1, 2, 4), 16, "float32", depth=2)
    views = [st.stage([dataset[:3]], 3, 4)[0] for _ in range(5)]
    # depth + 2 = 4 buffers rotate: the fifth flush reuses the first buffer
    assert np.shares_memory(views[4], views[0])
    assert not any(np.shares_memory(views[i], views[0]) for i in (1, 2, 3))
    host, q = st.stage([dataset[:1], dataset[1:2]], 2, 4)
    np.testing.assert_array_equal(host[:2], dataset[:2])
    assert not host[2:].any() and torch.equal(q, torch.from_numpy(host))
    with pytest.raises(RaftError):
        st.stage([dataset[:1]], 1, 8)
    st.release()


# -- parity with the JAX package ---------------------------------------------

SCRIPT_BUCKETS = (1, 2, 4, 8)


def _run_script(svc, clock, name, dataset, k):
    """One scripted request sequence: returns (answers, refusals)."""
    answers, refusals = [], []

    def note(fn):
        try:
            fn()
        except Exception as e:  # the refusal's type is what is compared
            refusals.append(type(e).__name__)

    futs = [svc.submit(name, dataset[j:j + 1], k) for j in range(3)]
    clock.advance(0.01)
    svc.pump()                                               # bucket 4, 3 rows
    futs += [svc.submit(name, dataset[3 + 2 * j:5 + 2 * j], k) for j in range(4)]
    svc.pump()                                               # bucket 8, full
    futs.append(svc.submit(name, dataset[20:21], k))
    note(lambda: svc.submit(name, dataset[21:22], k, timeout_s=0.0))
    dead = svc.submit(name, dataset[22:24], k, timeout_s=0.001)
    clock.advance(0.01)
    svc.pump()                                               # bucket 1
    note(lambda: dead.result(timeout=0))
    note(lambda: svc.submit(name, dataset[:9], k))           # wider than max_batch
    note(lambda: svc.submit(name, dataset[:1], k + 1))       # unpublished k
    note(lambda: svc.submit("nobody", dataset[:1], k))
    futs += [svc.submit(name, dataset[30 + 2 * j:32 + 2 * j], k) for j in range(8)]
    note(lambda: svc.submit(name, dataset[:1], k))           # queue at its bound
    svc.pump()                                               # bucket 8
    svc.pump()                                               # bucket 8
    futs.append(svc.submit(name, dataset[40:42], k))
    svc.shutdown(drain=True)
    note(lambda: svc.submit(name, dataset[:1], k))
    for f in futs:
        d, i = f.result(timeout=0)
        answers.append((np.asarray(d), np.asarray(i)))
    return answers, refusals


def _serve_series(js, name):
    return {key: v for key, v in js.items()
            if key.startswith("raft_tpu_serve_") and (f'"{name}' in key)}


@pytest.fixture(scope="module")
def jax_pq(tmp_path_factory):
    import jax.numpy as jnp

    x = np.random.default_rng(5).standard_normal((2000, 16)).astype(np.float32)
    index = jpq.build(jpq.IndexParams(n_lists=16, pq_dim=8, pq_bits=4, seed=0),
                      jnp.asarray(x))
    path = str(tmp_path_factory.mktemp("serve") / "pq.bin")
    jpq.save(index, path)
    return x, index, path


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("kind", ["brute_force", "ivf_pq"])
def test_scripted_sequence_matches_jax_service(kind, depth, jax_pq, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PQ_SCAN_INTERPRET", "1")
    x, jindex, path = jax_pq
    name = f"parity_{kind}_{depth}"
    if kind == "brute_force":
        jindex = jbf.BruteForce().build(x)
        bpath = str(tmp_path / "bf.bin")
        jbf.save(jindex, bpath)
        tindex = brute_force.load(bpath, res=CPU)
        jhook = jbf.batched_searcher(jindex)
        thook = brute_force.batched_searcher(tindex)
    else:
        tindex = ivf_pq.load(path, res=CPU)
        jhook = jpq.batched_searcher(jindex, jpq.SearchParams(n_probes=8))
        thook = ivf_pq.batched_searcher(tindex, ivf_pq.SearchParams(n_probes=8))
    runs = {}
    for pkg, cls, o, hook in (("jax", jserve.SearchService, jobs, jhook),
                              ("torch", SearchService, obs, thook)):
        calls = []
        clock = FakeClock()
        svc = cls(max_batch=8, max_wait_us=1000.0, max_queue_rows=16, clock=clock,
                  start_workers=False, pipeline_depth=depth)
        seq0 = o.events.last_seq()
        before = o.to_json()
        svc.publish(name, spy_hook(hook, calls), k=5, warm=False)
        answers, refusals = _run_script(svc, clock, name, x, 5)
        delta = o.delta(before, o.to_json())
        events = o.events.query(name=name, since_seq=seq0)
        runs[pkg] = dict(calls=calls, answers=answers, refusals=refusals,
                         metrics=_serve_series(delta, name),
                         events=[(e["kind"], sorted(e["evidence"])) for e in events])
    j, t = runs["jax"], runs["torch"]
    assert t["calls"] == j["calls"] == [4, 8, 1, 8, 8, 2]
    assert t["refusals"] == j["refusals"]
    assert t["refusals"] == ["DeadlineExceededError", "DeadlineExceededError", "RaftError",
                             "RaftError", "RaftError", "OverloadedError",
                             "ServiceClosedError"]
    assert len(t["answers"]) == len(j["answers"]) == 17
    for (td, ti), (jd, ji) in zip(t["answers"], j["answers"]):
        assert td.dtype == jd.dtype and ti.dtype == ji.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    assert t["metrics"] == j["metrics"]
    assert f'raft_tpu_serve_flush_total{{bucket="8",stream="{name}.k5"}}' in t["metrics"]
    assert t["events"] == j["events"] == [("serve_published", ["ks", "swap", "warmed"])]


def test_publish_and_retire_events_match_jax(dataset):
    """publish / swap / retire journal the same kinds and evidence keys in
    both packages."""
    import jax.numpy as jnp

    runs = {}
    for pkg, reg_cls, o, build in (
            ("jax", jserve.IndexRegistry, jobs, lambda: jbf.BruteForce().build(
                jnp.asarray(dataset))),
            ("torch", IndexRegistry, obs, lambda: brute_force.BruteForce().build(
                dataset, res=CPU))):
        reg = reg_cls(buckets=(1,))
        seq0 = o.events.last_seq()
        reg.publish("evparity", build(), k=5, warm=False)
        with reg.lease("evparity"):
            reg.publish("evparity", build(), k=5, warm=False)
        reg.publish("evparity", build(), k=5, warm=False)
        runs[pkg] = [(e["kind"], e["epoch"], sorted(e["evidence"]))
                     for e in o.events.query(name="evparity", since_seq=seq0)]
    assert runs["torch"] == runs["jax"]
    assert [kind for kind, _, _ in runs["torch"]] == [
        "serve_published", "serve_published", "serve_retired", "serve_retired",
        "serve_published"]


def test_warm_report_counts_kernel_builds(bf, monkeypatch):
    """A build reported during a warm call lands in that bucket's report;
    a publish against ready kernels reports none."""
    reg = IndexRegistry(buckets=(1, 2))
    searcher = brute_force.batched_searcher(bf)

    def building(queries, k):
        if queries.shape[0] == 2:
            obs_compile.record_build("fake", 1.5, cached=False)
            obs_compile.record_build("fake2", 0.0, cached=True)
        return searcher(queries, k)

    building.kind, building.dim, building.query_dtype = "x", 16, "float32"
    rep = reg.publish("main", building, k=5)
    assert rep["warm"][5][1]["programs"] == 0
    assert rep["warm"][5][2]["programs"] == 1
    assert rep["warm"][5][2]["cache_misses"] == 1 and rep["warm"][5][2]["cache_hits"] == 1
    assert rep["warm"][5][2]["compile_s"] == 1.5
