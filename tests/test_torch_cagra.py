"""raft_tpu_torch.neighbors.cagra against raft_tpu.neighbors.cagra.

On tests/test_cagra.py's 4,000 x 24 uniform set. The JAX index is built by
the JAX package (its knn graph, optimize and seed-pool estimate) and carried
into the port through ``from_state`` and through its file; searches are then
compared as tests/test_cagra.py compares its hop implementations: id overlap
>= 0.99 and sorted distances within rtol 1e-4 (ULP differences may reorder
near-ties at the beam boundary). The JAX fused hop runs in Pallas interpret
mode (RAFT_TPU_CAGRA_HOP_INTERPRET=1); the port's runs its plain version on
CPU tensors. ``optimize`` and ``estimate_seed_pool`` are compared for
equality; the port's own build, from other random streams, by recall.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.core import serialize as jser
from raft_tpu.neighbors import cagra as jc
from raft_tpu.random.rng import as_key
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.core.chunked import ChunkedReader
from raft_tpu_torch.core.serialize import _READ_COMPATIBLE
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import cagra as tc

CPU = Resources(device="cpu")
PARAMS = dict(intermediate_graph_degree=48, graph_degree=24, seed=0)


@pytest.fixture(autouse=True)
def _jax_kernel_route(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_CAGRA_HOP_INTERPRET", "1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain hop is thousands of small ops; with several test workers on
    one machine, torch's intra-op threads contend far more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.random((4000, 24)).astype(np.float32)
    q = rng.random((60, 24)).astype(np.float32)
    d2 = ((q.astype(np.float64)[:, None] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d2, axis=1, kind="stable")[:, :10]


@pytest.fixture(scope="module")
def jax_built(data):
    """(JAX knn graph, JAX index): jc.build's three stages, run once."""
    x, _, _ = data
    params = jc.IndexParams(**PARAMS)
    knn = jc.build_knn_graph(params, jnp.asarray(x))
    index = jc.CagraIndex(dataset=jnp.asarray(x), graph=jc.optimize(knn, 24),
                          metric=jc.resolve_metric("sqeuclidean"), data_kind="float32",
                          seed_pool_hint=jc.estimate_seed_pool(x, knn, seed=0))
    return np.asarray(knn), index


@pytest.fixture(scope="module")
def port_built(data):
    x, _, _ = data
    return tc.build(tc.IndexParams(**PARAMS), x, res=CPU)


def _state(jindex):
    return tc.from_state({"dataset": np.asarray(jindex.dataset),
                          "graph": np.asarray(jindex.graph)}, res=CPU,
                         metric=int(jindex.metric), data_kind=jindex.data_kind,
                         seed_pool_hint=jindex.seed_pool_hint)


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / gt.shape[1]
                    for r in range(gt.shape[0])])


def _assert_same_search(td, ti, jd, ji):
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    assert td.dtype == np.float32 and ti.dtype == np.int32
    assert td.shape == jd.shape and ti.shape == ji.shape
    overlap = np.mean([len(set(ti[r].tolist()) & set(ji[r].tolist())) / ti.shape[1]
                       for r in range(ti.shape[0])])
    assert overlap >= 0.99, overlap
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl,width", [
    ("xla", 1), ("fused_arena", 1), ("fused", 1), ("fused_arena_smem", 1),
    ("xla", 2), ("fused_arena", 2),
])
def test_search_matches_jax(data, jax_built, impl, width):
    _, q, _ = data
    _, jindex = jax_built
    sp = dict(itopk_size=32, search_width=width, hop_impl=impl)
    jd, ji = jc.search(jc.SearchParams(**sp), jindex, jnp.asarray(q), 10)
    td, ti = tc.search(tc.SearchParams(**sp), _state(jindex), q, 10)
    _assert_same_search(td, ti, jd, ji)


@pytest.mark.parametrize("impl", ["xla", "fused_arena"])
def test_sqrt_metric_matches_jax(data, jax_built, impl):
    _, q, _ = data
    _, jindex = jax_built
    jindex = dataclasses.replace(jindex, metric=jc.DistanceType.L2SqrtExpanded)
    tindex = _state(jindex)
    assert tindex.metric == DistanceType.L2SqrtExpanded
    sp = dict(itopk_size=32, hop_impl=impl)
    jd, ji = jc.search(jc.SearchParams(**sp), jindex, jnp.asarray(q), 5)
    td, ti = tc.search(tc.SearchParams(**sp), tindex, q, 5)
    _assert_same_search(td, ti, jd, ji)


@pytest.mark.parametrize("impl", ["xla", "fused_arena"])
def test_filtered_search_matches_jax(data, jax_built, impl):
    x, q, _ = data
    _, jindex = jax_built
    keep = np.ones(x.shape[0], bool)
    keep[: x.shape[0] // 2] = False
    sp = dict(itopk_size=32, hop_impl=impl)
    jd, ji = jc.search(jc.SearchParams(**sp), jindex, jnp.asarray(q), 10, sample_filter=keep)
    td, ti = tc.search(tc.SearchParams(**sp), _state(jindex), q, 10, sample_filter=keep)
    assert (ti.numpy() >= x.shape[0] // 2).all()
    _assert_same_search(td, ti, jd, ji)


@pytest.mark.parametrize("impl", ["xla", "fused_arena"])
def test_underfill_sentinels_match_jax(data, jax_built, check_filter_underfill, impl):
    from raft_tpu_torch.neighbors.sample_filter import BitsetFilter

    x, q, _ = data
    _, jindex = jax_built
    alive = [5, 77, 1234]
    keep = np.zeros(x.shape[0], bool)
    keep[alive] = True
    sp = dict(itopk_size=64, hop_impl=impl)
    jd, ji = jc.search(jc.SearchParams(**sp), jindex, jnp.asarray(q), 10, sample_filter=keep)
    td, ti = tc.search(tc.SearchParams(**sp), _state(jindex), q, 10,
                       sample_filter=BitsetFilter(keep))
    check_filter_underfill(td.numpy(), ti.numpy(), alive, select_min=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    with pytest.raises(RaftError, match="cover"):
        tc.search(tc.SearchParams(), _state(jindex), q, 10, sample_filter=keep[:-1])


@pytest.mark.parametrize("impl", ["xla", "fused_arena"])
def test_jax_drawn_entry_pool(data, jax_built, impl):
    """seed_pool < n: the port's search, handed the pool the JAX package
    draws for the same seed, answers as the JAX search."""
    x, q, _ = data
    _, jindex = jax_built
    pool, seed = 1024, 7
    jd, ji = jc.search(jc.SearchParams(itopk_size=32, seed_pool=pool, seed=seed,
                                       hop_impl=impl), jindex, jnp.asarray(q), 10)
    pool_ids = np.array(jax.random.choice(as_key(seed), x.shape[0], (pool,),
                                          replace=False))
    td, ti = tc._cagra_search(_state(jindex), torch.from_numpy(q), 10, 32, 42, 1, False,
                              seed_pool=pool, hop_impl=impl, pool_ids=pool_ids)
    _assert_same_search(td, ti, jd, ji)


@pytest.mark.parametrize("route", ["torch", "kernel"])
def test_entry_pool_select_routes_answer_as_jax(data, jax_built, monkeypatch, route):
    """The entry pool's top-k goes through select_k_impl(impl="auto"), so it
    takes the topk kernel wherever the wide-select rule says. Forced onto
    either route (the kernel's contract runs as its plain version on the
    CPU), the search answers as the JAX package's, whose pool select is
    lax.top_k."""
    x, q, _ = data
    _, jindex = jax_built
    pool, seed = 1024, 7
    jd, ji = jc.search(jc.SearchParams(itopk_size=32, seed_pool=pool, seed=seed,
                                       hop_impl="xla"), jindex, jnp.asarray(q), 10)
    pool_ids = np.array(jax.random.choice(as_key(seed), x.shape[0], (pool,),
                                          replace=False))
    calls = []
    routed = tc.select_k_impl

    def forced(values, in_idx, k, select_min, impl="auto"):
        calls.append((tuple(values.shape), k, impl))
        return routed(values, in_idx, k, select_min, impl=route)

    monkeypatch.setattr(tc, "select_k_impl", forced)
    td, ti = tc._cagra_search(_state(jindex), torch.from_numpy(q), 10, 32, 42, 1, False,
                              seed_pool=pool, hop_impl="xla", pool_ids=pool_ids)
    assert calls == [((q.shape[0], pool), 32, "auto")]
    _assert_same_search(td, ti, jd, ji)


@pytest.mark.parametrize("impl", ["xla", "fused_arena"])
def test_byte_index_searches_as_jax(data, jax_built, impl):
    """A uint8 index (held as shifted int8): byte and float queries."""
    x, q, _ = data
    _, jindex = jax_built
    xu = np.round(x * 255).astype(np.uint8)
    qu = np.round(q * 255).astype(np.uint8)
    shifted = (xu.astype(np.int16) - 128).astype(np.int8)
    jbytes = dataclasses.replace(jindex, dataset=jnp.asarray(shifted), data_kind="uint8")
    tbytes = _state(jbytes)
    assert tbytes.dataset.dtype == torch.int8 and tbytes.data_kind == "uint8"
    sp = dict(itopk_size=32, hop_impl=impl)
    for queries in (qu, qu.astype(np.float32)):
        jd, ji = jc.search(jc.SearchParams(**sp), jbytes, jnp.asarray(queries), 10)
        td, ti = tc.search(tc.SearchParams(**sp), tbytes, queries, 10)
        _assert_same_search(td, ti, jd, ji)
    with pytest.raises(RaftError, match="stores uint8"):
        tc.search(tc.SearchParams(**sp), tbytes, shifted[:5], 10)


@pytest.mark.parametrize("degree,workspace", [(24, None), (15, 48 ** 3 * 100)])
def test_optimize_equals_jax(jax_built, degree, workspace):
    knn, _ = jax_built
    res = CPU if workspace is None else Resources(device="cpu", workspace_bytes=workspace)
    want = np.asarray(jc.optimize(jnp.asarray(knn), degree))
    got = tc.optimize(knn, degree, res=res)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _clumpy(n_clumps, clump, d, scale, rng):
    centers = rng.random((n_clumps, d)).astype(np.float32)
    return (np.repeat(centers, clump, axis=0)
            + scale * rng.standard_normal((n_clumps * clump, d)).astype(np.float32))


def _clump_graph(n, clump, mates, rng):
    i = np.arange(n)
    group = (i // clump)[:, None] * clump + np.arange(clump)[None, :]
    own = np.stack([group[r][group[r] != r][:mates] for r in range(n)], axis=0)
    return np.concatenate([own, rng.integers(0, n, (n, 5))], axis=1).astype(np.int32)


@pytest.mark.parametrize("case", ["clumps", "isotropic", "few_modes"])
def test_estimate_seed_pool_same_hint(case):
    """TestSeedPoolAuto's three sets: the port gives the JAX package's hint."""
    if case == "clumps":
        rng = np.random.default_rng(0)
        x = _clumpy(16384, 4, 8, 1e-3, rng)
        g = _clump_graph(x.shape[0], 4, 3, rng)
    elif case == "isotropic":
        rng = np.random.default_rng(1)
        x = rng.random((8192, 16)).astype(np.float32)
        g = rng.integers(0, 8192, (8192, 8)).astype(np.int32)
    else:
        rng = np.random.default_rng(2)
        x = _clumpy(512, 16, 8, 1e-3, rng)
        g = _clump_graph(x.shape[0], 16, 7, rng)
    want = jc.estimate_seed_pool(x, g, seed=0)
    assert tc.estimate_seed_pool(x, g, seed=0, res=CPU) == want
    assert want == (32768 if case == "clumps" else 0)


def test_entry_points_run_on_the_handle(data, port_built):
    """``estimate_seed_pool`` places numpy input on its handle's device (CUDA
    unless the caller asks for the CPU); ``search`` runs on the index's device
    and refuses a handle that names another."""
    x, q, _ = data
    g = port_built.graph.numpy()
    assert tc.estimate_seed_pool(x, g, res=CPU) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RaftError, match="CUDA"):
            tc.estimate_seed_pool(x, g)
    sp = tc.SearchParams(itopk_size=32)
    d0, i0 = tc.search(sp, port_built, q, 10)
    d1, i1 = tc.search(sp, port_built, q, 10, res=CPU)
    assert d1.device.type == "cpu" and torch.equal(d0, d1) and torch.equal(i0, i1)
    for dev in ("cuda", "cuda:1"):
        with pytest.raises(RaftError, match="lives on cpu"):
            tc.search(sp, port_built, q, 10, res=Resources(device=dev))


def test_port_knn_graph_quality(data):
    """The port's own knn graph: edge recall > 0.8 (test_knn_graph_quality's bar)."""
    x, _, _ = data
    g = tc.build_knn_graph(tc.IndexParams(intermediate_graph_degree=16, graph_degree=8,
                                          seed=0), x, res=CPU)
    assert g.shape == (4000, 16) and g.dtype == torch.int32
    d2 = ((x[:200, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    true_i = np.argsort(d2, 1, kind="stable")[:, 1:17]
    assert _recall(g[:200].numpy(), true_i) > 0.8


def test_port_build_recall_matches_jax(data, jax_built, port_built):
    x, q, gt = data
    _, jindex = jax_built
    g = port_built.graph.numpy()
    assert g.shape == (4000, 24) and g.min() >= 0 and g.max() < 4000
    assert not (g == np.arange(4000)[:, None]).any()
    assert port_built.seed_pool_hint == jindex.seed_pool_hint == 0
    _, ji = jc.search(jc.SearchParams(itopk_size=64), jindex, jnp.asarray(q), 10)
    for impl in ("xla", "auto"):
        _, ti = tc.search(tc.SearchParams(itopk_size=64, hop_impl=impl), port_built, q, 10)
        assert _recall(ti, gt) >= _recall(ji, gt) - 0.05


def test_search_seed_contract(data, port_built):
    """The same seed searches the same entry pool, bit for bit; another seed
    draws another pool and stays a valid search."""
    _, q, gt = data
    sp = tc.SearchParams(itopk_size=32, seed_pool=512, seed=0)
    d1, i1 = tc.search(sp, port_built, q, 10)
    d2, i2 = tc.search(sp, port_built, q, 10)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    _, i3 = tc.search(dataclasses.replace(sp, seed=3), port_built, q, 10)
    assert _recall(i3, gt) > 0.9


@pytest.mark.parametrize("max_iterations,stop", [(3, "max_iter"), (500, "converged")])
@pytest.mark.parametrize("impl", ["xla", "fused_arena"])
def test_search_records_its_span_tree(data, port_built, monkeypatch, impl, max_iterations,
                                      stop):
    """Under tracing, a search records ``cagra.search`` (queries, hops,
    stop) over entry, hops and finish; ``hops`` counts the hops the route
    ran (``_xla_hop`` calls, or ``cagra_hop`` launches less the prime). The
    "xla" route records one ``cagra.hop`` an iteration, each holding one
    ``cagra.hop.flag_read``; the fused route one ``cagra.hop.chunk`` a chunk
    (its ``hops``; ``graph`` false on the CPU), each holding one
    ``cagra.hop.flag_read`` and a ``cagra.hop`` for each of its hops."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.ops import cagra_hop as hop_mod

    _, q, _ = data
    calls = []
    for mod, name in ((tc, "_xla_hop"), (hop_mod, "cagra_hop")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _n=name, **kw:
                            calls.append(_n) or _real(*a, **kw))
    params = tc.SearchParams(itopk_size=32, max_iterations=max_iterations, hop_impl=impl)
    tracing.clear()
    tracing.enable()
    try:
        tc.search(params, port_built, q, 10)
    finally:
        tracing.disable()
    spans = tracing.spans()
    tracing.clear()
    ran = calls.count("_xla_hop") if impl == "xla" else calls.count("cagra_hop") - 1
    (top,) = [s for s in spans if s.name == "cagra.search"]
    assert top.attrs == {"queries": q.shape[0], "hops": ran, "stop": stop}
    assert top.parent == 0 and {s.call for s in spans} == {top.id}
    kids = sorted((s for s in spans if s.parent == top.id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["cagra.search.entry", "cagra.search.hops",
                                      "cagra.search.finish"]
    hops = [s for s in spans if s.name == "cagra.hop"]
    reads = [s for s in spans if s.name == "cagra.hop.flag_read"]
    assert len(hops) == ran
    if impl == "xla":
        assert {s.parent for s in hops} == {kids[1].id}
        assert sorted(s.parent for s in reads) == sorted(s.id for s in hops)
    else:
        chunks = sorted((s for s in spans if s.name == "cagra.hop.chunk"),
                        key=lambda s: s.start_ns)
        assert chunks and {s.parent for s in chunks} == {kids[1].id}
        assert sorted(s.parent for s in reads) == sorted(s.id for s in chunks)
        assert sum(s.attrs["hops"] for s in chunks) == ran
        assert [s.attrs["hops"] for s in chunks[:-1]] == [tc._CHUNK] * (len(chunks) - 1)
        assert not any(s.attrs["graph"] for s in chunks)
        by_chunk = {s.id: s.attrs["hops"] for s in chunks}
        for s in hops:
            by_chunk[s.parent] -= 1
        assert set(by_chunk.values()) == {0}
    if stop == "max_iter":
        assert ran == max_iterations


def _per_hop_search(index, q, k, itopk, width, max_iter, merge, seed_pool, keep_mask):
    """The fused route as a plain loop that reads the convergence flag before
    every hop and stops at the first that reads converged."""
    from raft_tpu_torch.ops.cagra_hop import POOL, cagra_hop

    qf = torch.as_tensor(q, dtype=torch.float32)
    ids, dist, vis = tc._entry_beam(index, qf, itopk, width, seed_pool, keep_mask, 0, None)
    m, n, deg = qf.shape[0], index.size, index.graph_degree
    bd = torch.full((m, POOL), np.inf)
    bd[:, :itopk] = (dist[:, :itopk] + (qf * qf).sum(1, keepdim=True)).clamp_min(0.0)
    bi = torch.full((m, POOL), -1, dtype=torch.int32)
    bi[:, :itopk] = ids[:, :itopk]
    bv = torch.ones((m, POOL), dtype=torch.int32)
    bv[:, :itopk] = vis[:, :itopk].to(torch.int32)
    cw = width * deg
    bd, bi, bv, pick, nocand = cagra_hop(qf, bd, bi, bv, torch.full((m, cw), -1, dtype=torch.int32),
                                         index.dataset, torch.zeros((m, cw), dtype=torch.int32),
                                         itopk, width, merge=merge)
    for _ in range(max_iter):
        if bool((nocand[:, 0] > 0).all()):
            break
        nbrs = index.graph[pick.to(torch.int64).clamp_max(n - 1)].reshape(m, cw)
        valid = (1 - nocand).repeat_interleave(deg, dim=1)
        if keep_mask is not None:
            valid = valid * keep_mask[nbrs.to(torch.int64).clamp_min(0)].to(torch.int32)
        bd, bi, bv, pick, nocand = cagra_hop(qf, bd, bi, bv, nbrs, index.dataset, valid, itopk,
                                             width, merge=merge)
    if merge != "extract":
        bd, bi = tc._select_k(bd, bi, itopk, True)
    out_d = bd[:, :k].clamp_min(0.0)
    return out_d, torch.where(torch.isinf(out_d), -1, bi[:, :k])


@pytest.mark.parametrize("max_iterations", [3, 9, 74, 500])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("impl", ["fused", "fused_arena"])
def test_chunked_loop_answers_as_a_per_hop_loop(data, port_built, impl, width, filtered,
                                                max_iterations):
    """The fused route's chunks (a flag read a chunk, masked hops past a
    batch's convergence, a shorter last chunk) answer bit for bit as a loop
    that reads the flag before every hop: ids and distances, both merges."""
    x, q, _ = data
    keep = (torch.from_numpy(np.random.default_rng(5).random(x.shape[0])) < 0.6
            if filtered else None)
    params = tc.SearchParams(itopk_size=32, search_width=width, max_iterations=max_iterations,
                             seed_pool=512, hop_impl=impl)
    got_d, got_i = tc.search(params, port_built, q, 10, sample_filter=keep)
    want_d, want_i = _per_hop_search(port_built, q, 10, 32, width, max_iterations,
                                     tc._MERGE_OF[impl], 512, keep)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    if filtered:
        assert keep[got_i[got_i >= 0].to(torch.int64)].all()


def test_build_observes_its_phases_and_records_their_spans(data):
    """``cagra.build`` observes ``raft_tpu_build_phase_seconds`` for
    cagra/knn_graph and cagra/optimize (docs/observability.md) and records a
    span for each phase and the seed-pool estimate."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.obs import metrics

    x, _, _ = data

    def observed():
        meta = metrics.snapshot().get("raft_tpu_build_phase_seconds", {"series": []})
        return {s["labels"]["phase"]: (s["count"], s["sum"]) for s in meta["series"]}

    before = observed()
    tracing.clear()
    tracing.enable()
    try:
        tc.build(tc.IndexParams(intermediate_graph_degree=16, graph_degree=8), x[:800], res=CPU)
    finally:
        tracing.disable()
    after = observed()
    for phase in ("cagra/knn_graph", "cagra/optimize"):
        n0, s0 = before.get(phase, (0, 0.0))
        assert after[phase][0] == n0 + 1 and after[phase][1] > s0
    names = [s.name for s in tracing.spans()]
    tracing.clear()
    for name in ("cagra.build.knn_graph", "cagra.build.seed_pool", "cagra.build.optimize"):
        assert names.count(name) == 1


def test_jax_file_loads_and_bytes_round_trip(data, jax_built, tmp_path):
    _, q, _ = data
    _, jindex = jax_built
    jindex = dataclasses.replace(jindex, seed_pool_hint=32768, tuned={"itopk_size": 32})
    path = str(tmp_path / "jax.bin")
    jc.save(jindex, path)
    tindex = tc.load(path, res=CPU)
    assert tindex.seed_pool_hint == 32768 and tindex.tuned == {"itopk_size": 32}
    buf = io.BytesIO()
    tc.write_index(buf, tindex)
    assert buf.getvalue() == open(path, "rb").read()
    sp = dict(itopk_size=32, hop_impl="xla")
    jd, ji = jc.search(jc.SearchParams(**sp), jindex, jnp.asarray(q), 10)
    td, ti = tc.search(tc.SearchParams(**sp), tindex, q, 10)
    _assert_same_search(td, ti, jd, ji)


def test_port_file_loads_in_jax(data, port_built, tmp_path):
    _, q, _ = data
    path = str(tmp_path / "port.bin")
    tc.save(port_built, path)
    jindex = jc.load(path)
    np.testing.assert_array_equal(np.asarray(jindex.graph), port_built.graph.numpy())
    buf = io.BytesIO()
    jc.write_index(buf, jindex)
    assert buf.getvalue() == open(path, "rb").read()
    sp = dict(itopk_size=32, hop_impl="xla")
    jd, ji = jc.search(jc.SearchParams(**sp), jindex, jnp.asarray(q), 10)
    td, ti = tc.search(tc.SearchParams(**sp), port_built, q, 10)
    _assert_same_search(td, ti, jd, ji)


@pytest.mark.parametrize("version", sorted(_READ_COMPATIBLE["cagra"]))
def test_reads_older_versions(jax_built, version):
    """A file of each older layout (hint from /4, data kind from /6, the
    tuned record from /9) reads as the JAX package reads it."""
    _, jindex = jax_built
    n = int(version.rsplit("/", 1)[1])
    buf = io.BytesIO()
    jser.serialize_scalar(buf, "cagra")
    jser.serialize_scalar(buf, version)
    jser.serialize_scalar(buf, int(jindex.metric))
    if n >= 4:
        jser.serialize_scalar(buf, 4096)
    if n >= 6:
        jser.serialize_scalar(buf, "float32")
    jser.serialize_mdspan(buf, np.asarray(jindex.dataset)[:50])
    jser.serialize_mdspan(buf, np.asarray(jindex.graph)[:50])
    if n >= 9:
        jser.serialize_scalar(buf, False)
    raw = buf.getvalue()
    want = jc.read_index(io.BytesIO(raw))
    got = tc.read_index(io.BytesIO(raw))
    assert got.seed_pool_hint == want.seed_pool_hint == (4096 if n >= 4 else 0)
    assert got.data_kind == want.data_kind and got.tuned is want.tuned is None
    assert int(got.metric) == int(want.metric)
    np.testing.assert_array_equal(got.dataset.numpy(), np.asarray(want.dataset))
    np.testing.assert_array_equal(got.graph.numpy(), np.asarray(want.graph))


def test_hop_impl_resolution_and_guard(data, port_built):
    _, q, _ = data
    assert tc.resolve_hop_impl(tc.SearchParams(itopk_size=32), 24, 24) == "fused_arena"
    assert tc.resolve_hop_impl(tc.SearchParams(itopk_size=128), 24, 24) == "xla"
    # itopk 64 + 3 * 24 = 136 > 128: the pool does not fit the beam's lanes
    with pytest.raises(RaftError, match="hop_impl='fused'"):
        tc.search(tc.SearchParams(itopk_size=64, search_width=3, hop_impl="fused"),
                  port_built, q, 5)
    with pytest.raises(RaftError, match="hop_impl must be"):
        tc.search(tc.SearchParams(hop_impl="pallas"), port_built, q, 5)
    with pytest.raises(RaftError, match="itopk_size"):
        tc.search(tc.SearchParams(itopk_size=8), port_built, q, 10)
    with pytest.raises(RaftError, match="query dim"):
        tc.search(tc.SearchParams(), port_built, q[:, :8], 10)


def test_not_yet_ported_and_contract_errors(data):
    x, _, _ = data

    params = tc.IndexParams(intermediate_graph_degree=16, graph_degree=8)
    # byte datasets build (tests/test_torch_cagra_bytes.py); a chunked
    # reader streams to the in-core build of its rows
    streamed = tc.build(params, ChunkedReader(x[:600], chunk_rows=250), res=CPU)
    incore = tc.build(params, x[:600], res=CPU)
    assert torch.equal(streamed.dataset, incore.dataset)
    assert torch.equal(streamed.graph, incore.graph)
    with pytest.raises(RaftError, match="L2"):
        tc.build(tc.IndexParams(metric="inner_product"), x, res=CPU)
    with pytest.raises(RaftError, match="graph_degree"):
        tc.build(tc.IndexParams(intermediate_graph_degree=8, graph_degree=16), x, res=CPU)
    with pytest.raises(RaftError, match="expected arrays"):
        tc.from_state({"dataset": x}, res=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RaftError, match="CUDA"):
            tc.build(params, x[:500])
