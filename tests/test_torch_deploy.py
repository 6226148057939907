"""raft_tpu_torch's deploy-time surface against the JAX package's:
``config`` (the output setting and the kernel-build cache), ``_warmup.
warmup``, ``core.interruptible``, ``core.operators`` and
``core.temporary_buffer``.

The same inputs, made from a numpy seed, go through the JAX function and
the port's, and the answers must agree: operators exactly (float results at
rtol 1e-6), the six decorated entry points' values under
``set_output_as("numpy")`` exactly for integer ids and at rtol = atol = 1e-5
for distances (IVF-PQ: the id set of each row, as tests/test_torch_ivf_pq.py
compares). Port differences, each pinned here: ``"jax"`` is refused and the
default ``"torch"`` converts nothing; the port's own callers (serve hooks,
mutable and sharded indexes, the tuner) keep tensors on the index's device
under ``"numpy"``; ``warmup`` takes ``res=`` and reports
``attribution: "obs.compile"`` (the port's build recorder). Everything runs
on the CPU.
"""

import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raft_tpu
import raft_tpu.config as jconfig
import raft_tpu_torch
from raft_tpu.core import errors as jerrors
from raft_tpu.core import operators as jops
from raft_tpu.core import temporary_buffer as jtmp
from raft_tpu.distance import pairwise as jpairwise
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import config
from raft_tpu_torch.core import RaftError, Resources, interruptible as tint_cm
from raft_tpu_torch.core import operators as tops
from raft_tpu_torch.core import set_default_resources, default_resources
from raft_tpu_torch.core.interruptible import (InterruptedException, Token, cancel,
                                               get_token, synchronize, yield_no_throw)
from raft_tpu_torch.core.temporary_buffer import temporary_device_buffer
from raft_tpu_torch.distance import pairwise as tpairwise
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import _build

CPU = Resources(device="cpu")
RTOL = ATOL = 1e-5
# the module (``raft_tpu.core.interruptible`` the name is its context manager)
jint = importlib.import_module("raft_tpu.core.interruptible")
jselect = importlib.import_module("raft_tpu.matrix.select_k")
tselect = importlib.import_module("raft_tpu_torch.matrix.select_k")


@pytest.fixture(autouse=True)
def _torch_output_and_threads():
    """Every test starts and ends on the default output settings; torch on
    one thread, as the other port files (the suite runs in six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    config.set_output_as("torch")
    jconfig.set_output_as("jax")
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(24, 16)) * 3.0
    x = (centers[rng.integers(0, 24, 1500)] + rng.normal(size=(1500, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 24)] + rng.normal(size=(24, 16))).astype(np.float32)
    return x, q


# -- core.operators ------------------------------------------------------------------

def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same(t, j):
    t, j = _host(t), _host(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if t.dtype == np.bool_ or np.issubdtype(t.dtype, np.integer):
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j.astype(t.dtype), rtol=1e-6, atol=0)


_RNG = np.random.default_rng(3)
_A = np.concatenate([_RNG.normal(size=14).astype(np.float32), [0.0, 2.0]]).astype(np.float32)
_B = np.concatenate([_RNG.normal(size=12).astype(np.float32), [0.0, 0.0, 2.0, -1.5]]
                    ).astype(np.float32)
_POS = np.abs(_A) + 0.5

UNARY = ["identity_op", "sq_op", "abs_op", "sqrt_op", "nz_op"]
BINARY = ["add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op", "min_op", "max_op",
          "equal_op", "notequal_op"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_operators_match_jax(name):
    a = _POS if name == "sqrt_op" else _A
    _same(getattr(tops, name)(torch.from_numpy(a)), getattr(jops, name)(jnp.asarray(a)))


@pytest.mark.parametrize("name", BINARY)
def test_binary_operators_match_jax(name):
    t = getattr(tops, name)(torch.from_numpy(_A), torch.from_numpy(_B))
    j = getattr(jops, name)(jnp.asarray(_A), jnp.asarray(_B))
    _same(t, j)


def test_div_checkzero_and_pow_match_jax():
    b = _B.copy()
    assert (b == 0).sum() == 2
    t = tops.div_checkzero_op(torch.from_numpy(_A), torch.from_numpy(b))
    assert float(t[b == 0].abs().sum()) == 0.0                 # 0 where b == 0
    _same(t, jops.div_checkzero_op(jnp.asarray(_A), jnp.asarray(b)))
    ai = np.array([1, 4, -3, 0], np.int32)
    bi = np.array([0, 2, 2, 0], np.int32)
    _same(tops.div_checkzero_op(torch.from_numpy(ai), torch.from_numpy(bi)),
          jops.div_checkzero_op(jnp.asarray(ai), jnp.asarray(bi)))
    _same(tops.pow_op(torch.from_numpy(_POS), 1.5), jops.pow_op(jnp.asarray(_POS), 1.5))


@pytest.mark.parametrize("dtype", ["int32", np.int8, "float16", torch.int16])
def test_cast_op_matches_jax(dtype):
    x = np.array([-2.7, -0.5, 0.0, 1.49, 3.9, 100.25], np.float32)
    t = tops.cast_op(dtype)(torch.from_numpy(x))
    jd = str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else dtype
    j = jops.cast_op(jd)(jnp.asarray(x))
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    _same(t, j)


@pytest.mark.parametrize("op", ["argmin_op", "argmax_op"])
def test_kvp_reductions_keep_the_lower_key_on_ties(op):
    rng = np.random.default_rng(5)
    # values from a small set, so most pairs tie; keys in both orders
    va = rng.integers(0, 3, 64).astype(np.float32)
    vb = rng.integers(0, 3, 64).astype(np.float32)
    ka = rng.permutation(64).astype(np.int32)
    kb = rng.permutation(64).astype(np.int32)
    t = getattr(tops, op)(tops.KeyValuePair(torch.from_numpy(ka), torch.from_numpy(va)),
                          tops.KeyValuePair(torch.from_numpy(kb), torch.from_numpy(vb)))
    j = getattr(jops, op)(jops.KeyValuePair(jnp.asarray(ka), jnp.asarray(va)),
                          jops.KeyValuePair(jnp.asarray(kb), jnp.asarray(vb)))
    _same(t.key, j.key)
    _same(t.value, j.value)
    tie = va == vb
    assert tie.sum() > 10
    np.testing.assert_array_equal(t.key.numpy()[tie], np.minimum(ka, kb)[tie])
    # a row-wise reduction folds to the lowest key among the best values
    vals = np.array([3.0, 1.0, 1.0, 2.0, 1.0], np.float32)
    acc = tops.KeyValuePair(torch.tensor(0), torch.tensor(vals[0]))
    jacc = jops.KeyValuePair(jnp.asarray(0), jnp.asarray(vals[0]))
    for i in range(1, 5):
        acc = getattr(tops, op)(acc, tops.KeyValuePair(torch.tensor(i), torch.tensor(vals[i])))
        jacc = getattr(jops, op)(jacc, jops.KeyValuePair(jnp.asarray(i), jnp.asarray(vals[i])))
    assert int(acc.key) == int(jacc.key) == (1 if op == "argmin_op" else 0)


def test_adapters_match_jax():
    x = torch.from_numpy(_A)
    jx = jnp.asarray(_A)
    _same(tops.compose_op(tops.sqrt_op, tops.abs_op)(x), jops.compose_op(jops.sqrt_op,
                                                                         jops.abs_op)(jx))
    _same(tops.compose_op(tops.sq_op, tops.add_op)(x, 1.0),
          jops.compose_op(jops.sq_op, jops.add_op)(jx, 1.0))
    _same(tops.plug_const_op(2.0, tops.mul_op)(x), jops.plug_const_op(2.0, jops.mul_op)(jx))
    kvp = tops.KeyValuePair(3, 1.5)
    assert tops.key_op(kvp) == jops.key_op(jops.KeyValuePair(3, 1.5)) == 3
    assert tops.value_op(kvp) == 1.5
    assert tops.void_op(1, 2) is jops.void_op(1, 2) is None
    assert tops.__all__ == jops.__all__


# -- core.interruptible (tests/test_aux.py:20-66) -------------------------------------

def test_interruptible_cancel_same_thread():
    cancel()
    with pytest.raises(InterruptedException, match="raft_tpu task cancelled"):
        synchronize()
    synchronize()                                    # the flag cleared on throw


def test_interruptible_cancel_cross_thread():
    state = {"ready": threading.Event(), "go": threading.Event()}

    def worker():
        get_token()
        state["tid"] = threading.get_ident()
        state["ready"].set()
        state["go"].wait()
        try:
            for _ in range(1000):
                synchronize(torch.zeros(2))
                time.sleep(0.001)
            state["result"] = "completed"
        except InterruptedException:
            state["result"] = "cancelled"

    t = threading.Thread(target=worker)
    t.start()
    state["ready"].wait()
    cancel(state["tid"])
    state["go"].set()
    t.join()
    assert state["result"] == "cancelled"


def test_yield_no_throw():
    cancel()
    assert yield_no_throw() is True
    assert yield_no_throw() is False


def test_interruptible_context():
    with tint_cm() as tok:
        assert isinstance(tok, Token) and not tok.cancelled()
    with jint.interruptible() as jtok:
        assert not jtok.cancelled()


def test_token_semantics_match_jax():
    """The exception type's place, the message, the purge of dead threads'
    tokens and synchronize over nested CPU tensors (no device wait)."""
    assert issubclass(InterruptedException, RuntimeError)
    msgs = []
    for tok in (Token(), jint.Token()):
        tok.cancel()
        assert tok.cancelled()
        with pytest.raises(RuntimeError) as e:
            tok.check()
        msgs.append(str(e.value))
        assert not tok.cancelled()
    assert msgs[0] == msgs[1]
    for get in (get_token, jint.get_token):
        seen = {}
        t = threading.Thread(target=lambda: seen.update(tid=threading.get_ident(),
                                                        tok=get()))
        t.start()
        t.join()
        seen["tok"].cancel()
        get()                           # any access purges the dead thread's token
        fresh = get(seen["tid"])
        assert fresh is not seen["tok"] and not fresh.cancelled()
    synchronize({"a": (torch.ones(3), [torch.zeros(1)])}, 5)
    assert tint_cm is raft_tpu_torch.core.interruptible


# -- core.temporary_buffer ----------------------------------------------------------

@pytest.mark.parametrize("writeback", [False, True])
def test_temporary_device_buffer_matches_jax(writeback):
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    outs = []
    for fn, dev in ((temporary_device_buffer, "cpu"), (jtmp.temporary_device_buffer, None)):
        host = base.copy()
        with fn(host, writeback=writeback, device=dev) as buf:
            if fn is temporary_device_buffer:
                assert isinstance(buf.array, torch.Tensor) and buf.array.device.type == "cpu"
            buf.array = buf.array * 2 + 1
        outs.append(host)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], base * 2 + 1 if writeback else base)


def test_temporary_device_buffer_defaults_to_the_default_handle():
    prev = default_resources()
    set_default_resources(Resources(device="cpu"))
    try:
        with temporary_device_buffer(np.ones(3, np.float32)) as buf:
            assert buf.array.device.type == "cpu"
    finally:
        set_default_resources(prev)


# -- config: the output setting ------------------------------------------------------

def test_output_setting_surface_and_port_differences():
    """``"jax"`` is refused (the port never imports JAX); the default
    ``"torch"`` returns the very tensors; the surface is JAX's."""
    assert config.get_output_as() == "torch"
    with pytest.raises(ValueError, match="never imports JAX"):
        config.set_output_as("jax")
    with pytest.raises(ValueError):
        config.set_output_as("cupy")
    with pytest.raises(ValueError):
        jconfig.set_output_as("cupy")
    assert config.get_output_as() == "torch"
    t = torch.arange(3)

    @config.auto_convert_output
    def ident():
        return t

    assert ident() is t
    assert set(config.__all__) - {"keep_tensors"} == set(jconfig.__all__)


def test_convert_recurses_into_lists_and_dicts():
    """tests/test_obs.py:465's case in both packages."""
    @config.auto_convert_output
    def multi():
        a = torch.arange(3)
        return {"pair": (a, a + 1), "items": [a * 2], "n": 5}

    @jconfig.auto_convert_output
    def jmulti():
        a = jnp.arange(3)
        return {"pair": (a, a + 1), "items": [a * 2], "n": 5}

    config.set_output_as("numpy")
    jconfig.set_output_as("numpy")
    out, jout = multi(), jmulti()
    for got, want in ((out["pair"][0], jout["pair"][0]), (out["pair"][1], jout["pair"][1]),
                      (out["items"][0], jout["items"][0])):
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
        np.testing.assert_array_equal(got, want)
    assert out["n"] == jout["n"] == 5
    config.set_output_as(lambda v: ("seen", tuple(v.shape)))
    assert multi()["items"][0] == ("seen", (3,))


def test_only_the_outermost_call_converts():
    inner_types = []

    @config.auto_convert_output
    def inner():
        return torch.ones(2)

    @config.auto_convert_output
    def outer():
        v = inner()
        inner_types.append(type(v))
        return v * 2

    config.set_output_as("numpy")
    out = outer()
    assert isinstance(out, np.ndarray) and inner_types == [torch.Tensor]
    assert isinstance(inner(), np.ndarray)
    assert isinstance(inner.native(), torch.Tensor)
    with config.keep_tensors():
        assert isinstance(inner(), torch.Tensor)
    assert isinstance(inner(), np.ndarray)


@pytest.fixture(scope="module")
def jax_indexes(data, tmp_path_factory):
    """A JAX IVF-Flat and IVF-PQ index and their files."""
    x, _ = data
    out = {}
    d = tmp_path_factory.mktemp("deploy")
    for name, mod, params in (("ivf_flat", jfl, jfl.IndexParams(n_lists=16, seed=0)),
                              ("ivf_pq", jpq, jpq.IndexParams(n_lists=16, pq_dim=8,
                                                              seed=0))):
        index = mod.build(params, jnp.asarray(x))
        path = str(d / f"{name}.bin")
        mod.save(index, path)
        out[name] = (index, path)
    return out


def _entry_calls(data, jax_indexes):
    """entry point -> (port call, JAX call, id column exactness)."""
    x, q = data
    tf = tfl.load(jax_indexes["ivf_flat"][1], res=CPU)
    tp = tpq.load(jax_indexes["ivf_pq"][1], res=CPU)
    jf, jp = jax_indexes["ivf_flat"][0], jax_indexes["ivf_pq"][0]
    vals = np.random.default_rng(9).normal(size=(8, 300)).astype(np.float32)
    return {
        "pairwise_distance": (lambda: tpairwise.pairwise_distance(x[:40], x[:30], res=CPU),
                              lambda: jpairwise.pairwise_distance(x[:40], x[:30])),
        "select_k": (lambda: tselect.select_k(vals, 7, res=CPU),
                     lambda: jselect.select_k(vals, 7)),
        "knn": (lambda: tbf.knn(x, q, 5, res=CPU), lambda: jbf.knn(x, q, 5)),
        "ivf_flat.search": (lambda: tfl.search(tfl.SearchParams(n_probes=4), tf, q, 5, res=CPU),
                            lambda: jfl.search(jfl.SearchParams(n_probes=4), jf, q, 5)),
        "ivf_pq.search": (lambda: tpq.search(tpq.SearchParams(n_probes=4), tp, q, 5, res=CPU),
                          lambda: jpq.search(jpq.SearchParams(n_probes=4, scan_impl="onehot"),
                                             jp, q, 5)),
    }


@pytest.mark.parametrize("name", ["pairwise_distance", "select_k", "knn", "ivf_flat.search",
                                  "ivf_pq.search"])
def test_entry_points_convert_to_numpy_as_jax(name, data, jax_indexes):
    tcall, jcall = _entry_calls(data, jax_indexes)[name]
    native = tcall()
    config.set_output_as("numpy")
    jconfig.set_output_as("numpy")
    got, want = tcall(), jcall()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    native = native if isinstance(native, tuple) else (native,)
    assert len(got) == len(want)
    for g, w, n in zip(got, want, native):
        assert isinstance(g, np.ndarray) and isinstance(w, np.ndarray), (type(g), type(w))
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, n.numpy())          # "numpy" equals "torch"
    if name == "ivf_pq.search":
        for r in range(got[1].shape[0]):
            assert set(got[1][r].tolist()) == set(want[1][r].tolist()), r
        np.testing.assert_allclose(np.sort(got[0], 1), np.sort(want[0], 1),
                                   rtol=RTOL, atol=1e-4)
    elif len(got) == 2:
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[1], want[1])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-4)


def test_cagra_search_converts_to_numpy(data):
    """The sixth decorated entry point: CAGRA's entry pool is drawn by each
    package's own generator (tests/test_torch_cagra.py holds the search to
    JAX's through the drawn pool), so here "numpy" is held to "torch"."""
    x, q = data
    index = tcagra.build(tcagra.IndexParams(graph_degree=16, intermediate_graph_degree=24,
                                            seed=0), x[:600], res=CPU)
    sp = tcagra.SearchParams(itopk_size=32)
    d, i = tcagra.search(sp, index, q, 5, res=CPU)
    config.set_output_as("numpy")
    nd, ni = tcagra.search(sp, index, q, 5, res=CPU)
    assert isinstance(nd, np.ndarray) and isinstance(ni, np.ndarray)
    assert nd.dtype == np.float32 and ni.dtype == np.int32
    np.testing.assert_array_equal(nd, d.numpy())
    np.testing.assert_array_equal(ni, i.numpy())


def test_port_callers_keep_tensors_under_numpy(data):
    """Serve hooks and flushes, the mutable and sharded indexes, k-means and
    the tuner run on the index's device with the same answers under
    ``"numpy"`` as under ``"torch"``."""
    from raft_tpu_torch import stream, tune
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.serve import SearchService

    x, q = data
    flat = tfl.build(tfl.IndexParams(n_lists=16, seed=0), x, res=CPU)
    hook = tfl.batched_searcher(flat, tfl.SearchParams(n_probes=4))
    mut = stream.MutableIndex(flat, search_params=tfl.SearchParams(n_probes=4),
                              delta_capacity=64)
    mut.upsert(q[:8])
    mesh = stream.ShardedMutableIndex(
        x[:800], n_shards=2, build=lambda rows: tbf.BruteForce().build(rows, res=CPU),
        delta_capacity=64)
    grid = [{"n_probes": 2}, {"n_probes": 8}]
    centers = x[:8].copy()

    def run():
        svc = SearchService(max_batch=8, start_workers=False)
        svc.publish("flat", flat, search_params=tfl.SearchParams(n_probes=4), k=5,
                    warm=False)
        futs = [svc.submit("flat", q[j:j + 1], 5) for j in range(6)]
        svc.pump(force=True)
        served = [f.result(timeout=5) for f in futs]
        svc.shutdown()
        dec = tune.sweep(flat, q, k=5, dataset=x, grid=grid, repeats=1)
        km = kmeans.fit(kmeans.KMeansParams(n_clusters=8, init="array", max_iter=3), x,
                        centroids=centers, res=CPU).centroids
        return (hook(q, 5), mut.search(q, 5), mesh.search(q, 5), served,
                [t["recall"] for t in dec.evidence["trials"]], km)

    a = run()
    config.set_output_as("numpy")
    b = run()
    for ta, tb in zip(a[:3], b[:3]):
        for u, v in zip(ta, tb):
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            assert torch.equal(u, v)
    for (da, ia), (db, ib) in zip(a[3], b[3]):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(ia, ib)
    assert a[4] == b[4]
    assert isinstance(b[5], torch.Tensor) and torch.equal(a[5], b[5])


# -- config: the kernel-build cache -------------------------------------------------

def test_enable_compilation_cache_points_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    target = tmp_path / "kernels"
    got = config.enable_compilation_cache(str(target))
    assert got == str(target.resolve()) and target.is_dir()
    assert _build.BUILD_DIR == target.resolve()
    assert _build._lib_path("topk").parent == target.resolve()
    assert config.enable_compilation_cache() == str(_build.DEFAULT_BUILD_DIR.resolve())
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR.resolve()


# -- _warmup.warmup ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_warmup_keys(tmp_path_factory):
    """The JAX warmup's result layout, from a subprocess (its cache redirect
    is process-wide), at a tiny shape."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    cache = tmp_path_factory.mktemp("jaxwarm")
    code = f"""
import json, sys
sys.path.insert(0, {str(repo)!r})
from raft_tpu.core.platform import force_virtual_cpu
force_virtual_cpu(1)
import raft_tpu
out = raft_tpu.warmup("brute_force", n=256, d=8, queries=16, cache_dir={str(cache)!r})
print(json.dumps({{"top": sorted(out), "build": sorted(out["build"]),
                  "search": sorted(out["search"]), "attribution": out["attribution"]}}))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_warmup_result_keys_match_jax(jax_warmup_keys, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    out = raft_tpu_torch.warmup("brute_force", n=256, d=8, queries=16,
                                cache_dir=str(tmp_path), res=CPU)
    assert sorted(out) == jax_warmup_keys["top"]
    assert sorted(out["build"]) == jax_warmup_keys["build"]
    assert sorted(out["search"]) == jax_warmup_keys["search"]
    # a port difference: the port's recorder (no jax.monitoring bus)
    assert out["attribution"] == "obs.compile" != jax_warmup_keys["attribution"]
    assert out["cache_dir"] == str(tmp_path.resolve())
    assert out["build"]["programs"] == out["search"]["programs"] == 0   # no nvcc on the CPU
    assert out["search_s"] >= 0 and out["build"]["program_compile_s"] == []
    assert raft_tpu_torch.warm_buckets is raft_tpu_torch._warmup.warm_buckets


@pytest.mark.parametrize("kwargs,match", [
    (dict(kind="flann"), "unknown index kind"),
    (dict(dtype="float16"), "dtype must be"),
    (dict(data=np.zeros((10, 9), np.float32)), "data sample must be"),
    (dict(dtype="int8", data=np.zeros((10, 8), np.float32)), "dtype"),
    (dict(dtype="uint8", data=np.zeros((10, 8), np.int8)), "must match"),
])
def test_warmup_refusals_match_jax(kwargs, match, monkeypatch):
    """The same checks in the same order, with the same texts; a bad sample
    fails before the build cache moves."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    before = _build.BUILD_DIR
    kw = dict(kind="ivf_flat", n=100, d=8)
    kw.update(kwargs)
    kind = kw.pop("kind")
    with pytest.raises(RaftError, match=match) as te:
        raft_tpu_torch.warmup(kind, cache_dir="/nonexistent/never", res=CPU, **kw)
    with pytest.raises(jerrors.RaftError) as je:
        raft_tpu.warmup(kind, cache_dir="/nonexistent/never", **kw)
    assert str(te.value) == str(je.value)
    assert _build.BUILD_DIR == before


def test_warmup_defaults_per_kind(monkeypatch, tmp_path):
    """The JAX warmup's defaults: IVF-Flat n_lists=1024 / n_probes=8, IVF-PQ
    pq_bits=4, pq_dim=min(64, d), a bfloat16 LUT at exactly the caller's k,
    CAGRA itopk_size=32; byte dtypes inferred from the sample. The builds
    are recorded and then run at a small list count."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    seen = {}

    def spy(mod, small):
        build, search = mod.build, mod.search

        def b(params, x, res=None):
            seen.setdefault(mod.__name__ + ".build", []).append((params, x.dtype,
                                                                 tuple(x.shape)))
            return build(dataclasses.replace(params, **small), x, res=res)

        def s(params, index, q, k, **kw):
            seen.setdefault(mod.__name__ + ".search", []).append((params, k))
            return search(params, index, q, k, **kw)

        s.native = search.native          # the port's own callers (the CAGRA build)
        monkeypatch.setattr(mod, "build", b)
        monkeypatch.setattr(mod, "search", s)

    spy(tfl, dict(n_lists=8))
    spy(tpq, dict(n_lists=8))
    spy(tcagra, dict(graph_degree=16, intermediate_graph_degree=24))
    common = dict(queries=16, cache_dir=str(tmp_path), res=CPU)
    raft_tpu_torch.warmup("ivf_flat", n=400, d=16, k=7, **common)
    raft_tpu_torch.warmup("ivf_pq", n=400, d=16, k=7, **common)
    raft_tpu_torch.warmup("cagra", n=300, d=16, k=7, **common)
    # the first call of each: the CAGRA build runs an IVF-PQ build and
    # searches of its own after them
    fp, _, _ = seen["raft_tpu_torch.neighbors.ivf_flat.build"][0]
    assert fp.n_lists == 1024
    assert seen["raft_tpu_torch.neighbors.ivf_flat.search"][0][0].n_probes == 8
    pp, _, _ = seen["raft_tpu_torch.neighbors.ivf_pq.build"][0]
    assert (pp.n_lists, pp.pq_bits, pp.pq_dim) == (1024, 4, 16)
    sp, k = seen["raft_tpu_torch.neighbors.ivf_pq.search"][0]
    assert (sp.n_probes, sp.lut_dtype, k) == (8, "bfloat16", 7)
    assert seen["raft_tpu_torch.neighbors.cagra.search"][0][0].itopk_size == 32
    u8 = np.random.default_rng(0).integers(0, 256, (50, 16)).astype(np.uint8)
    raft_tpu_torch.warmup("ivf_flat", n=300, d=16, data=u8, **common)
    _, dt, shape = seen["raft_tpu_torch.neighbors.ivf_flat.build"][-1]
    assert dt == torch.uint8 and shape == (300, 16)
