"""The builds' admission against the JAX package's, on the CPU.

A chunked reader handed to a build, and an armed
``Resources.memory_budget_bytes``: the JAX package streams the reader in and
gates every build before it spends anything, and so does the port. Each
build streams a reader to its in-core result; brute force gates its upload
on the same bytes as the JAX build, IVF-Flat, IVF-PQ and CAGRA the index
``obs.mem.plan()`` prices, and each refuses with the JAX build's
``MemoryBudgetError`` numbers. An unarmed budget admits every build.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.core.chunked import ChunkedReader
from raft_tpu.core.resources import Resources as JResources
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf_flat
from raft_tpu.neighbors import ivf_pq as jivf_pq
from raft_tpu.serve.errors import MemoryBudgetError as JMemoryBudgetError
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.serve.errors import MemoryBudgetError

CPU = Resources(device="cpu")


def _x(n, d):
    return np.random.default_rng(0).random((n, d), dtype=np.float32)


def _builds(mod_bf, mod_flat, mod_pq, mod_cagra):
    """Each build of one package as a function of (dataset, res)."""
    return {
        "brute_force": lambda x, res: mod_bf.BruteForce().build(x, res),
        "ivf_flat": lambda x, res: mod_flat.build(mod_flat.IndexParams(n_lists=8), x, res=res),
        "ivf_pq": lambda x, res: mod_pq.build(
            mod_pq.IndexParams(n_lists=8, pq_dim=4, pq_bits=8), x, res=res),
        "cagra": lambda x, res: mod_cagra.build(
            mod_cagra.IndexParams(graph_degree=8, intermediate_graph_degree=16), x, res=res),
    }


PORT = _builds(brute_force, ivf_flat, ivf_pq, cagra)
JAX = _builds(jbf, jivf_flat, jivf_pq, jcagra)


def test_brute_force_build_of_a_chunked_reader():
    """100 x 8 float32, chunk_rows=32: both builds stream the reader in
    whole, to the same dataset."""
    x = _x(100, 8)
    got = jbf.BruteForce().build(ChunkedReader(x, chunk_rows=32), JResources())
    np.testing.assert_array_equal(np.asarray(got.dataset), x)
    index = brute_force.BruteForce().build(ChunkedReader(x, chunk_rows=32), CPU)
    np.testing.assert_array_equal(index.dataset.numpy(), x)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "cagra"])
def test_other_builds_of_a_chunked_reader(kind):
    """300 x 16 float32 in chunks of 64 (the JAX reader, duck-typed): the
    streamed build equals the in-core build of the same rows, every field."""
    x = _x(300, 16)
    streamed = PORT[kind](ChunkedReader(x, chunk_rows=64), CPU)
    incore = PORT[kind](x, CPU)
    for f in dataclasses.fields(incore):
        a, b = getattr(streamed, f.name), getattr(incore, f.name)
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and torch.equal(a, b), f.name


def test_armed_budget_refuses_brute_force_build_as_jax_does():
    """2000 x 16 float32 under a 1,000-byte budget: both builds refuse at
    site "build" needing 128,000 bytes, before the upload."""
    x = _x(2000, 16)
    with pytest.raises(JMemoryBudgetError) as jexc:
        jbf.BruteForce().build(x, JResources(memory_budget_bytes=1000))
    index = brute_force.BruteForce()
    with pytest.raises(MemoryBudgetError) as exc:
        index.build(x, Resources(device="cpu", memory_budget_bytes=1000))
    got, want = exc.value, jexc.value
    assert (got.site, got.need_bytes, got.budget_bytes) == \
        (want.site, want.need_bytes, want.budget_bytes) == ("build", 128_000, 1000)
    assert "needed 128000 B > budget 1000 B (brute_force 2000x16)" in str(got)
    assert "needed 128000 B > budget 1000 B (brute_force 2000x16)" in str(want)
    assert index.dataset is None


@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.float64])
def test_brute_force_budget_prices_the_stored_bytes(dtype):
    """n·d·min(itemsize, 4): float64 is stored as float32, int8 as itself;
    a budget of exactly that many bytes over the ledger's admits."""
    x = (_x(50, 8) * 100).astype(dtype)
    need = 50 * 8 * min(np.dtype(dtype).itemsize, 4)
    outs = []
    for build, res, err in (
            (brute_force.BruteForce().build, Resources(device="cpu", memory_budget_bytes=1),
             MemoryBudgetError),
            (jbf.BruteForce().build, JResources(memory_budget_bytes=1), JMemoryBudgetError)):
        with pytest.raises(err) as exc:
            build(x, res)
        outs.append(exc.value.need_bytes)
    assert outs == [need, need]
    from raft_tpu_torch.obs import mem

    used = mem.totals()["device_bytes"]
    roomy = Resources(device="cpu", memory_budget_bytes=used + need)
    assert brute_force.BruteForce().build(x, roomy).dataset.shape == (50, 8)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "cagra"])
def test_armed_budget_refuses_the_other_builds(kind):
    """The builds price the index by obs.mem.plan() and refuse at site
    "build" with the JAX build's numbers, before they spend anything."""
    x = _x(2000, 16)
    with pytest.raises(JMemoryBudgetError) as jexc:
        JAX[kind](x, JResources(memory_budget_bytes=1000))
    with pytest.raises(MemoryBudgetError) as exc:
        PORT[kind](x, Resources(device="cpu", memory_budget_bytes=1000))
    got, want = exc.value, jexc.value
    assert (got.site, got.need_bytes, got.budget_bytes) == \
        (want.site, want.need_bytes, want.budget_bytes)
    assert got.site == "build" and got.need_bytes > 1000
    assert f"needed {got.need_bytes} B > budget 1000 B ({kind} 2000x16)" in str(got)


def test_armed_budget_without_observability_raises():
    """An armed budget the ledger cannot enforce is a configuration error
    on both sides, not an admission."""
    from raft_tpu.core.errors import RaftError as JRaftError
    from raft_tpu.obs import metrics as jmetrics

    x = _x(64, 8)
    for mod, build, res, err in (
            (metrics, brute_force.BruteForce().build,
             Resources(device="cpu", memory_budget_bytes=1 << 40), RaftError),
            (jmetrics, jbf.BruteForce().build, JResources(memory_budget_bytes=1 << 40),
             JRaftError)):
        mod.disable()
        try:
            with pytest.raises(err, match="observability is disabled"):
                build(x, res)
        finally:
            mod.enable()


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq", "cagra"])
def test_unarmed_budget_admits_every_build(kind):
    PORT[kind](_x(300, 16), CPU)
