"""raft_tpu_torch.runtime against raft_tpu.runtime on the CPU, exactly.

The port builds its own copy of the native runtime (g++, into
``build/runtime/``); the JAX package builds ``cpp/libraft_tpu_rt.so``. A
file written by either package reads back in the other and the two files
are byte for byte the same; host refine and the host merge give equal ids
and distances. The numpy route (no compiler) is held to the same answers.
"""

import filecmp

import numpy as np
import pytest

from raft_tpu import runtime as jrt
from raft_tpu.runtime import native as jnative
from raft_tpu_torch import runtime as trt
from raft_tpu_torch.runtime import native as tnative


@pytest.fixture
def rng():
    return np.random.default_rng(9)


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Each test runs on both packages' native libraries and on both numpy
    routes."""
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    elif not trt.available():
        pytest.fail("the port's native runtime did not build (g++ is on this machine)")
    return request.param


@pytest.mark.parametrize("suffix,dtype", [(".fbin", np.float32), (".u8bin", np.uint8),
                                          (".i8bin", np.int8), (".ibin", np.int32)])
def test_files_cross_both_ways_byte_equal(tmp_path, rng, route, suffix, dtype):
    x = (rng.random((37, 9)) * 200 - 60).astype(dtype)
    mine, theirs = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
    trt.write_bin(mine, x)
    jrt.write_bin(theirs, x)
    assert filecmp.cmp(mine, theirs, shallow=False)
    assert trt.bin_info(theirs) == jrt.bin_info(mine) == (37, 9)
    np.testing.assert_array_equal(trt.load_bin(theirs), x)
    np.testing.assert_array_equal(jrt.load_bin(mine), x)
    np.testing.assert_array_equal(trt.read_bin_chunk(theirs, 10, 5), x[10:15])
    np.testing.assert_array_equal(trt.read_bin_chunk(theirs, 35, 10), x[35:])
    assert trt.read_bin_chunk(theirs, 40, 3).shape == (0, 9)


def test_bin_dataset_streams(tmp_path, rng, route):
    x = (rng.random((64, 7)) * 255).astype(np.uint8)
    p = str(tmp_path / "data.u8bin")
    jrt.write_bin(p, x)
    ds = trt.BinDataset(p)
    assert len(ds) == 64 and ds.dim == 7 and ds.dtype == np.uint8
    starts = [s for s, _ in ds.chunks(20)]
    assert starts == [0, 20, 40, 60]
    np.testing.assert_array_equal(np.concatenate([c for _, c in ds.chunks(20)]), x)
    np.testing.assert_array_equal(ds[8:24], x[8:24])
    with pytest.raises(ValueError, match="step 1"):
        ds[0:10:2]
    with pytest.raises(TypeError, match="contiguous slice"):
        ds[3]
    with pytest.raises(ValueError, match="unknown big-ANN binary suffix"):
        trt.write_bin(str(tmp_path / "data.npy"), x)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_refine_host(rng, route, metric):
    n, d, m, k_in, k = 200, 12, 9, 20, 6
    data = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    cand = np.stack([rng.choice(n, k_in, replace=False) for _ in range(m)]).astype(np.int32)
    cand[0, :3] = -1                               # invalid ids sort last at +inf
    cand[1, :] = -1
    cand[1, :2] = [5, 9]
    got = trt.refine_host(data, q, cand, k, metric)
    want = jrt.refine_host(data, q, cand, k, metric)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1][1, 2:] == -1).all() and np.isinf(got[0][1, 2:]).all()
    with pytest.raises(ValueError, match="k=30 > candidate width 20"):
        trt.refine_host(data, q, cand, 30)


@pytest.mark.parametrize("select_min", [True, False])
def test_merge_parts_host(rng, route, select_min):
    parts, m, k = 4, 7, 5
    dists = np.sort(rng.random((parts, m, k)).astype(np.float32), axis=2)
    ids = rng.integers(0, 10_000, (parts, m, k)).astype(np.int32)
    got = trt.merge_parts_host(dists, ids, 6, select_min)
    want = jrt.merge_parts_host(dists, ids, 6, select_min)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_native_library_is_the_ports_own_build(route):
    """The port builds csrc/runtime.cpp into build/runtime/ and counts its
    native calls; the JAX package's cpp/ library is never loaded."""
    before = tnative.native_calls
    if route == "numpy":
        assert not trt.available()
        return
    path = tnative._lib_path()
    assert path.exists() and path.name.startswith("libraft_tpu_torch_rt-")
    assert path.parent.name == "runtime" and path.parent.parent.name == "build"
    assert tnative._lib._name == str(path)
    trt.merge_parts_host(np.zeros((2, 1, 3), np.float32), np.zeros((2, 1, 3), np.int32))
    assert tnative.native_calls == before + 1
