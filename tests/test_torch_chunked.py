"""raft_tpu_torch.core.chunked against raft_tpu.core.chunked, on the CPU.

The reader (``.npy`` and raw ``np.memmap`` files, chunks, gathers), the
stager's CPU copy path and its ledger entry, ``take_rows``, ``materialize``,
``converted`` and ``device_materialize`` give the JAX module's rows and
bytes for the same inputs; ``row_tiles`` gives a reader's rows in the tiles
a tensor's rows come in.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core import chunked as jch
from raft_tpu_torch.core import RaftError, Resources, chunked
from raft_tpu_torch.neighbors import _list_utils
from raft_tpu_torch.obs import mem, metrics

CPU = torch.device("cpu")


def _corpus(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "u":
        return rng.integers(0, 256, (n, d), dtype=dtype)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-128, 128, (n, d)).astype(dtype)
    return rng.standard_normal((n, d)).astype(dtype)


def _chunks_total(stage):
    snap = metrics.snapshot().get("raft_tpu_build_ooc_chunks_total")
    if snap is None:
        return 0
    return sum(s["value"] for s in snap["series"] if s["labels"].get("stage") == stage)


@pytest.mark.parametrize("kind", ["npy", "raw"])
def test_reader_from_file_matches_jax(tmp_path, kind):
    x = _corpus(1000, 12, np.float32)
    if kind == "npy":
        path = tmp_path / "c.npy"
        np.save(path, x)
        kw = {}
    else:
        path = tmp_path / "c.f32"
        x.tofile(path)
        kw = dict(dtype=np.float32, shape=(1000, 12))
    t = chunked.ChunkedReader.from_file(path, chunk_rows=300, **kw)
    j = jch.ChunkedReader.from_file(path, chunk_rows=300, **kw)
    assert (t.shape, t.ndim, t.dtype, t.nbytes, len(t), t.n_chunks, t.chunk_rows) == \
        (j.shape, j.ndim, j.dtype, j.nbytes, len(j), j.n_chunks, j.chunk_rows) == \
        ((1000, 12), 2, np.float32, 48_000, 1000, 4, 300)
    got, want = list(t.chunks()), list(j.chunks())
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 300, 600, 900]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    idx = np.array([999, 0, 5, 5, 640])
    np.testing.assert_array_equal(t.take(idx), j.take(idx))
    np.testing.assert_array_equal(t.take(idx), x[idx])
    assert isinstance(t.host_view(), np.memmap)


def test_reader_clamps_and_refuses_as_jax():
    x = _corpus(10, 4, np.float32)
    assert chunked.ChunkedReader(x, chunk_rows=1 << 20).chunk_rows == \
        jch.ChunkedReader(x, chunk_rows=1 << 20).chunk_rows == 10
    for bad in (lambda m: m.ChunkedReader(x[0]), lambda m: m.ChunkedReader(x[:0]),
                lambda m: m.ChunkedReader(x, chunk_rows=0), lambda m: m.ChunkedReader([1, 2]),
                lambda m: m.ChunkedReader.from_file("corpus.raw")):
        with pytest.raises(RaftError):
            bad(chunked)
        with pytest.raises(Exception):
            bad(jch)


def test_is_reader_agrees_and_has_one_definition():
    x = _corpus(20, 4, np.float32)
    for obj in (x, torch.from_numpy(x), jnp.asarray(x), chunked.ChunkedReader(x),
                jch.ChunkedReader(x), chunked.converted(chunked.ChunkedReader(x),
                                                        lambda v: v, CPU)):
        assert chunked.is_reader(obj) == jch.is_reader(obj)
    assert _list_utils.is_reader is chunked.is_reader


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int8, np.float64])
def test_stager_cpu_path_matches_jax(dtype):
    """Each staged chunk is the JAX stager's: the block, a short one
    zero-padded to chunk_rows; float64 rows land as float32. The ledger
    carries two chunks a side under build/staging while the stager lives."""
    x = _corpus(700, 6, dtype)
    t = chunked.ChunkStager(256, 6, dtype, kind="t_stage", device="cpu")
    j = jch.ChunkStager(256, 6, dtype, kind="t_stage")
    try:
        entry = [r for r in mem.breakdown()
                 if r["component"] == "build/staging" and r["name"] == "t_stage"]
        dev_item = min(np.dtype(dtype).itemsize, 4)
        assert [(r["device_bytes"], r["host_bytes"]) for r in entry] == \
            [(2 * 256 * 6 * dev_item, 2 * 256 * 6 * dev_item)]
        assert j.stats()["device_bytes"] == 2 * 256 * 6 * dev_item
        for start in range(0, 700, 256):
            block = x[start:start + 256]
            got = t.stage(block).numpy()
            want = np.asarray(j.stage(block))
            assert got.dtype == want.dtype == chunked.device_dtype(dtype)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got[:block.shape[0]], block.astype(got.dtype))
        st = t.stats()
        assert (st["uploads"], st["staged_bytes"], st["pinned"]) == \
            (3, 3 * 256 * 6 * dev_item, False)
        assert st["uploads"] == j.stats()["uploads"]
    finally:
        t.release()
        j.release()
    assert not [r for r in mem.breakdown() if r["name"] == "t_stage"]


def test_stager_slots_rotate_and_refuse_oversized_blocks():
    """A staged chunk stays valid across the next stage call; the one
    after reuses its slot."""
    x = _corpus(40, 3, np.float32)
    s = chunked.ChunkStager(10, 3, np.float32, device="cpu")
    try:
        a = s.stage(x[0:10])
        b = s.stage(x[10:20])
        np.testing.assert_array_equal(a.numpy(), x[0:10])
        c = s.stage(x[20:30])
        assert c.data_ptr() == a.data_ptr() and b.data_ptr() != a.data_ptr()
        with pytest.raises(RaftError, match="does not fit"):
            s.stage(x[:11])
        with pytest.raises(RaftError, match="does not fit"):
            s.stage(x[:5, :2])
    finally:
        s.release()


def test_take_rows_materialize_converted_match_jax():
    x = _corpus(500, 8, np.uint8)
    t, j = chunked.ChunkedReader(x, chunk_rows=64), jch.ChunkedReader(x, chunk_rows=64)
    idx = np.array([3, 499, 0, 250])
    np.testing.assert_array_equal(chunked.take_rows(t, torch.from_numpy(idx)),
                                  np.asarray(jch.take_rows(j, jnp.asarray(idx))))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(chunked.take_rows(xt, torch.from_numpy(idx)).numpy(),
                                  np.asarray(jch.take_rows(jnp.asarray(x), jnp.asarray(idx))))
    assert chunked.materialize(xt) is xt
    np.testing.assert_array_equal(chunked.materialize(t, device="cpu").numpy(),
                                  np.asarray(jch.materialize(j)))
    # the byte shift + float32 upcast of the byte builds, on both sides
    tc = chunked.converted(t, lambda v: (v.to(torch.int16) - 128).to(torch.float32), "cpu")
    jc = jch.converted(j, lambda v: (v.astype(jnp.int16) - 128).astype(jnp.float32))
    assert chunked.is_reader(tc) and tc.shape == (500, 8) and tc.chunk_rows == 64
    got, want = chunked.take_rows(tc, idx), np.asarray(jch.take_rows(jc, idx))
    assert got.dtype == torch.float32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(chunked.materialize(tc).numpy(), np.asarray(jch.materialize(jc)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64])
def test_device_materialize_matches_jax(dtype):
    x = _corpus(1000, 5, dtype)
    t, j = chunked.ChunkedReader(x, chunk_rows=300), jch.ChunkedReader(x, chunk_rows=300)
    before = _chunks_total("materialize")
    got = chunked.device_materialize(t, kind="t_mat", device="cpu")
    assert _chunks_total("materialize") == before + 4
    want = np.asarray(jch.device_materialize(j))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert not [r for r in mem.breakdown() if r["name"] == "t_mat"]


@pytest.mark.parametrize("n,cr,tile", [(1000, 300, 128), (1000, 256, 64), (1000, 100, 256),
                                       (1000, 1000, 1000), (7, 3, 7), (999, 128, 8),
                                       (1000, 77, 40)])
def test_row_tiles_of_a_reader_are_the_tensors(n, cr, tile):
    """Tiles at global offsets 0, tile, 2·tile, ... whether the rows come
    from one tensor or from staged chunks (a tile straddling chunks is
    assembled); the ingest conversion applies to every row."""
    x = _corpus(n, 4, np.int8)
    xt = torch.from_numpy(x).to(torch.float32)
    want = [(s, t.clone()) for s, t in chunked.row_tiles(xt, tile)]
    stager = chunked.ChunkStager(cr, 4, np.int8, device="cpu")
    try:
        got = [(s, t.clone()) for s, t in chunked.row_tiles(
            chunked.ChunkedReader(x, chunk_rows=cr), tile, stager=stager,
            ingest=lambda v: v.to(torch.float32))]
    finally:
        stager.release()
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(0, n, tile))
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_row_tiles_needs_a_stager_for_a_reader():
    with pytest.raises(RaftError, match="stager"):
        list(chunked.row_tiles(chunked.ChunkedReader(_corpus(10, 2, np.float32)), 4))


def test_stager_defaults_to_the_handles_device():
    from raft_tpu_torch.core import set_default_resources
    from raft_tpu_torch.core.resources import default_resources

    prev = default_resources()
    set_default_resources(Resources(device="cpu"))
    try:
        s = chunked.ChunkStager(4, 2, np.float32)
        assert s.device == CPU
        s.release()
    finally:
        set_default_resources(prev)
