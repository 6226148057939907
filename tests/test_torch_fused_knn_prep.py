"""What surrounds the ``fused_knn`` tensor-core kernel in Python, on the CPU.

The kernel itself runs only on the card (tests/test_torch_gpu.py); here:
the operand preparation (rows padded to 16 bytes, f32x3's bf16 hi/lo
planes) leaves the plain version's results unchanged, the planes equal JAX's
split in ``_scores`` bit for bit, and the tile plan (queries a block by
mode, resident query tile, ring stages, shared-memory bytes) and the split
count come from shapes alone and refuse what does not fit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu_torch.core import RaftError
from raft_tpu_torch.ops import fused_knn as fk
from test_fused_knn import assert_knn_equiv

MODES = ("f32", "f32x3", "bf16", "s8")


def _data(mode, n, m, d, seed):
    rng = np.random.default_rng(seed)
    if mode == "s8":
        x = rng.integers(-128, 128, (n, d), dtype=np.int8)
        q = rng.integers(-128, 128, (m, d), dtype=np.int8)
    else:
        x = rng.random((n, d), np.float32)
        q = rng.random((m, d), np.float32)
    return torch.from_numpy(x), torch.from_numpy(q)


@pytest.mark.parametrize("d", [64, 70, 100])
@pytest.mark.parametrize("mode", MODES)
def test_row_ready_keeps_plain_results(mode, d):
    """Zero columns up to a 16-byte row change no product: the plain
    version over the kernel's padded operands gives the same top-k (s8 bit
    for bit; float modes by assert_knn_equiv at 1e-5, as their sums may
    block differently over the wider rows)."""
    x, q = _data(mode, 700, 33, d, seed=d)
    ds, qs, yn, l2 = fk._prepare(x, q, 10, "l2", mode, None, None)
    xp, qp = fk.row_ready(ds), fk.row_ready(qs)
    per = 16 // ds.element_size()
    assert xp.shape[1] % per == 0 and xp.shape[1] - d < per
    assert torch.equal(xp[:, :d], ds) and not xp[:, d:].any()
    assert xp.data_ptr() % 16 == 0 and qp.data_ptr() % 16 == 0
    if d % per == 0:
        assert xp.data_ptr() == ds.data_ptr()     # no copy when d needs none
    v0, i0 = fk._select_plain(qs, ds, yn, 10, l2, mode)
    v1, i1 = fk._select_plain(qp, xp, yn, 10, l2, mode)
    if mode == "s8":
        assert torch.equal(v0, v1) and torch.equal(i0, i1)
    else:
        assert_knn_equiv(v1.numpy(), i1.numpy(), v0.numpy(), i0.numpy(), rtol=1e-5)


@pytest.mark.parametrize("d", [64, 70, 100])
def test_f32x3_planes_give_the_plain_dots(d):
    """The kernel's four bf16 planes, multiplied as the kernel does
    ((hi·hi + hi·lo) + lo·hi, float32 sums), give _dots' f32x3 numbers."""
    x, q = _data("f32x3", 300, 20, d, seed=d + 1)
    qh, ql, yh, yl = fk._operands(q, x, "f32x3")
    f = [t.to(torch.float32) for t in (qh, ql, yh, yl)]
    dots = (f[0] @ f[2].T + f[0] @ f[3].T) + f[1] @ f[2].T
    torch.testing.assert_close(dots, fk._dots(q, x, "f32x3"), rtol=0, atol=0)


def _near_bf16_boundaries(rng):
    """float32 values whose low 16 bits sit at and around the bf16 rounding
    point (ties to even included), subnormals, ±0, extremes."""
    base = (rng.integers(0x00800000, 0x7F000000, 256, dtype=np.uint32) & 0xFFFF0000)
    lows = np.array([0x0000, 0x0001, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    bits = (base[:, None] | lows[None, :]).ravel()
    sign = rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    special = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
                        0x00008000, 0x00018000, 0x807F8000, 0x7F7FFFFF, 0xFF7FFFFF,
                        0x3F808000, 0x3F818000], np.uint32)
    bits = np.concatenate([bits | sign, special])
    return bits.view(np.float32)


def test_bf16_split_equals_jax_bit_for_bit():
    """On the CPU bf16_split is its plain version (the card's kernel is held
    to it bit for bit in tests/test_torch_gpu.py)."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([_near_bf16_boundaries(rng),
                           rng.standard_normal(4096).astype(np.float32) * 1e3])
    before = fk.bf16_split.launches
    hi, lo = fk.bf16_split(torch.from_numpy(vals))
    assert fk.bf16_split.launches == before
    ph, pl = fk.bf16_split_plain(torch.from_numpy(vals))
    assert torch.equal(hi.view(torch.int16), ph.view(torch.int16))
    assert torch.equal(lo.view(torch.int16), pl.view(torch.int16))
    jv = jnp.asarray(vals)
    jh = jv.astype(jnp.bfloat16)
    jl = (jv - jh.astype(jnp.float32)).astype(jnp.bfloat16)
    for t, j in ((hi, jh), (lo, jl)):
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(j).view(np.int16))


@pytest.mark.parametrize("mode", ["bf16", "s8", "f32x3"])
def test_tile_plan_from_shapes(mode):
    """Every d in the fused gate's range and every k up to 64 gets a plan
    that fits Hopper's 227 KB with a ring of 2 to 8 stages; the main path's
    query tile (d = 128) stays resident, large ones are restaged, and a
    tile resident at some (d, k) is resident at every smaller d and k."""
    qt, nb, planes, elt = fk._TC[mode]
    ds = (64, 70, 96, 100, 128, 200, 256, 512, 1000, 1024, 2048, 4096)
    ks = (1, 10, 32, 64)
    resident = {}
    for d in ds:
        dp = fk.row_ready(torch.zeros((1, d), dtype=fk._IO_TYPE[mode]
                                      if mode != "f32x3" else torch.bfloat16)).shape[1]
        for k in ks:
            p = fk.tile_plan(mode, dp, k)
            assert (p["qt"], p["nb"]) == (qt, nb)
            assert p["smem"] <= fk.SMEM_MAX and 2 <= p["stages"] <= 8
            assert p["kc"] == math.ceil(dp * elt / 128)
            resident[d, k] = p["resident"]
    for i, d in enumerate(ds):
        for j, k in enumerate(ks):
            if resident[d, k]:
                assert all(resident[d2, k2] for d2 in ds[:i + 1] for k2 in ks[:j + 1])
    assert all(resident[128, k] for k in ks)
    assert not any(resident[4096, k] for k in ks)


def test_tile_plan_refuses_what_does_not_fit(monkeypatch):
    """On a card with less shared memory a block (a smaller budget here) the
    plan refuses k = 64's lists rather than launch a layout that does not
    fit; what fits still plans."""
    monkeypatch.setattr(fk, "SMEM_MAX", 160 * 1024)
    with pytest.raises(RaftError, match="no layout"):
        fk.tile_plan("bf16", 128, 64)
    assert fk.tile_plan("bf16", 128, 10)["smem"] <= 160 * 1024
    monkeypatch.setattr(fk, "SMEM_MAX", 64 * 1024)
    with pytest.raises(RaftError, match="no layout"):
        fk.tile_plan("f32x3", 4096, 64)


def _nsplit_before(m, n, qt, slots, nb=128):
    """The split rule before the warm-up term."""
    tiles = -(-n // nb)
    mt = -(-m // qt)
    steps = [(-(-mt * s // slots)) * (-(-tiles // s))
             for s in range(1, max(1, min(tiles // 8, 1024)) + 1)]
    best = min(steps)
    return next(i + 1 for i, t in enumerate(steps) if t <= 1.02 * best)


@pytest.mark.parametrize("m,n", [(10_000, 1_000_000), (2048, 1_000_003), (300, 20_011),
                                 (1, 4099), (65, 9000)])
def test_nsplit_from_shapes(m, n):
    """With no warm-up term the rule is the tile-step rule as before; with
    the tensor-core routes' term, a 10k-query batch over 1M rows takes 3 / 5
    / 3 / 5 splits in bf16 / f32x3 / s8 / tf32x3 (mode f32's batch route)
    at k = 10 on 132 SMs (one wave in bf16 and s8), and every split keeps
    at least 8 tiles."""
    for qt, slots in ((128, 264), (256, 132)):
        assert fk._nsplit(m, n, qt, slots, 128) == _nsplit_before(m, n, qt, slots)
    for mode in ("bf16", "s8", "f32x3", "tf32x3"):
        qt, nb = fk._TC[mode][:2]
        for k in (1, 10, 64):
            s = fk._nsplit(m, n, qt, 132, nb, fk._INSERT_TILES * k)
            tiles = -(-n // nb)
            assert 1 <= s <= max(1, tiles // 8)
            if (m, n) == (10_000, 1_000_000):
                if k == 10:
                    assert s == {"bf16": 3, "f32x3": 5, "s8": 3, "tf32x3": 5}[mode]
                if mode in ("bf16", "s8"):
                    assert -(-m // qt) * s <= 132          # one wave


def test_counters_and_entry_points_exist():
    """The launch counters are plain integers on the wrapper, one per mode;
    the CPU route launches nothing."""
    x, q = _data("bf16", 5000, 4, 64, seed=3)
    before = (fk.fused_knn.launches, dict(fk.fused_knn.launches_by_mode))
    fk.fused_knn(x, q, 5, mode="bf16")
    assert (fk.fused_knn.launches, fk.fused_knn.launches_by_mode) == before
    assert set(fk.fused_knn.launches_by_mode) == set(MODES)
