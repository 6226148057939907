"""Mode f32's two routes on the card, from what the CPU can check.

The row-split kernel (m <= M_SMALL) and the 3xTF32 tensor-core kernel (the
batch) run only on the card (tests/test_torch_gpu.py). Here: the dispatch
by m, the row-split route's plan (queries a block, tile rows, ring stages,
shared memory) and its splits and waves from shapes alone, the tf32 split's
bits (its plain twin is the kernel's arithmetic, bit for bit), the 3xTF32
products against float64 within ``tc_rounding_bound``, and the plain
version of mode f32 at the route's query counts against the JAX package's
``fused_knn`` (its Pallas kernel in interpret mode), with the row bias and
the keep mask the row-split route takes as its penalty.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops.fused_knn import fused_knn as jax_fused_knn
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.ops import fused_knn as fk
from test_fused_knn import assert_knn_equiv

SLOTS = 132   # the H100's SMs, one row-split block each


def test_dispatch_by_m():
    """A fixed dispatch by m: the row-split route up to M_SMALL (a value of
    the card's sweep), the batch route beyond."""
    assert fk.M_SMALL in (1, 8, 16, 32, 64, 128, 256, 384, 512)
    assert [fk.f32_route(m) for m in (1, fk.M_SMALL)] == ["rows", "rows"]
    assert [fk.f32_route(m) for m in (fk.M_SMALL + 1, 10_000)] == ["tf32x3"] * 2
    assert set(fk.fused_knn.launches_by_route) == {"rows", "tf32x3"}


@pytest.mark.parametrize("route", ["rows", "tf32x3", "f32x3"])
def test_named_route_runs_only_on_the_card(route):
    """A route is named only through the private ``_fused_knn_f32`` (the
    public ``fused_knn`` takes the dispatch by m), and only on a cuda
    device: CPU tensors and names of no route of mode f32 raise."""
    x = torch.zeros((4096, 8))
    with pytest.raises(RaftError):
        fk._fused_knn_f32(route, x, x[:2], 1)
    assert "route" not in inspect.signature(fk.fused_knn).parameters


@pytest.mark.parametrize("m, mq, rg", [
    (1, 1, 8), (2, 2, 8), (3, 4, 8), (8, 8, 8), (9, 16, 4), (16, 16, 4), (32, 32, 2),
    (33, 64, 1), (64, 64, 1), (128, 64, 1), (256, 64, 1)])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_row_plan_from_shapes(m, mq, rg, k):
    """The least power-of-two query tile up to 64 that holds m (64 beyond:
    the grid walks query tiles), 8 warps as mq / min(mq, 8) query groups x
    rg row groups of 32-row multiples, a stage of nb dataset rows and the
    queries padded to 8 rows (each box on a 1,024-byte boundary), and the
    deepest ring (<= 8 stages) that fits beside the lists in shared
    memory."""
    p = fk.row_plan(m, k)
    nb = 128 if mq == 64 else 256
    assert (p["mq"], p["nb"], p["rg"]) == (mq, nb, rg)
    assert (mq // min(mq, 8)) * rg == 8 and nb % (32 * rg) == 0
    stage = (nb + max(mq, 8)) * 128
    assert stage % 1024 == 0
    lists = 2 * rg * mq * k * 4
    assert p["smem"] == p["stages"] * stage + lists + 16 * p["stages"] + 1024
    assert 2 <= p["stages"] <= 8 and p["smem"] <= fk.SMEM_MAX
    assert p["stages"] == 8 or p["smem"] + stage + 16 > fk.SMEM_MAX


@pytest.mark.parametrize("m", [1, 8, 16, 32, 64, 128, 256, 384, 512])
def test_row_splits_fill_whole_waves(m):
    """At 1M rows every m of the sweep fills the card in one whole wave:
    query tiles x splits = the 132 slots or the most query tiles of them
    allow, each split a run of whole tiles, none empty."""
    p = fk.row_plan(m, 10)
    splits, waves = fk.row_splits(m, 1_000_000, p, SLOTS)
    mt = -(-m // p["mq"])
    assert waves == 1 and splits == SLOTS // mt
    assert mt * splits > SLOTS - mt
    tiles = -(-1_000_000 // p["nb"])
    runs = [(s + 1) * tiles // splits - s * tiles // splits for s in range(splits)]
    assert sum(runs) == tiles and min(runs) >= max(runs) - 1 >= 1


@pytest.mark.parametrize("n", [4096, 20_000, 100_003])
def test_row_splits_of_a_small_set(n):
    """A delta bucket of 4,096 rows has 16 tiles of 256: one split a tile,
    all in one wave; no split is ever empty."""
    p = fk.row_plan(1, 10)
    splits, waves = fk.row_splits(1, n, p, SLOTS)
    tiles = -(-n // p["nb"])
    assert 1 <= splits <= tiles and waves == 1
    if n == 4096:
        assert splits == 16


def test_tf32_split_bits():
    """hi keeps the top 19 bits of x rounded to nearest, ties to even (the
    kernel's tf32_rn, as cvt.rn.tf32.f32), lo = tf32(x - hi) likewise, and
    hi + lo rebuilds x to 2^-22 of |x| in float64."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(50_000) * 10.0 ** rng.integers(-20, 20, 50_000),
                        1.0 + np.arange(1, 16) * 2.0 ** -11,         # ties and near-ties
                        [0.0, -0.0, 1.0, -3.0]]).astype(np.float32)
    hi, lo = fk.tf32_split_plain(torch.from_numpy(x))
    hb = hi.numpy().view(np.uint32)
    lb = lo.numpy().view(np.uint32)
    assert not (hb & 0x1FFF).any() and not (lb & 0x1FFF).any()
    u = x.view(np.uint32).astype(np.uint64)
    want = ((u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000).astype(np.uint32)
    np.testing.assert_array_equal(hb, want)
    # ties go to the even neighbour: 1 + 2^-11 -> 1, 1 + 3·2^-11 -> 1 + 2^-9
    assert hi[50_000].item() == 1.0 and hi[50_002].item() == 1.0 + 2.0 ** -9
    rebuilt = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    err = np.abs(rebuilt - x.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    assert torch.equal(fk.tf32_split(torch.from_numpy(x))[0], hi)   # the CPU route


@pytest.mark.parametrize("d", [64, 256, 1024])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_tf32x3_products_within_the_rounding_bound(d, metric):
    """hi·hi + (hi·lo + lo·hi) over the planes, in float64, lies within
    tc_rounding_bound(mode="tf32x3") of the float64 dot: the split's part
    of the bound holds with room for the sums' rounding on the card."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.random((300, d), np.float32))
    q = torch.from_numpy(rng.random((20, d), np.float32))
    (qh, ql), (xh, xl) = fk.tf32_split_plain(q), fk.tf32_split_plain(x)
    f = [t.double() for t in (qh, ql, xh, xl)]
    dots = f[0] @ f[2].T + (f[0] @ f[3].T + f[1] @ f[2].T)
    exact = q.double() @ x.double().T
    ids = torch.arange(300, dtype=torch.int32).repeat(20, 1)
    bound = fk.tc_rounding_bound(x, q, ids, metric, mode="tf32x3").double()
    c = 2.0 if metric == "l2" else 1.0
    assert (c * (dots - exact).abs() <= bound / 4).all()
    assert (bound <= fk.tc_rounding_bound(x, q, ids, metric, mode="f32x3") * 3).all()


def test_tile_plan_of_the_batch_route():
    """tf32x3's tensor-core plan: 128 queries x 64 rows, float32 planes of
    32 features a chunk; the query tile resident up to d = 128 at k = 10,
    restaged beyond, and every plan within shared memory."""
    for d, resident in ((64, True), (128, True), (256, False), (1024, False)):
        p = fk.tile_plan("tf32x3", d, 10)
        assert (p["qt"], p["nb"], p["kc"], p["resident"]) == (128, 64, -(-d // 32), resident)
        assert p["smem"] <= fk.SMEM_MAX and p["stages"] >= 2
    assert fk.tile_plan("tf32x3", 4096, 64)["resident"] is False


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    n, d = 4096, 64
    x = rng.random((n, d), np.float32)
    q = rng.random((64, d), np.float32)
    bias = rng.random(n).astype(np.float32) * 0.5
    return x, q, bias


def _both(x, q, k, **kw):
    jkw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for key, v in kw.items()}
    jd, ji = jax_fused_knn(jnp.asarray(x), jnp.asarray(q), k, interpret=True, **jkw)
    td, ti = fk.fused_knn(torch.from_numpy(x), torch.from_numpy(q), k, **kw)
    return (td.numpy(), ti.numpy()), (np.asarray(jd), np.asarray(ji))


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_f32_at_the_route_shapes_matches_jax(data, m, metric):
    """n = 4,096, d = 64, with a row bias (the row-split route's penalty
    without a mask)."""
    x, q, bias = data
    (td, ti), (jd, ji) = _both(x, q[:m], 10, metric=metric, row_bias=bias)
    assert_knn_equiv(td, ti, jd, ji, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_f32_underfill_matches_jax(data, m, metric, check_filter_underfill):
    """Five admissible rows for k = 10 under a keep mask and a row bias:
    the same rows first, then -1 at ±inf, as the JAX kernel reports."""
    x, q, bias = data
    keep = np.zeros(x.shape[0], bool)
    alive = [0, 255, 256, 2049, 4095]          # both sides of the 256-row tiles
    keep[alive] = True
    (td, ti), (jd, ji) = _both(x, q[:m], 10, metric=metric, keep_mask=keep, row_bias=bias)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    check_filter_underfill(td, ti, alive, select_min=metric == "l2")


def test_penalty_is_what_the_plain_base_adds(data):
    """The row-split route sums |y|² itself and adds the wrapper's penalty
    (row bias + mask penalty, clamped at 3e38 under a mask): the same yn
    the plain version computes, bit for bit."""
    x, _, bias = data
    xt = torch.from_numpy(x)
    keep = torch.from_numpy(np.arange(x.shape[0]) % 3 != 0)
    b = torch.from_numpy(bias)
    for rb, kp in ((None, None), (b, None), (None, keep), (b, keep)):
        pen, clamp = fk._penalty(rb, kp)
        assert clamp == (kp is not None) and (pen is None) == (rb is None and kp is None)
        yn = xt.square().sum(dim=1)
        got = yn if pen is None else yn + pen
        got = torch.clamp_max(got, 3.0e38) if clamp else got
        assert torch.equal(got, fk._base(xt, True, rb, kp))
