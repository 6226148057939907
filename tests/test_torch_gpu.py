"""raft_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips where there is no CUDA
card (decided in the ``cuda`` fixture, never at import). The file imports
neither JAX nor the JAX package, so on a machine with a card and without JAX
it runs on its own:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.core import Resources
from raft_tpu_torch.matrix import select_k, wide_cols_threshold
from raft_tpu_torch.matrix.select_k import set_wide_cols_threshold
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors.brute_force import BruteForce
from raft_tpu_torch.ops.cagra_hop import cagra_hop, cagra_hop_plain
from raft_tpu_torch.ops.fused_knn import _fused_knn_f32, fused_knn, fused_knn_plain
from raft_tpu_torch.ops.pq_scan import (pack_keep_words, pq_scan, pq_scan_plain,
                                        pq_scan_topk, pq_scan_topk_plain)
from raft_tpu_torch.ops.topk import topk, topk_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5):
    """Distances within tolerance; ids equal except where distances tie
    within it (the kernel and cuBLAS may sum in different orders)."""
    torch.testing.assert_close(dv, rd, rtol=rtol, atol=atol)
    for r in (di != ri).any(dim=1).nonzero().flatten().tolist():
        assert (set(di[r].tolist()) == set(ri[r].tolist())
                or torch.allclose(dv[r].sort().values, rd[r].sort().values,
                                  rtol=rtol, atol=atol)), r


# (d, m, n, k, metric, extra): every d of the sweep, m of 1 / 65 / 300 /
# 1,000, n ragged against every tile (128 rows, 64 in f32x3) and split, k of
# 1 / 10 / 64, l2, ip and sqrt, a keep-mask that keeps 70% or only 5 rows,
# and a dataset whose second half repeats its first (ties to the lower row)
_FUSED_CASES = [
    (64, 1, 4099, 1, "ip", None),
    (70, 300, 20_011, 10, "l2", "keep"),
    (70, 300, 20_011, 1, "l2", "keep"),
    (70, 300, 20_011, 64, "ip", "keep"),
    (100, 65, 9000, 64, "l2", "sqrt"),
    (128, 1000, 30_011, 10, "ip", None),
    (128, 300, 20_011, 10, "l2", "underfill"),
    (128, 65, 12_346, 10, "l2", "ties"),
    (256, 300, 12_345, 64, "ip", None),
    (1024, 65, 5003, 10, "l2", None),
]


def _fused_data(mode, d, m, n, g, dev):
    if mode == "s8":
        x = torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
        q = torch.randint(-128, 128, (m, d), generator=g, device=dev, dtype=torch.int8)
    else:
        x = torch.rand((n, d), generator=g, device=dev)
        q = torch.rand((m, d), generator=g, device=dev)
    return x, q


@pytest.mark.parametrize("mode", ["f32", "f32x3", "bf16", "s8"])
def test_fused_knn_kernel_matches_plain(cuda, mode):
    """Each case launches the mode's kernel once (bf16, f32x3 and s8 the
    tensor-core one; f32 the route its m gives, counted on that route) and
    agrees with the plain version: s8 bit for bit; float modes by
    _knn_equiv at 1e-5, and at d = 1024 the tensor-core routes (mode f32's
    "tf32x3" among them) within tc_rounding_bound (wgmma truncates its
    float32 sums; the error and the row are printed)."""
    from raft_tpu_torch.ops.fused_knn import f32_route, tc_rounding_bound

    g = torch.Generator(device=cuda).manual_seed(0)
    for d, m, n, k, metric, extra in _FUSED_CASES:
        x, q = _fused_data(mode, d, m, n, g, cuda)
        kw = dict(metric=metric, mode=mode)
        if extra == "ties":
            x[n // 2:] = x[:n // 2].clone()
        if extra == "keep":
            kw["keep_mask"] = torch.rand(n, generator=g, device=cuda) < 0.7
        if extra == "underfill":
            keep = torch.zeros(n, dtype=torch.bool, device=cuda)
            keep[torch.randperm(n, generator=g, device=cuda)[:5]] = True
            kw["keep_mask"] = keep
        if extra == "sqrt":
            kw["sqrt"] = True
        route = f32_route(m) if mode == "f32" else None
        before = (fused_knn.launches, dict(fused_knn.launches_by_mode),
                  dict(fused_knn.launches_by_route))
        kd, ki = fused_knn(x, q, k, **kw)
        torch.cuda.synchronize()
        # one launch, of this mode's kernel and no other mode's (mode f32:
        # on its route alone)
        assert (fused_knn.launches, fused_knn.launches_by_mode) == (
            before[0] + 1, dict(before[1], **{mode: before[1][mode] + 1}))
        assert fused_knn.launches_by_route == (
            before[2] if route is None else dict(before[2], **{route: before[2][route] + 1}))
        pd, pi = fused_knn_plain(x, q, k, **kw)
        case = (d, m, n, k, metric, extra)
        tc_kind = mode if mode != "f32" else ("tf32x3" if route == "tf32x3" else None)
        if mode == "s8":
            assert torch.equal(kd, pd) and torch.equal(ki, pi), case
        elif d > 256 and tc_kind is not None:
            bound = tc_rounding_bound(x, q, pi, metric, tc_kind)
            err = (kd - pd).abs()
            row = int(err.max(dim=1).values.argmax())
            print(f"fused_knn {mode} d={d}: max abs err {float(err.max()):.3g} at row {row}, "
                  f"largest err/bound {float((err / bound.clamp_min(1e-30)).max()):.3g}")
            _knn_equiv(kd, ki, pd, pi, rtol=1e-5, atol=float(bound.max()) + 1e-5)
            assert bool((err <= 1e-5 + 1e-5 * pd.abs() + bound).all()), case
        else:
            _knn_equiv(kd, ki, pd, pi)
        if extra == "underfill":
            assert bool((ki[:, 5:] == -1).all()) and bool(torch.isinf(kd[:, 5:]).all())
        if extra == "ties":
            # a repeated row ranks right behind its first copy, never before it
            for r in range(m):
                ids = ki[r].tolist()
                for j, i in enumerate(ids):
                    if i >= n // 2 and i - n // 2 in ids:
                        assert ids.index(i - n // 2) < j, (r, ids)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("route", ["rows", "tf32x3"])
def test_fused_knn_f32_route_matches_plain(cuda, route, d):
    """Mode f32 on one named route at m of 1, 7, 64, 65 and 300 (each route
    takes any m: the row-split route walks query tiles of 64 beyond 64),
    with a row bias, a keep mask that keeps 70% or 5 rows, sqrt and ip,
    against the plain version by _knn_equiv at 1e-5; each call counts one
    launch on that route alone."""
    g = torch.Generator(device=cuda).manual_seed(d)
    n = 20_011
    x, q = _fused_data("f32", d, 300, n, g, cuda)
    bias = torch.rand(n, generator=g, device=cuda) * 0.5
    few = torch.zeros(n, dtype=torch.bool, device=cuda)
    few[torch.randperm(n, generator=g, device=cuda)[:5]] = True
    kws = [dict(metric="l2", k=10), dict(metric="ip", k=64, row_bias=bias),
           dict(metric="l2", k=1, sqrt=True,
                keep_mask=torch.rand(n, generator=g, device=cuda) < 0.7),
           dict(metric="l2", k=10, keep_mask=few, row_bias=bias)]
    for m in (1, 7, 64, 65, 300):
        for kw in kws:
            kw = dict(kw)
            k = kw.pop("k")
            before = dict(fused_knn.launches_by_route)
            kd, ki = _fused_knn_f32(route, x, q[:m], k, **kw)
            torch.cuda.synchronize()
            assert fused_knn.launches_by_route == dict(before, **{route: before[route] + 1})
            pd, pi = fused_knn_plain(x, q[:m], k, **kw)
            _knn_equiv(kd, ki, pd, pi)
            if kw.get("keep_mask") is few:
                assert bool((ki[:, 5:] == -1).all()) and bool(torch.isinf(kd[:, 5:]).all())


def test_fused_knn_f32_dispatch_by_m(cuda):
    """Through ``fused_knn``, mode f32 takes the row-split route up to M_SMALL
    queries and the batch route beyond: one launch a call, on that route."""
    from raft_tpu_torch.ops import fused_knn as fk

    g = torch.Generator(device=cuda).manual_seed(9)
    x, q = _fused_data("f32", 128, 300, 50_000, g, cuda)
    for m, route in ((1, "rows"), (fk.M_SMALL, "rows"), (fk.M_SMALL + 1, "tf32x3"),
                     (300, "tf32x3")):
        before = dict(fused_knn.launches_by_route)
        fused_knn(x, q[:m], 10)
        torch.cuda.synchronize()
        assert fused_knn.launches_by_route == dict(before, **{route: before[route] + 1}), m


def test_tf32_split_kernel_bit_equal_to_plain(cuda):
    """Mode f32's 3xTF32 planes: the kernel against tf32_split_plain on the
    card, value bits compared, over values at and around the tf32 rounding
    point (ties to even), subnormals, ±0, ±inf and a length that is not a
    multiple of four."""
    from raft_tpu_torch.ops.fused_knn import tf32_split, tf32_split_plain

    rng = np.random.default_rng(12)
    base = rng.integers(0x00800000, 0x7F000000, 512, dtype=np.uint32) & 0xFFFFE000
    lows = np.array([0, 1, 0xFFF, 0x1000, 0x1001, 0x1FFF], np.uint32)
    bits = (base[:, None] | lows[None, :]).ravel()
    bits |= rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    special = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x00001000, 0x00003000,
                        0x7F7FDFFF, 0x7F800000, 0xFF800000, 0x3F801000, 0x3F803000], np.uint32)
    vals = np.concatenate([bits, special, rng.standard_normal(1001).astype(np.float32)
                           .view(np.uint32)]).view(np.float32)
    x = torch.from_numpy(vals).to(cuda)
    for t in (x, x[:-1], x.reshape(-1, 1)[3:].flatten()):
        before = tf32_split.launches
        hi, lo = tf32_split(t)
        torch.cuda.synchronize()
        assert tf32_split.launches == before + 1
        ph, pl = tf32_split_plain(t)
        assert torch.equal(hi.view(torch.int32), ph.view(torch.int32))
        assert torch.equal(lo.view(torch.int32), pl.view(torch.int32))


def test_bf16_split_kernel_bit_equal_to_plain(cuda):
    """f32x3's operand planes: the kernel against bf16_split_plain on the
    card, value bits compared, over values at and around the bf16 rounding
    point, subnormals, ±0, ±inf, NaN and a length that is not a multiple of
    four."""
    from raft_tpu_torch.ops.fused_knn import bf16_split, bf16_split_plain

    rng = np.random.default_rng(11)
    base = rng.integers(0x00800000, 0x7F000000, 512, dtype=np.uint32) & 0xFFFF0000
    lows = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    bits = (base[:, None] | lows[None, :]).ravel()
    bits |= rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    special = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x00008000, 0x00018000,
                        0x807F8000, 0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000,
                        0x3F808000, 0x3F818000], np.uint32)
    vals = np.concatenate([bits, special, rng.standard_normal(1001).astype(np.float32)
                           .view(np.uint32)]).view(np.float32)
    x = torch.from_numpy(vals).to(cuda)
    for t in (x, x[:-1], x.reshape(-1, 1)[3:].flatten()):
        before = bf16_split.launches
        hi, lo = bf16_split(t)
        torch.cuda.synchronize()
        assert bf16_split.launches == before + 1
        ph, pl = bf16_split_plain(t)
        assert torch.equal(hi.view(torch.int16), ph.view(torch.int16))
        assert torch.equal(lo.view(torch.int16), pl.view(torch.int16))


def test_fused_knn_uint8_inner_product_through_knn(cuda):
    """Shifted uint8 inner products (the s8 kernel with a row bias) through
    the public entry point, bit for bit against the same call on the CPU."""
    from raft_tpu_torch.neighbors.brute_force import knn

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (20_011, 96), dtype=np.uint8)
    q = rng.integers(0, 256, (300, 96), dtype=np.uint8)
    for metric in ("inner_product", "sqeuclidean"):
        before = dict(fused_knn.launches_by_mode)
        kd, ki = knn(x, q, 10, metric=metric, res=Resources(device="cuda"))
        torch.cuda.synchronize()
        assert fused_knn.launches_by_mode == dict(before, s8=before["s8"] + 1)
        cd, ci = knn(x, q, 10, metric=metric, res=Resources(device="cpu"))
        assert torch.equal(kd.cpu(), cd) and torch.equal(ki.cpu(), ci), metric


def _topk_rows(rng, rows, n):
    """Rows with ties, ±inf, clamped extremes, -0 and NaN of both signs,
    one all NaN and one sorted (each later entry better for select_min)."""
    x = rng.random((rows, n)).astype(np.float32)
    nan = np.float32(np.nan)
    specials = [("ties", 0.25), ("ints", None), ("inf", np.inf), ("-inf", -np.inf),
                ("-0", -0.0), ("nan", nan), ("-nan", -nan), ("big", 3.1e38)]
    for r in range(rows):
        name, val = specials[r % len(specials)]
        if name == "ints":
            x[r] = rng.integers(0, 12, n)
        else:
            x[r, rng.integers(0, n, max(1, n // 5))] = val
    if rows > 2:
        x[-1] = nan
        x[-2] = np.sort(x[-2])[::-1]
    return x


@pytest.mark.parametrize("k", [1, 10, 40, 64, 100, 193, 256])
def test_topk_kernel_matches_plain(cuda, k):
    """Bit for bit (ids and value bits) at the index paths' widths, around
    the first in-row reduce of the candidate buffer (2,304 entries kept
    before it) and past 65,536 columns; float32, bfloat16 and float16; one
    row and 128 rows (fewer blocks than SMs)."""
    rng = np.random.default_rng(k)
    for n in (1_024, 2_304, 2_305, 10_176, 16_384, 70_001):
        for rows in (1, 128):
            x = torch.from_numpy(_topk_rows(rng, rows, n)).to(cuda)
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                xd = x.to(dtype)
                as_int = torch.int32 if dtype == torch.float32 else torch.int16
                for select_min in (True, False):
                    before = topk.launches
                    kv, ki = topk(xd, k, select_min=select_min)
                    torch.cuda.synchronize()
                    assert topk.launches == before + 1
                    pv, pi = topk_plain(xd, k, select_min=select_min)
                    assert torch.equal(ki, pi), (n, rows, dtype, select_min)
                    assert torch.equal(kv.view(as_int), pv.view(as_int)), (n, rows, dtype)


@pytest.mark.parametrize("payload", [torch.int32, torch.int64])
def test_topk_kernel_payload_ids_and_unaligned_rows(cuda, payload):
    """One launch writes the payload's ids; rows that start off a 16-byte
    boundary (n odd) take the kernel's head and tail entries."""
    rng = np.random.default_rng(3)
    for n, dtype in ((4_099, torch.float32), (10_177, torch.bfloat16), (333, torch.float16)):
        x = torch.from_numpy(_topk_rows(rng, 37, n)).to(cuda).to(dtype)
        ids = torch.randint(0, 1 << 30, (37, n), device=cuda).to(payload)
        for k in (7, 40):
            kv, ki = topk(x, k, select_min=True, in_idx=ids)
            torch.cuda.synchronize()
            pv, pi = topk_plain(x, k, select_min=True)
            assert torch.equal(ki, torch.gather(ids, 1, pi.long()).to(torch.int32))
            as_int = torch.int32 if dtype == torch.float32 else torch.int16
            assert torch.equal(kv.view(as_int), pv.view(as_int))


def test_select_k_nan_row_same_on_card_and_cpu(cuda):
    """A select_k of a row with NaN, routed to the kernel on the card, gives
    the CPU's ids (and lax.top_k's: tests/test_torch_topk.py)."""
    x = np.full((1, max(5, wide_cols_threshold())), 0.25, np.float32)
    x[0, :5] = [1, np.nan, 0.5, -np.inf, 2]
    cpu = select_k(x, 3, select_min=False, res=Resources(device="cpu"))
    before = topk.launches
    card = select_k(x, 3, select_min=False, res=Resources(device="cuda"))
    assert topk.launches == before + 1
    assert card[1].cpu().tolist() == cpu[1].tolist() == [[1, 4, 0]]


def test_search_and_select_k_launch_kernels(cuda):
    res = Resources(device="cuda")
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand((8192, 64), generator=g, device=cuda)
    q = torch.rand((100, 64), generator=g, device=cuda)
    before = fused_knn.launches
    d, i = BruteForce().build(x, res=res).search(q, 10)
    assert fused_knn.launches == before + 1
    rd, ri = fused_knn_plain(x, q, 10)
    _knn_equiv(d, i, rd, ri)
    v = torch.rand((16, wide_cols_threshold()), generator=g, device=cuda)
    before = topk.launches
    sv, si = select_k(v, 5, res=res)
    assert topk.launches == before + 1
    ref = torch.sort(v, dim=1, stable=True)
    assert torch.equal(sv, ref.values[:, :5]) and torch.equal(si.long(), ref.indices[:, :5])


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pq_scan_kernel_bit_equal_to_plain(cuda, split, dtype):
    """S=24 takes the byte loads, S=64 the 16-byte loads; pairs repeat lists."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for s in (24, 64):
        codes = torch.randint(0, 256 if split else 16, (50, 333, s), generator=g,
                              device=cuda, dtype=torch.uint8)
        probes = torch.randint(0, 6, (700,), generator=g, device=cuda, dtype=torch.int32)
        lut = (torch.randn((700, s, 32 if split else 16), generator=g, device=cuda)
               * 30).to(dtype)
        before = pq_scan.launches
        got = pq_scan(codes, probes, lut, split=split)
        torch.cuda.synchronize()
        assert pq_scan.launches == before + 1
        assert torch.equal(got, pq_scan_plain(codes, probes, lut, split=split))


def pq_topk_inputs(s, split, pc, lut_dtype=torch.float32, inner=False, t=5, n_lists=9,
                cap=300, seed=0):
    """Seeded inputs of ``pq_scan_topk`` with what the kernel must get right
    planted: query 0 has an integer LUT (scores tie everywhere); query 1
    probes two lists holding the same code row, with equal LUTs and biases
    (ties across probes and, through a repeated row, within a list); list 1
    has holes, list 4 is empty, every list ends in unfilled slots; query 2
    probes only list 4 but for one probe of list 5, which holds 3 rows (fewer
    than k)."""
    rng = np.random.default_rng(seed)
    kk = 32 if split else 16
    codes = rng.integers(0, 256 if split else 16, (n_lists, cap, s), dtype=np.uint8)
    codes[2, 9] = codes[2, 5]
    codes[3, 0] = codes[2, 5]
    ids = rng.permutation(n_lists * cap).reshape(n_lists, cap).astype(np.int32)
    ids[:, cap - 7:] = -1
    ids[1, ::4] = -1
    ids[4] = -1
    ids[5, 3:] = -1
    probes = rng.integers(0, n_lists, (t, pc)).astype(np.int32)
    lut = (rng.normal(size=(t, pc, s, kk)) * 10).astype(np.float32)
    lut[0] = rng.integers(-3, 4, (pc, s, kk))
    bias = (rng.normal(size=(t, pc)) * 10).astype(np.float32)
    probes[1, 0] = 2
    if pc > 1:
        probes[1, 1] = 3
        lut[1, 1] = lut[1, 0]
        bias[1, 1] = bias[1, 0]
    probes[2] = 4
    probes[2, -1] = 5
    consts = None
    if split and not inner:
        consts = (rng.normal(size=(n_lists, cap)) * 5).astype(np.float32)
        consts[2, 9] = consts[3, 0] = consts[2, 5]
    tl = torch.from_numpy(lut).to(lut_dtype)
    return (torch.from_numpy(codes), torch.from_numpy(ids), torch.from_numpy(probes), tl,
            torch.from_numpy(bias), None if consts is None else torch.from_numpy(consts))


@pytest.mark.parametrize("k", [1, 7, 40, 256])
@pytest.mark.parametrize("pc", [1, 3, 8])
@pytest.mark.parametrize("split,dtype,inner", [
    (False, torch.float32, False), (False, torch.bfloat16, True),
    (True, torch.float32, False), (True, torch.bfloat16, False), (True, torch.float32, True),
])
def test_pq_scan_topk_kernel_bit_equal_to_plain(cuda, k, pc, split, dtype, inner):
    """The CPU tests' grid (ties, holes, underfill), at S=16 and 24 (codes
    staged, and read byte by byte) and at S=64: values' bits and ids."""
    for s in (16, 24, 64):
        args = [None if a is None else a.to(cuda)
                for a in pq_topk_inputs(s, split, pc, dtype, inner, seed=k + pc + s)]
        before = pq_scan_topk.launches
        v, i = pq_scan_topk(*args[:5], k, not inner, split=split, list_consts=args[5])
        torch.cuda.synchronize()
        assert pq_scan_topk.launches == before + 1
        pv, pi = pq_scan_topk_plain(*args[:5], k, not inner, split, args[5])
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)


def test_pq_scan_topk_kernel_main_shape(cuda):
    """128 queries x 8 probes of a 1,024-list index, cap 1,272, S=64, bf16
    LUT, k=40, lists probed by several queries, holes and short lists."""
    g = torch.Generator(device=cuda).manual_seed(9)
    n_lists, cap, s, t, pc = 1024, 1272, 64, 128, 8
    codes = torch.randint(0, 16, (n_lists, cap, s), generator=g, device=cuda,
                          dtype=torch.uint8)
    ids = torch.randperm(n_lists * cap, generator=g, device=cuda).to(torch.int32)
    size = 1000 + torch.arange(n_lists, device=cuda)[:, None] % 273     # short lists
    ids = torch.where(torch.arange(cap, device=cuda)[None, :] < size, ids.reshape(n_lists, cap), -1)
    ids[::7, ::5] = -1                                                    # holes
    probes = torch.randint(0, 300, (t, pc), generator=g, device=cuda, dtype=torch.int32)
    lut = (torch.randn((t, pc, s, 16), generator=g, device=cuda) * 20).to(torch.bfloat16)
    bias = torch.randn((t, pc), generator=g, device=cuda) * 100
    before = pq_scan_topk.launches
    v, i = pq_scan_topk(codes, ids, probes, lut, bias, 40, True)
    torch.cuda.synchronize()
    assert pq_scan_topk.launches == before + 1
    pv, pi = pq_scan_topk_plain(codes, ids, probes, lut, bias, 40, True)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)


@pytest.mark.parametrize("keep", [0.5, 0.02, 0.0])
@pytest.mark.parametrize("split,dtype,inner", [
    (False, torch.float32, False), (False, torch.bfloat16, True), (True, torch.float32, False),
])
def test_pq_scan_topk_kernel_filtered_bit_equal_to_plain(cuda, keep, split, dtype, inner):
    """A packed keep bitset: the grid's inputs with 50%, 2% and none of the
    ids kept (underfill), k in {1, 40, 256}: values' bits and ids."""
    for s, pc, k in ((16, 3, 40), (24, 8, 256), (64, 1, 1)):
        args = [None if a is None else a.to(cuda)
                for a in pq_topk_inputs(s, split, pc, dtype, inner, seed=s + pc)]
        g = torch.Generator(device=cuda).manual_seed(s)
        mask = torch.rand(args[1].numel(), generator=g, device=cuda) < keep
        words = pack_keep_words(mask)
        before = pq_scan_topk.launches
        v, i = pq_scan_topk(*args[:5], k, not inner, split=split, list_consts=args[5],
                            keep_words=words)
        torch.cuda.synchronize()
        assert pq_scan_topk.launches == before + 1
        pv, pi = pq_scan_topk_plain(*args[:5], k, not inner, split, args[5], words)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
        kept = torch.isfinite(v)
        assert bool(mask[i[kept].long()].all())


def test_pq_scan_topk_kernel_short_bitset_keeps_no_id_past_it(cuda):
    """A bitset shorter than the stored ids: ids past its last word score
    ±inf as filtered ones, on the kernel as on the plain version."""
    for split, dtype, inner in ((False, torch.float32, False), (True, torch.bfloat16, True)):
        args = [None if a is None else a.to(cuda)
                for a in pq_topk_inputs(24, split, 8, dtype, inner, seed=5)]
        words = pack_keep_words(torch.ones(args[1].numel() // 2, dtype=torch.bool,
                                           device=cuda))
        v, i = pq_scan_topk(*args[:5], 40, not inner, split=split, list_consts=args[5],
                            keep_words=words)
        pv, pi = pq_scan_topk_plain(*args[:5], 40, not inner, split, args[5], words)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
        assert bool((i[torch.isfinite(v)] < words.numel() * 32).all())


def test_ivf_pq_filtered_search_on_card_equals_cpu(cuda, tmp_path):
    """A filtered search on the card runs pq_scan_topk (and no topk) where
    the unfiltered one does, and answers as the CPU's plain versions."""
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(60, 32)) * 3.0
    x = (centers[rng.integers(0, 60, 40_000)] + rng.normal(size=(40_000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 60, 200)] + rng.normal(size=(200, 32))).astype(np.float32)
    cpu = Resources(device="cpu")
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=64, pq_dim=16), x, res=cpu)
    path = str(tmp_path / "index.bin")
    ivf_pq.save(index, path)
    card = ivf_pq.load(path, res=Resources(device="cuda"))
    for frac in (0.5, 0.02):
        keep = rng.random(40_000) < frac
        for select in ("pallas", "xla"):
            params = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16", select_impl=select)
            counts = pq_scan_topk.launches, topk.launches
            d, i = ivf_pq.search(params, card, q, 20, sample_filter=keep)
            torch.cuda.synchronize()
            if select == "pallas":
                assert pq_scan_topk.launches > counts[0]
            rd, ri = ivf_pq.search(params, index, q, 20, sample_filter=keep, res=cpu)
            _knn_equiv(d.cpu(), i.cpu(), rd, ri, rtol=1e-5, atol=1e-4)
            ic = i.cpu().numpy()
            assert keep[ic[ic >= 0]].all()


@pytest.mark.parametrize("bits", [4, 8])
def test_ivf_pq_search_on_card_equals_cpu(cuda, tmp_path, bits):
    """An index built on the CPU, loaded onto the card: the card's search
    (through the fused pq_scan_topk kernel where the chunk's select would go
    to the topk kernel, through pq_scan otherwise) answers as the CPU's (the
    plain versions)."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(60, 32)) * 3.0
    x = (centers[rng.integers(0, 60, 4000)] + rng.normal(size=(4000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 60, 50)] + rng.normal(size=(50, 32))).astype(np.float32)
    cpu = Resources(device="cpu")
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=32, pq_bits=bits,
                                            pq_dim=16 if bits == 4 else 8), x, res=cpu)
    path = str(tmp_path / "index.bin")
    ivf_pq.save(index, path)
    card = ivf_pq.load(path, res=Resources(device="cuda"))
    for select in ("auto", "pallas"):
        params = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16", select_impl=select)
        fused = select == "pallas" or ivf_pq._fuses_scan_and_select(
            card, "kernel", "auto", 8, 20, "bfloat16")
        counter = pq_scan_topk if fused else pq_scan
        before = counter.launches
        d, i = ivf_pq.search(params, card, q, 20)
        torch.cuda.synchronize()
        assert counter.launches > before
        rd, ri = ivf_pq.search(params, index, q, 20, res=cpu)
        _knn_equiv(d.cpu(), i.cpu(), rd, ri, rtol=1e-5, atol=1e-4)


def _ivf_flat_inputs(list_dtype):
    rng = np.random.default_rng(6)
    centers = rng.normal(size=(40, 32)) * 3.0
    x = (centers[rng.integers(0, 40, 20_000)] + rng.normal(size=(20_000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 40, 300)] + rng.normal(size=(300, 32))).astype(np.float32)
    if list_dtype == "int8":
        x, q = (np.clip(np.round(a * 8), -128, 127).astype(np.int8) for a in (x, q))
    return x, q


@pytest.mark.parametrize("list_dtype", ["float32", "bfloat16", "int8"])
def test_ivf_flat_search_on_card_equals_cpu(cuda, tmp_path, list_dtype):
    """An index built on the CPU, loaded onto the card: the card's search
    (chunk selects of 4 probes x ~1,300 slots through the topk kernel)
    answers as the CPU's (the plain top-k), with and without a filter."""
    x, q = _ivf_flat_inputs(list_dtype)
    cpu = Resources(device="cpu")
    ld = "auto" if list_dtype == "int8" else list_dtype
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=20, list_dtype=ld), x, res=cpu)
    path = str(tmp_path / "index.bin")
    ivf_flat.save(index, path)
    card = ivf_flat.load(path, res=Resources(device="cuda"))
    keep = np.random.default_rng(1).random(20_000) < 0.5
    for flt in (None, keep):
        before = topk.launches
        d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=4), card, q, 10,
                               sample_filter=flt)
        torch.cuda.synchronize()
        assert topk.launches > before
        rd, ri = ivf_flat.search(ivf_flat.SearchParams(n_probes=4), index, q, 10,
                                 sample_filter=flt, res=cpu)
        if list_dtype == "int8":
            assert torch.equal(i.cpu(), ri) and torch.equal(d.cpu(), rd)
        else:
            _knn_equiv(d.cpu(), i.cpu(), rd, ri, rtol=1e-5, atol=1e-4)


def test_ivf_flat_select_routes_equal_on_card(cuda):
    """The topk kernel route and the plain top-k route (the wide-select
    threshold pinned above every row) give equal ids and values."""
    x, q = _ivf_flat_inputs("float32")
    card = ivf_flat.build(ivf_flat.IndexParams(n_lists=20), x, res=Resources(device="cuda"))
    sp = ivf_flat.SearchParams(n_probes=4)
    d, i = ivf_flat.search(sp, card, q, 10)
    set_wide_cols_threshold(1 << 30)
    try:
        before = topk.launches
        pd, pi = ivf_flat.search(sp, card, q, 10)
        torch.cuda.synchronize()
        assert topk.launches == before
    finally:
        set_wide_cols_threshold(None)
    assert torch.equal(i, pi) and torch.equal(d, pd)


def _hop_inputs(cuda, rows, d, itopk, width, seed):
    """A beam of random ids at their true distances, sorted by a plain prime
    call, and a hop's candidates: a beam id, a repeat, a -1, invalid lanes."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    m, n, cw = 300, 5000, 32 * width
    if rows == "int8":
        data = torch.randint(-128, 128, (n, d), generator=g, device=cuda, dtype=torch.int8)
        q = torch.rand((m, d), generator=g, device=cuda) * 200.0 - 100.0
    else:
        data = torch.rand((n, d), generator=g, device=cuda)
        q = torch.rand((m, d), generator=g, device=cuda)
    ids = torch.randint(0, n, (m, itopk), generator=g, device=cuda, dtype=torch.int32)
    bd = torch.full((m, 128), float("inf"), device=cuda)
    bi = torch.full((m, 128), -1, dtype=torch.int32, device=cuda)
    bv = torch.ones((m, 128), dtype=torch.int32, device=cuda)
    bd[:, :itopk] = ((data[ids.long()].float() - q[:, None]) ** 2).sum(-1)
    bi[:, :itopk], bv[:, :itopk] = ids, 0
    none = torch.full((m, cw), -1, dtype=torch.int32, device=cuda)
    zero = torch.zeros((m, cw), dtype=torch.int32, device=cuda)
    bd, bi, bv = cagra_hop_plain(q, bd, bi, bv, none, data, zero, itopk, width)[:3]
    nbrs = torch.randint(0, n, (m, cw), generator=g, device=cuda, dtype=torch.int32)
    nbrs[::2, 0] = bi[::2, 1]
    nbrs[::3, 1] = nbrs[::3, 2]
    nbrs[::4, 3] = -1
    valid = (torch.rand((m, cw), generator=g, device=cuda) > 0.1).to(torch.int32)
    return q, bd, bi, bv, nbrs, data, valid


@pytest.mark.parametrize("merge", ["extract", "arena"])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("rows,d", [("f32", 128), ("f32", 70), ("int8", 128)])
def test_cagra_hop_kernel_bit_equal_to_plain(cuda, merge, width, rows, d):
    """d=70 takes the kernel's scalar loads; every output is bit-equal."""
    args = _hop_inputs(cuda, rows, d, 32, width, seed=width * 7 + d)
    before = cagra_hop.launches
    got = cagra_hop(*args, 32, width, merge=merge)
    torch.cuda.synchronize()
    assert cagra_hop.launches == before + 1
    for a, b in zip(got, cagra_hop_plain(*args, 32, width, merge=merge)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("profile", ["noscore", "nodedup", "nomerge", "nogate"])
@pytest.mark.parametrize("merge", ["extract", "arena"])
@pytest.mark.parametrize("rows,d", [("f32", 128), ("int8", 70)])
def test_cagra_hop_carve_outs_bit_equal_to_plain(cuda, profile, merge, rows, d):
    """Each profile carve-out against its plain version, one launch counted
    under its own mode; "nogate" also equals "full"."""
    args = _hop_inputs(cuda, rows, d, 32, 2, seed=31 + d)
    before = dict(cagra_hop.launches_by_mode)
    got = cagra_hop(*args, 32, 2, merge=merge, profile=profile)
    torch.cuda.synchronize()
    assert cagra_hop.launches_by_mode[profile] == before[profile] + 1
    for a, b in zip(got, cagra_hop_plain(*args, 32, 2, merge=merge, profile=profile)):
        assert torch.equal(a, b)
    if profile == "nogate":
        for a, b in zip(got, cagra_hop(*args, 32, 2, merge=merge)):
            assert torch.equal(a, b)


def test_cagra_byte_build_searches_int8_rows_on_card(cuda):
    """A uint8 dataset built on the card is held as int8 rows; the card's
    fused search runs cagra_hop over them and answers as the CPU's search
    of the same index."""
    rng = np.random.default_rng(6)
    x = np.round(rng.random((3000, 24)) * 255).astype(np.uint8)
    q = np.round(rng.random((40, 24)) * 255).astype(np.uint8)
    params = cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16)
    card = cagra.build(params, x, res=Resources(device="cuda"))
    assert card.dataset.dtype == torch.int8 and card.data_kind == "uint8"
    index = cagra.CagraIndex(dataset=card.dataset.cpu(), graph=card.graph.cpu(),
                             metric=card.metric, data_kind="uint8")
    ids = torch.from_numpy(rng.permutation(3000)[:64])
    qs = torch.from_numpy(q.astype(np.float32) - 128.0)
    before = cagra_hop.launches
    d, i = cagra._cagra_search(card, qs.to(cuda), 10, 32, 42, 1, False, seed_pool=64,
                               hop_impl="fused_arena", pool_ids=ids)
    torch.cuda.synchronize()
    assert cagra_hop.launches > before
    rd, ri = cagra._cagra_search(index, qs, 10, 32, 42, 1, False, seed_pool=64,
                                 hop_impl="fused_arena", pool_ids=ids)
    _knn_equiv(d.cpu(), i.cpu(), rd, ri, rtol=1e-5, atol=1e-5)


def test_cagra_search_on_card_equals_cpu(cuda, tmp_path):
    """An index built on the CPU, loaded onto the card: the card's fused
    search (through the cagra_hop kernel) answers as the CPU's."""
    rng = np.random.default_rng(4)
    x = rng.random((3000, 24)).astype(np.float32)
    q = rng.random((40, 24)).astype(np.float32)
    cpu = Resources(device="cpu")
    index = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16),
                        x, res=cpu)
    path = str(tmp_path / "cagra.bin")
    cagra.save(index, path)
    card = cagra.load(path, res=Resources(device="cuda"))
    ids = torch.from_numpy(np.random.default_rng(5).permutation(3000)[:64])
    before = cagra_hop.launches
    d, i = cagra._cagra_search(card, torch.from_numpy(q).to(cuda), 10, 32, 42, 1, False,
                               seed_pool=64, hop_impl="fused_arena", pool_ids=ids)
    torch.cuda.synchronize()
    assert cagra_hop.launches > before
    rd, ri = cagra._cagra_search(index, torch.from_numpy(q), 10, 32, 42, 1, False,
                                 seed_pool=64, hop_impl="fused_arena", pool_ids=ids)
    _knn_equiv(d.cpu(), i.cpu(), rd, ri, rtol=1e-5, atol=1e-5)


def test_pipelined_service_on_card_equals_direct_search(cuda):
    """The pipelined serve path on the card: full 64-row buckets submitted
    back to back through pinned staging buffers and device slots (the
    rotation rewrites each buffer several times) answer as direct searches
    of the same blocks; the slots are reused and no kernel is built."""
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService

    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.rand((50_000, 128), generator=g, device=cuda)
    q = torch.rand((20 * 64, 128), generator=g, device=cuda).cpu().numpy()
    index = BruteForce("sqeuclidean").build(x, res=Resources(device="cuda"))
    svc = SearchService(max_batch=64, max_wait_us=2000, pipeline_depth=2)
    try:
        svc.publish("bf", index, k=10)
        with obs_compile.attribution() as rec:
            futs = [svc.submit("bf", q[b * 64:(b + 1) * 64], 10) for b in range(20)]
            got = [f.result(timeout=60) for f in futs]
        stats = svc.staging_stats()["bf.k10"]
    finally:
        svc.shutdown()
    assert rec.programs == 0 and rec.cache_hits == 0
    assert stats["pinned"] and stats["slot_reuses"] >= 1
    for b, (d, i) in enumerate(got):
        rd, ri = index.search(q[b * 64:(b + 1) * 64], 10)
        _knn_equiv(torch.from_numpy(d), torch.from_numpy(i), rd.cpu(), ri.cpu())


def test_cagra_batched_searcher_serves_on_card(cuda):
    """CAGRA's serving hook answers as ``search`` with the same params on
    the card, at the serve ladder's smallest and largest buckets."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.rand((20_000, 64), generator=g, device=cuda)
    index = cagra.build(cagra.IndexParams(graph_degree=32, intermediate_graph_degree=64),
                        x, res=Resources(device="cuda"))
    sp = cagra.SearchParams(itopk_size=32)
    hook = cagra.batched_searcher(index, sp)
    assert hook.kind == "cagra" and hook.dim == 64 and hook.device.type == "cuda"
    for m in (1, 64):
        q = torch.rand((m, 64), generator=g, device=cuda)
        d, i = hook(q, 10)
        rd, ri = cagra.search(sp, index, q, 10)
        assert torch.equal(i, ri) and torch.equal(d, rd)


def test_mutable_brute_force_on_card_crosses_the_4096_bucket(cuda):
    """A brute-force MutableIndex on the card: the delta scan takes the GEMM
    route below the 4,096-row bucket and ``fused_knn`` from it on (its f32
    launch count rises), and the ids equal the exact neighbours of the live
    rows, computed on the CPU, on both sides of the switch."""
    from raft_tpu_torch import stream

    rng = np.random.default_rng(11)
    x = rng.standard_normal((20_000, 128)).astype(np.float32)
    new = rng.standard_normal((2_200, 128)).astype(np.float32)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    m = stream.MutableIndex(BruteForce().build(x, res=Resources(device="cuda")),
                            delta_capacity=4096)
    assert m.device.type == "cuda"

    def check():
        st = m._state
        s = np.nonzero(st.sealed_alive)[0]
        dl = np.nonzero(st.delta_alive[:st.delta_n])[0]
        rows = np.concatenate([x[s], st.delta[dl]])
        gids = np.concatenate([st.id_map[s], st.delta_ids[dl]])
        ref = BruteForce().build(rows, res=Resources(device="cpu"))
        rd, ri = ref.search(q, 10)
        d, i = m.search(q, 10)
        _knn_equiv(d.cpu(), i.cpu(), rd, torch.from_numpy(gids[ri.numpy()]).to(torch.int32))

    m.upsert(new[:2000])
    m.delete(np.arange(0, 20_000, 7))
    assert m.stats()["delta_bucket"] == 2048
    check()
    m.upsert(new[2000:])
    m.delete([20_001, 20_100])
    assert m.stats()["delta_bucket"] == 4096
    before = fused_knn.launches_by_mode["f32"]
    check()
    assert fused_knn.launches_by_mode["f32"] >= before + 2   # sealed scan + delta scan


def test_mutable_ivf_pq_on_card_equals_cpu(cuda, tmp_path):
    """An IVF-PQ MutableIndex moved onto the card by ``device=``, under
    tombstones: every chunk runs pq_scan_topk with the tombstone bitset
    packed once per write, and the answers equal the CPU port's over the
    same file and write script."""
    from raft_tpu_torch import stream

    rng = np.random.default_rng(12)
    centers = rng.normal(size=(60, 32)) * 3.0
    x = (centers[rng.integers(0, 60, 40_000)] + rng.normal(size=(40_000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 60, 64)] + rng.normal(size=(64, 32))).astype(np.float32)
    new = (centers[rng.integers(0, 60, 500)] + rng.normal(size=(500, 32))).astype(np.float32)
    cpu = Resources(device="cpu")
    path = str(tmp_path / "index.bin")
    ivf_pq.save(ivf_pq.build(ivf_pq.IndexParams(n_lists=64, pq_dim=16), x, res=cpu), path)
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16", select_impl="pallas")
    # device= moves a CPU-loaded index onto the card
    mc = stream.MutableIndex(ivf_pq.load(path, res=cpu), search_params=sp,
                             delta_capacity=1024, device="cuda")
    assert mc.device.type == "cuda" and mc._state.sealed.list_codes.is_cuda
    mh = stream.MutableIndex(ivf_pq.load(path, res=cpu), search_params=sp, delta_capacity=1024)
    dead = rng.choice(40_000, 1_200, replace=False)
    for m in (mc, mh):
        m.upsert(new)
        m.delete(dead)
        m.upsert(new[:10] + 0.5, ids=dead[:10])
    counts = pq_scan_topk.launches
    d, i = mc.search(q, 10)
    torch.cuda.synchronize()
    assert pq_scan_topk.launches > counts
    rd, ri = mh.search(q, 10)
    _knn_equiv(d.cpu(), i.cpu(), rd, ri, rtol=1e-5, atol=1e-4)
    assert not set(i.flatten().tolist()) & set(dead[10:].tolist())


# -- the out-of-core build ---------------------------------------------------------

def test_stager_overlaps_compute_and_guards_its_slots(cuda):
    """Chunk N+1's upload runs on the side stream while the consuming stream
    is still busy with chunk N; a slot is rewritten only after the work
    queued on it before the next stage call has run."""
    from raft_tpu_torch.core import chunked

    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((65_536, 128)).astype(np.float32) for _ in range(3)]
    s = chunked.ChunkStager(65_536, 128, np.float32, device=cuda)
    try:
        a = s.stage(blocks[0])
        sums = [a.sum(dim=0)]                  # queued on chunk 0's slot
        torch.cuda._sleep(int(1e9))            # the consumer busy for a while
        busy = torch.cuda.current_stream().record_event()
        s.stage(blocks[1])
        s._uploaded[1].synchronize()           # chunk 1 has landed ...
        overlapped = not busy.query()          # ... while the consumer still runs
        c = s.stage(blocks[2])                 # reuses chunk 0's slot
        sums.append(c.sum(dim=0))
        torch.cuda.synchronize()
        assert overlapped
        for got, blk in zip(sums, (blocks[0], blocks[2])):
            torch.testing.assert_close(got.cpu(), torch.from_numpy(blk).sum(dim=0),
                                       rtol=1e-4, atol=1e-2)
        st = s.stats()
        assert st["uploads"] == 3 and st["pinned"] and st["upload_seconds"] > 0
    finally:
        s.release()


@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq"])
def test_streamed_build_equals_in_core_on_card(cuda, kind):
    """200k x 64 float32 in chunks of 65,536 (a short tail): the streamed
    build equals the in-core build on the card bit for bit, every field."""
    import dataclasses

    from raft_tpu_torch.core import chunked

    x = np.random.default_rng(1).standard_normal((200_000, 64)).astype(np.float32)
    res = Resources(device="cuda")
    reader = chunked.ChunkedReader(x, chunk_rows=65_536)
    if kind == "brute_force":
        a = BruteForce().build(x, res).dataset
        b = BruteForce().build(reader, res).dataset
        assert torch.equal(a, b)
        return
    mod = ivf_flat if kind == "ivf_flat" else ivf_pq
    params = (ivf_flat.IndexParams(n_lists=256, seed=0) if kind == "ivf_flat"
              else ivf_pq.IndexParams(n_lists=256, pq_dim=32, seed=0))
    a = mod.build(params, torch.from_numpy(x).to(cuda), res=res)
    b = mod.build(params, reader, res=res)
    for f in dataclasses.fields(a):
        ta, tb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(ta, torch.Tensor):
            assert ta.shape == tb.shape and torch.equal(ta, tb), f.name


# -- tiered storage ------------------------------------------------------------------

def test_tiered_fetch_on_card_equals_host_gather(cuda):
    """A cold TieredStore on the card: every fetch (one slot read-back, a
    pinned gather, a side-stream upload) equals the host gather, also when
    eight threads fetch at once through a two-slot ring and each result is
    read after the others' later uploads; the accounted slot bytes stay
    those of one ring."""
    import threading

    from raft_tpu_torch.stream import TieredStore, TierPolicy

    rng = np.random.default_rng(13)
    x = rng.standard_normal((50_000, 96)).astype(np.float32)
    ts = TieredStore(x, name="gpu_fetch", device="cuda",
                     policy=TierPolicy(auto_promote=False))
    slots = [torch.from_numpy(rng.integers(-1, 50_000, (64, 40)).astype(np.int32)).to(cuda)
             for _ in range(24)]
    want = [torch.from_numpy(x[np.clip(s.cpu().numpy(), 0, None)]) for s in slots]
    got = [ts.fetch(s) for s in slots[:4]]
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    ring_bytes = ts.tier_bytes()["device"]
    assert ring_bytes == 2 * 64 * 40 * 96 * 4
    out = [None] * len(slots)

    def worker(t):
        for j in range(t, len(slots), 8):
            out[j] = ts.fetch(slots[j])

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    torch.cuda.synchronize()
    for g, w in zip(out, want):
        assert torch.equal(g.cpu(), w)
    assert ts.tier_bytes()["device"] == ring_bytes
    assert ts.stats()["host_syncs"] == 4 + len(slots)
    for ci in range(ts.n_oracle_chunks()):
        dv, base, valid = ts.oracle_chunk_dev(ci)
        assert torch.equal(dv[:valid].cpu(), torch.from_numpy(x[base:base + valid]))
        assert not dv[valid:].any()


def test_tiered_mutable_on_card_equals_cpu(cuda, tmp_path):
    """A tiered IVF-PQ MutableIndex on the card answers as the all-HBM one
    on the card bit for bit, and as the CPU port's within the card tests'
    tolerance, before and after writes and an extend fold."""
    from raft_tpu_torch import stream

    rng = np.random.default_rng(14)
    x = rng.standard_normal((30_000, 64)).astype(np.float32)
    q = rng.standard_normal((200, 64)).astype(np.float32)
    cpu = Resources(device="cpu")
    path = str(tmp_path / "index.bin")
    p = ivf_pq.IndexParams(n_lists=64, pq_dim=32, seed=0)
    ivf_pq.save(ivf_pq.build(p, x, res=cpu), path)
    sp = ivf_pq.SearchParams(n_probes=8)
    kw = dict(search_params=sp, index_params=p, dataset=x)
    tier = stream.TierPolicy(oracle_chunk=4096, auto_promote=False)
    mt = stream.MutableIndex(ivf_pq.load(path, res=cpu), device="cuda", storage="tiered",
                             tier=tier, **kw)
    mh = stream.MutableIndex(ivf_pq.load(path, res=cpu), device="cuda", **kw)
    mc = stream.MutableIndex(ivf_pq.load(path, res=cpu), storage="tiered", tier=tier, **kw)
    for step in range(2):
        for m in (mt, mh, mc):
            m.upsert(x[:50] + 0.25, ids=np.arange(100_000 + 50 * step, 100_050 + 50 * step))
            m.delete(np.arange(step * 7, 30_000, 997))
            if step:
                m.compact()
        a, b = mt.search_refined(q, 10, 4), mh.search_refined(q, 10, 4)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        ea, eb = mt.exact_search(q, 10), mh.exact_search(q, 10)
        assert torch.equal(ea[1], eb[1]) and torch.equal(ea[0], eb[0])
        c = mc.search_refined(q, 10, 4)
        _knn_equiv(a[0].cpu(), a[1].cpu(), c[0], c[1], rtol=1e-5, atol=1e-4)
    assert mt.tiered_store.residency == "host" and mt.tiered_store._epoch == 1


def test_sweep_select_k_measures_the_topk_kernel(cuda):
    """On the card the kernel arm is measured (``kernel_measured``) and the
    decision's evidence names the device type; its pin applies."""
    from raft_tpu_torch import tune

    dec = tune.sweep_select_k(rows=128, cols=(256, 2048), ks=(10, 128), repeats=1,
                              res=Resources(device="cuda"))
    ev = dec.evidence
    assert ev["kernel_measured"] is True and ev["backend"] == "cuda"
    assert all("error" not in t for t in ev["trials"])
    assert {t["params"]["impl"] for t in ev["trials"]} == {"torch", "kernel"}
    log = tune.DecisionLog()
    log.add(dec)
    try:
        assert tune.apply_global(log) == {"select_k.wide_cols_min": dec.params["wide_cols_min"]}
    finally:
        set_wide_cols_threshold(None)


def test_interruptible_synchronize_waits_on_the_card(cuda):
    from raft_tpu_torch.core.interruptible import InterruptedException, cancel, synchronize

    a = torch.randn(2048, 2048, device=cuda)
    b = a @ a
    synchronize(b, {"x": [a]})
    cancel()
    with pytest.raises(InterruptedException):
        synchronize(b)
    synchronize(b)


def test_numpy_output_from_the_card_and_tensors_for_the_hooks(cuda):
    """Under ``"numpy"`` an entry point copies its tensors off the card;
    a serving hook and a tuned hook keep them there."""
    from raft_tpu_torch import config, tune

    rng = np.random.default_rng(15)
    x = rng.standard_normal((20_000, 64)).astype(np.float32)
    q = rng.standard_normal((64, 64)).astype(np.float32)
    res = Resources(device="cuda")
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=64, seed=0), x, res=res)
    sp = ivf_flat.SearchParams(n_probes=8)
    d, i = ivf_flat.search(sp, index, q, 10)
    hook = tune.make_searcher(index, {"kind": "ivf_flat", "params": {"n_probes": 8}})
    config.set_output_as("numpy")
    try:
        nd, ni = ivf_flat.search(sp, index, q, 10)
        hd, hi = hook(q, 10)
    finally:
        config.set_output_as("torch")
    assert isinstance(nd, np.ndarray) and np.array_equal(ni, i.cpu().numpy())
    assert np.array_equal(nd, d.cpu().numpy())
    assert hd.is_cuda and torch.equal(hi, i) and torch.equal(hd, d)


def test_warmup_on_the_card(cuda, tmp_path):
    import raft_tpu_torch
    from raft_tpu_torch.ops import _build

    before = _build.BUILD_DIR
    try:
        out = raft_tpu_torch.warmup("ivf_flat", n=20_000, d=64, queries=256,
                                    index_params=ivf_flat.IndexParams(n_lists=64),
                                    cache_dir=str(tmp_path))
    finally:
        _build.set_build_dir(before)
    assert out["attribution"] == "obs.compile" and out["cache_dir"] == str(tmp_path.resolve())
    assert out["build_s"] >= 0 and out["search"]["wall_s"] >= 0


def test_net_server_over_a_card_service_equals_direct_search(cuda):
    """The front door over a service whose index lives on the card: the wire
    answer of each row equals the index's direct search at the shape that
    served it (one row a request: bucket 1), and the window builds no
    kernel."""
    from raft_tpu_torch.net import NetClient, NetServer
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService

    g = np.random.default_rng(5)
    x = g.standard_normal((20_000, 64)).astype(np.float32)
    q = g.standard_normal((16, 64)).astype(np.float32)
    index = BruteForce().build(x, res=Resources(device="cuda"))
    svc = SearchService(max_batch=8)
    svc.publish("bf", index, k=10)
    srv = NetServer(svc)
    try:
        cli = NetClient(f"http://127.0.0.1:{srv.port}")
        before = fused_knn.launches_by_route["rows"]
        with obs_compile.attribution() as rec:
            got = [cli.search("bf", q[j:j + 1], 10) for j in range(len(q))]
        assert rec.cache_misses == 0
        assert fused_knn.launches_by_route["rows"] - before == len(q)
        for j, (d, i) in enumerate(got):
            rd, ri = index.search(q[j:j + 1], k=10)
            _knn_equiv(torch.as_tensor(d, device=cuda), torch.as_tensor(i, device=cuda),
                       rd, ri)
    finally:
        srv.stop()
        svc.shutdown()


def test_process_mesh_workers_on_the_card(cuda):
    """Two shards of brute force, each in a worker process on the card: the
    router builds the workers' kernels before spawning them, every worker
    boots on a cache hit, the merged answer equals one index's search, and
    the workers' row-split launches reach ``stats()``."""
    from raft_tpu_torch.net import MeshSpec, ProcessMesh

    g = np.random.default_rng(6)
    x = g.standard_normal((20_000, 64)).astype(np.float32)
    q = g.standard_normal((8, 64)).astype(np.float32)
    mesh = ProcessMesh(x, spec=MeshSpec(n_shards=2, n_replicas=1, ks=(10,),
                                        max_batch=8))
    try:
        d, i = mesh.search("corpus", q, 10)
        st = mesh.stats()
    finally:
        mesh.close()
    assert st["workers"] == 2
    assert st["cache_misses"] == 0 and st["boot_cache_misses"] == 0
    assert st["boot_cache_hits"] >= 2
    assert st["launches"]["fused_knn_rows"] >= 2
    rd, ri = BruteForce().build(x, res=Resources(device="cuda")).search(q, k=10)
    _knn_equiv(torch.as_tensor(d, device=cuda), torch.as_tensor(i, device=cuda), rd, ri)


def test_two_gloo_ranks_share_the_card(cuda):
    """A world of two ranks on one card (gloo: NCCL refuses a duplicate
    device): the collective self-tests pass, ``ppermute`` stages through the
    host, and ``parallel.knn`` equals ``brute_force.knn`` on the card."""
    import torch_rank_tasks as tasks

    from raft_tpu_torch.core.platform import RankPool
    from raft_tpu_torch.neighbors import brute_force

    rng = np.random.default_rng(0)
    x = rng.random((20_000, 64)).astype(np.float32)
    q = rng.random((300, 64)).astype(np.float32)
    with RankPool(2, device="cuda:0", backend="gloo", timeout_s=300, threads=0) as pool:
        outs = pool.run(tasks.run_all, 2)
        got = pool.run(tasks.call, 2, "parallel.knn.knn", x, q, 10)
    for o in outs:
        assert all(o["results"].values()) and o["backend"] == "gloo", o
        assert o["devices"] == ["cuda:0", "cuda:0"] and o["stats"]["host_hops"] > 0
    d, i = brute_force.knn(x, q, 10, res=Resources(device="cuda"))
    for gd, gi in got:
        assert torch.equal(gi, i.cpu())
        torch.testing.assert_close(gd, d.cpu(), rtol=1e-5, atol=0)


def test_cagra_spans_line_up_with_the_device_trace(cuda):
    """A CUDA-only profiler session over CAGRA batches on the card records
    the program's spans on the trace's clock: each ``cagra.hop.flag_read``
    span holds the ``cudaStreamSynchronize`` its device read issues (at
    least 99% of them), and the trace's ``cagra_hop`` launches equal the sum
    over the searches of ``hops`` + 1 (the prime launch) exactly."""
    import statistics

    from raft_tpu_torch.core import tracing

    g = torch.Generator(device=cuda).manual_seed(11)
    centers = torch.rand((64, 64), generator=g, device=cuda) * 4
    x = centers[torch.randint(0, 64, (60_000,), generator=g, device=cuda)]
    x = x + 0.3 * torch.randn(x.shape, generator=g, device=cuda)
    q = x[torch.randint(0, 60_000, (3_000,), generator=g, device=cuda)] + 0.05
    index = cagra.build(cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16), x,
                        res=Resources(device="cuda"))
    params = cagra.SearchParams(itopk_size=32)
    cagra.search(params, index, q, 10)
    torch.cuda.synchronize()
    tracing.clear()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        for _ in range(3):
            cagra.search(params, index, q, 10)
        torch.cuda.synchronize()
    spans = tracing.spans()
    syncs, launches = [], 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA":
            launches += "cagra_hop_kernel" in ev.name()
        elif ev.name() == "cudaStreamSynchronize":
            syncs.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    searches = [s for s in spans if s.name == "cagra.search"]
    assert len(searches) == 3 and tracing.dropped() == 0
    assert launches == sum(s.attrs["hops"] + 1 for s in searches)
    reads = [s for s in spans if s.name == "cagra.hop.flag_read"]
    assert reads
    offsets = []
    for r in reads:
        inside = [s0 - r.start_ns for s0, s1 in syncs if r.start_ns <= s0 and s1 <= r.end_ns]
        if inside:
            offsets.append(inside[0])
    assert len(offsets) >= 0.99 * len(reads), (len(offsets), len(reads))
    print(f"flag reads {len(reads)}, holding their sync {len(offsets)}, median offset "
          f"{statistics.median(offsets)} ns; cagra_hop launches {launches}; hops "
          f"{[s.attrs['hops'] for s in searches]} stop {[s.attrs['stop'] for s in searches]}")
