"""raft_tpu_torch.ops.pq_scan against raft_tpu.ops.pq_scan.pq_lut_scan.

The same seeded codes and LUTs go to the JAX Pallas kernel (interpret mode,
as tests/test_ivf_pq.py runs it) and to the port's plain version. The port
takes the index's list layout and the probed list ids, so the codes are
stored in a shuffled list order and the pairs point into it. The JAX kernel
sums through an MXU contraction in another order than the port's subspace
loop, hence rtol 1e-5 / atol 1e-4 (tests/test_ivf_pq.py:418-441).

``pq_scan_topk`` (the scan fused with the chunk's select) is held bit for
bit against the search's unfused chunk step and against a numpy reference;
its JAX parity runs through whole searches in tests/test_torch_ivf_pq.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops.pq_scan import pq_lut_scan
from raft_tpu_torch.core import RaftError
from raft_tpu_torch.ops.pq_scan import (pq_scan, pq_scan_plain, pq_scan_topk,
                                        pq_scan_topk_fits, pq_scan_topk_plain)
from test_torch_gpu import pq_topk_inputs


def _both(S, split, lut_dtype=np.float32, pairs=4, cap=24, seed=0):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 16, (pairs, cap, S), dtype=np.int8)
    lo = rng.integers(0, 16, (pairs, cap, S), dtype=np.int8)
    lut = (rng.normal(size=(pairs, 32 if split else 16, S)) * 10).astype(np.float32)
    jlut = jnp.asarray(lut).astype(jnp.bfloat16 if lut_dtype == "bf16" else jnp.float32)
    want = np.asarray(pq_lut_scan(jnp.asarray(hi), jlut,
                                  codes_lo=jnp.asarray(lo) if split else None,
                                  bt=2, interpret=True))
    # the port reads packed bytes from lists: pair b's codes live in list perm[b]
    packed = ((hi.astype(np.uint8) << 4) | lo.astype(np.uint8)) if split else hi.astype(np.uint8)
    perm = rng.permutation(pairs + 3)[:pairs]
    lists = np.zeros((pairs + 3, cap, S), np.uint8)
    lists[perm] = packed
    tlut = torch.from_numpy(np.ascontiguousarray(lut.transpose(0, 2, 1)))
    if lut_dtype == "bf16":
        tlut = tlut.to(torch.bfloat16)
    got = pq_scan_plain(torch.from_numpy(lists), torch.from_numpy(perm.astype(np.int32)),
                        tlut, split=split)
    return got.numpy(), want


@pytest.mark.parametrize("S,split", [(16, False), (24, False), (96, False),
                                     (8, True), (24, True)])
def test_plain_matches_jax_kernel(S, split):
    got, want = _both(S, split)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("split", [False, True])
def test_bf16_lut_matches_jax_kernel(split):
    """Both read the bfloat16 LUT exactly and sum in float32."""
    got, want = _both(16, split, lut_dtype="bf16", seed=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(rng.integers(0, 256, (9, 33, 24), dtype=np.uint8))
    probes = torch.tensor([4, 4, 0, 8, 1], dtype=torch.int32)
    for split in (False, True):
        lut = torch.from_numpy(rng.normal(size=(5, 24, 32 if split else 16)).astype(np.float32))
        before = pq_scan.launches
        got = pq_scan(codes, probes, lut, split=split)
        assert pq_scan.launches == before
        assert torch.equal(got, pq_scan_plain(codes, probes, lut, split=split))
        # stray bytes of a pq4 scan take their low nibble, as the kernel does
        if not split:
            assert torch.equal(got, pq_scan_plain(codes & 15, probes, lut))


def test_contract_errors():
    codes = torch.zeros((4, 8, 16), dtype=torch.uint8)
    probes = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(RaftError, match="K=32"):
        pq_scan(codes, probes, torch.zeros((3, 16, 16)), split=True)
    with pytest.raises(RaftError, match="float32 or bfloat16"):
        pq_scan(codes, probes, torch.zeros((3, 16, 16), dtype=torch.float64))
    with pytest.raises(RaftError, match="uint8"):
        pq_scan(codes.to(torch.int8), probes, torch.zeros((3, 16, 16)))
    with pytest.raises(RaftError, match="int32"):
        pq_scan(codes, probes.to(torch.int64), torch.zeros((3, 16, 16)))


# ---- pq_scan_topk: the scan fused with the chunk's select ----

def _numpy_scan_topk(codes, ids, probes, lut, bias, consts, k, select_min, split):
    """An independent reference: float32 sums in subspace order, then the
    adds and the mask, then a stable sort (no input here is NaN, -0 or
    beyond ±2.9e38, so the stable sort ranks as the kernel's keys do)."""
    codes, ids, probes, bias = (a.numpy() for a in (codes, ids, probes, bias))
    lut = lut.to(torch.float32).numpy()
    t, pc = probes.shape
    cap, s = codes.shape[1:]
    c = codes[probes].astype(np.int64)                     # (t, pc, cap, s)
    acc = np.zeros((t, pc, cap), np.float32)
    tt, pp = np.arange(t)[:, None, None], np.arange(pc)[None, :, None]
    for si in range(s):
        tab = lut[:, :, si, :]
        if split:
            acc = acc + (tab[tt, pp, c[..., si] >> 4] + tab[tt, pp, 16 + (c[..., si] & 15)])
        else:
            acc = acc + tab[tt, pp, c[..., si] & 15]
    acc = acc + bias[:, :, None]
    if consts is not None:
        acc = acc + consts.numpy()[probes]
    slot_ids = ids[probes]
    acc = np.where(slot_ids >= 0, acc, np.float32(np.inf if select_min else -np.inf))
    flat, fids = acc.reshape(t, -1), slot_ids.reshape(t, -1)
    order = np.argsort(flat if select_min else -flat, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(flat, order, 1), np.take_along_axis(fids, order, 1)


def _unfused(codes, ids, probes, lut, bias, consts, k, select_min, split):
    """The search's unfused chunk step: pq_scan, bias, constants, mask, then
    the topk kernel's select with the ids as payload."""
    from raft_tpu_torch.matrix.select_k import select_k_impl

    t, pc = probes.shape
    cap, s = codes.shape[1:]
    scores = pq_scan(codes, probes.reshape(-1), lut.reshape(t * pc, s, -1),
                     split=split).reshape(t, pc, cap) + bias[:, :, None]
    rows = probes.to(torch.int64)
    if consts is not None:
        scores = scores + consts[rows]
    slot_ids = ids[rows]
    scores = torch.where(slot_ids >= 0, scores, float("inf") if select_min else float("-inf"))
    return select_k_impl(scores.reshape(t, -1), slot_ids.reshape(t, -1), k, select_min,
                         impl="kernel")


@pytest.mark.parametrize("k", [1, 7, 40, 256])
@pytest.mark.parametrize("pc", [1, 3, 8])
@pytest.mark.parametrize("split,dtype,inner", [
    (False, torch.float32, False), (False, torch.bfloat16, True),
    (True, torch.float32, False), (True, torch.bfloat16, False), (True, torch.float32, True),
])
def test_scan_topk_plain_is_the_unfused_step(k, pc, split, dtype, inner):
    """Bit for bit, values and ids, against the unfused chunk step and
    against a numpy reference, ties and underfill included."""
    s = 16 if split else 24
    args = pq_topk_inputs(s, split, pc, dtype, inner, seed=k + pc)
    codes, ids, probes, lut, bias, consts = args
    smin = not inner
    before = pq_scan_topk.launches
    v, i = pq_scan_topk(codes, ids, probes, lut, bias, k, smin, split=split,
                        list_consts=consts)
    assert pq_scan_topk.launches == before               # CPU tensors: the plain version
    pv, pi = pq_scan_topk_plain(codes, ids, probes, lut, bias, k, smin, split, consts)
    assert v.dtype == torch.float32 and i.dtype == torch.int32 and v.shape == (5, k)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    uv, ui = _unfused(*args, k, smin, split)
    assert torch.equal(v.view(torch.int32), uv.view(torch.int32)) and torch.equal(i, ui)
    nv, ni = _numpy_scan_topk(*args, k, smin, split)
    np.testing.assert_array_equal(v.numpy(), nv)
    np.testing.assert_array_equal(i.numpy(), ni)
    if k > 3 and pc > 1:    # query 2: 3 filled slots, then ±inf and -1
        assert bool(torch.isinf(v[2, 3:]).all()) and bool((i[2, 3:] == -1).all())
        assert bool((i[2, :3] >= 0).all())


def test_scan_topk_ties_go_to_the_lowest_flat_position():
    """Query 1's tied rows (list 2 slots 5 and 9 at probe 0, list 3 slot 0 at
    probe 1) come out in flat-position order wherever they rank."""
    codes, ids, probes, lut, bias, _ = pq_topk_inputs(16, False, 3, seed=4)
    row = codes[2, 5].to(torch.int64)
    lut[1, :2, torch.arange(16), row] = -1000.0        # the tied rows rank first
    v, i = pq_scan_topk(codes, ids, probes, lut, bias, 7, True)
    want = [int(ids[2, 5]), int(ids[2, 9]), int(ids[3, 0])]
    assert i[1, :3].tolist() == want
    assert v[1, 0] == v[1, 1] == v[1, 2] < v[1, 3]


def test_scan_topk_contract_errors():
    codes, ids, probes, lut, bias, _ = pq_topk_inputs(16, False, 2)
    with pytest.raises(RaftError, match="k=0"):
        pq_scan_topk(codes, ids, probes, lut, bias, 0, True)
    with pytest.raises(RaftError, match="k=257"):
        pq_scan_topk(codes, ids, probes, lut, bias, 257, True)
    with pytest.raises(RaftError, match="list_ids"):
        pq_scan_topk(codes, ids.to(torch.int64), probes, lut, bias, 5, True)
    with pytest.raises(RaftError, match="bias"):
        pq_scan_topk(codes, ids, probes, lut, bias[:, :1], 5, True)
    with pytest.raises(RaftError, match="K=32"):
        pq_scan_topk(codes, ids, probes, lut, bias, 5, True, split=True)
    with pytest.raises(RaftError, match="list_consts"):
        pq_scan_topk(codes, ids, probes, lut, bias, 5, True, list_consts=bias)
    assert pq_scan_topk_fits(64, False, torch.bfloat16, 8)
    assert pq_scan_topk_fits(128, True, torch.float32, 32)
    assert not pq_scan_topk_fits(256, True, torch.float32, 8)
