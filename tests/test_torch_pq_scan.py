"""raft_tpu_torch.ops.pq_scan against raft_tpu.ops.pq_scan.pq_lut_scan.

The same seeded codes and LUTs go to the JAX Pallas kernel (interpret mode,
as tests/test_ivf_pq.py runs it) and to the port's plain version. The port
takes the index's list layout and the probed list ids, so the codes are
stored in a shuffled list order and the pairs point into it. The JAX kernel
sums through an MXU contraction in another order than the port's subspace
loop, hence rtol 1e-5 / atol 1e-4 (tests/test_ivf_pq.py:418-441).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops.pq_scan import pq_lut_scan
from raft_tpu_torch.core import RaftError
from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_plain


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
