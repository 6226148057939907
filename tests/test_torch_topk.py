"""raft_tpu_torch.ops.topk against raft_tpu.ops.topk.topk_pallas.

The same seeded numpy matrices, with planted ties and ±inf, go through the
Pallas selector in interpret mode and through the port's plain version (the
CPU route of ``topk``): values and indices must be exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops.topk import topk_pallas
from raft_tpu_torch.ops.topk import TOPK_MAX_K, top_k_lowest_index, topk, topk_plain


def _matrix(seed, m=6, n=700):
    rng = np.random.default_rng(seed)
    x = rng.random((m, n)).astype(np.float32)
    x[0, ::3] = 0.25                              # heavy ties
    x[1] = rng.integers(0, 12, n).astype(np.float32)
    x[2, 5:] = np.inf                             # fewer than k finite
    x[3, ::2] = -np.inf
    x[4, :40] = 3.2e38                            # clamps to 2.9e38
    x[4, 40:80] = -np.inf
    x[5, 100:130] = -0.0
    x[5, 130:160] = 0.0
    return x


@pytest.mark.parametrize("k,select_min", [(5, True), (5, False), (64, False),
                                          (100, True)])
def test_plain_matches_pallas(k, select_min):
    x = _matrix(k)
    jv, ji = topk_pallas(jnp.asarray(x), k, select_min=select_min, blk=256,
                         interpret=True)
    tv, ti = topk(torch.from_numpy(x), k, select_min=select_min)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_types_rank_as_float32(dtype):
    x = torch.from_numpy(_matrix(3)[:, :300]).to(dtype)
    v, i = topk_plain(x, 7, select_min=True)
    _, ref = top_k_lowest_index(-torch.clamp(x.float(), -2.9e38, 2.9e38), 7)
    assert v.dtype == dtype and torch.equal(i.long(), ref)
    assert torch.equal(v, torch.gather(x, 1, ref))


def test_top_k_lowest_index_ties_and_types():
    v = torch.tensor([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0]], dtype=torch.int32)
    vals, idx = top_k_lowest_index(v, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]] and vals.tolist() == [[3, 3, 3], [0, 0, 0]]
    f = torch.tensor([[0.5, -0.0, 0.0, float("inf"), 0.5]], dtype=torch.float64)
    assert top_k_lowest_index(f, 4)[1].tolist() == [[3, 0, 4, 1]]


def test_k_limits():
    from raft_tpu_torch.core import RaftError

    with pytest.raises(RaftError):
        topk(torch.zeros((2, 300)), TOPK_MAX_K + 1)
    with pytest.raises(RaftError):
        topk(torch.zeros((2, 300), dtype=torch.int32), 4)
