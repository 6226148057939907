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
from raft_tpu_torch.matrix import select_k
from raft_tpu_torch.neighbors.brute_force import BruteForce
from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
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


@pytest.mark.parametrize("mode", ["f32", "f32x3", "bf16", "s8"])
def test_fused_knn_kernel_matches_plain(cuda, mode):
    """d=70 also takes the wrapper's pad to a multiple of 4."""
    g = torch.Generator(device=cuda).manual_seed(0)
    if mode == "s8":
        x = torch.randint(-128, 128, (20_011, 70), generator=g, device=cuda,
                          dtype=torch.int8)
        q = torch.randint(-128, 128, (300, 70), generator=g, device=cuda,
                          dtype=torch.int8)
    else:
        x = torch.rand((20_011, 70), generator=g, device=cuda)
        q = torch.rand((300, 70), generator=g, device=cuda)
    keep = torch.rand(20_011, generator=g, device=cuda) < 0.7
    for k, metric in ((1, "l2"), (10, "ip"), (64, "l2")):
        before = fused_knn.launches
        kd, ki = fused_knn(x, q, k, metric=metric, mode=mode, keep_mask=keep)
        torch.cuda.synchronize()
        assert fused_knn.launches == before + 1
        pd, pi = fused_knn_plain(x, q, k, metric=metric, mode=mode, keep_mask=keep)
        if mode == "s8":
            assert torch.equal(kd, pd) and torch.equal(ki, pi)
        else:
            _knn_equiv(kd, ki, pd, pi)


@pytest.mark.parametrize("k", [1, 10, 64, 100, 256])
def test_topk_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    x = rng.random((64, 70_001)).astype(np.float32)
    x[0, ::3] = 0.25
    x[1] = rng.integers(0, 12, x.shape[1])
    x[2, 5:] = np.inf
    x[3, ::2] = -np.inf
    x[4, 100:400] = -0.0
    x = torch.from_numpy(x).to(cuda)
    for select_min in (True, False):
        before = topk.launches
        kv, ki = topk(x, k, select_min=select_min)
        torch.cuda.synchronize()
        assert topk.launches == before + 1
        pv, pi = topk_plain(x, k, select_min=select_min)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)


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
    v = torch.rand((16, 65_536), generator=g, device=cuda)
    before = topk.launches
    sv, si = select_k(v, 5, res=res)
    assert topk.launches == before + 1
    ref = torch.sort(v, dim=1, stable=True)
    assert torch.equal(sv, ref.values[:, :5]) and torch.equal(si.long(), ref.indices[:, :5])
