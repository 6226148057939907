"""raft_tpu_torch.distance.pairwise against raft_tpu.distance.pairwise, for
the metrics brute force uses, on seeded numpy inputs (CPU, rtol=1e-5: the
products are summed in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance import pairwise as jpw
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.distance import pairwise as tpw
from raft_tpu_torch.distance.types import DistanceType

CPU = Resources(device="cpu")


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product",
                                    "cosine", DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_matches_jax(metric, compute):
    rng = np.random.default_rng(31)
    x = rng.random((37, 20), np.float32)
    y = rng.random((53, 20), np.float32)
    if compute == "bfloat16":
        # the JAX package's bfloat16 mode is a TPU precision hint (full
        # float32 on the CPU); give both bf16-exact operands to compare
        x, y = (np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (x, y))
    jm = metric if isinstance(metric, str) else jpw.DistanceType(int(metric))
    ref = np.asarray(jpw.pairwise_distance(jnp.asarray(x), jnp.asarray(y), jm,
                                           compute=compute))
    got = tpw.pairwise_distance(x, y, metric, compute=compute, res=CPU).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_tiling_helpers_match_jax():
    for m, n, d, b in ((10_000, 1_000_000, 1, 2 << 30), (37, 53, 20, 4096),
                       (5, 10, 3, 1 << 40)):
        assert tpw._choose_tile(m, n, d, b) == jpw._choose_tile(m, n, d, b)
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    jt, jn = jpw._pad_to_tiles(jnp.asarray(x), 4)
    tt, tn = tpw._pad_to_tiles(torch.from_numpy(x), 4)
    assert jn == tn and np.array_equal(np.asarray(jt), tt.numpy())


def test_unported_metric_raises():
    with pytest.raises(RaftError, match="not yet ported"):
        tpw.pairwise_distance(np.ones((2, 3)), metric="l1", res=CPU)
