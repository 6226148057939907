"""raft_tpu_torch.ops.cagra_hop against raft_tpu.ops.cagra_hop.

The JAX kernel runs in Pallas interpret mode (``interpret=True``); the port's
``cagra_hop`` runs its plain version on CPU tensors. Both get the same inputs,
made with numpy from a seed; the JAX side gets the candidate rows gathered,
the port the dataset. Ids, visited flags, picks and no_cand must be equal;
beam distances agree within rtol 1e-5 / atol 1e-5 (JAX sums the squared
differences in XLA's order, the port in the kernel's). Candidate rows are
drawn so that no two distinct candidates of a row lie within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops.cagra_hop import cagra_hop as j_hop
from raft_tpu_torch.core import RaftError
from raft_tpu_torch.ops import cagra_hop as hop_mod
from raft_tpu_torch.ops.cagra_hop import cagra_hop, cagra_hop_plain, hop_shapes_eligible

N = 700


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain hop is thousands of small ops; with several test workers on
    one machine, torch's intra-op threads contend far more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(d, itopk, width, dtype, prime, seed, deg=32, m=64):
    rng = np.random.default_rng(seed)
    cw = width * deg
    if dtype == "exact":
        # small integers: every distance is exact in float32 whatever the
        # summation order, so a candidate equal to a beam id carries the
        # beam's distance bit for bit in both packages
        data = rng.integers(0, 16, (N, d)).astype(np.float32)
        q = rng.integers(0, 16, (m, d)).astype(np.float32)
    elif dtype == "int8":
        data = rng.integers(-128, 128, (N, d), dtype=np.int8)
        q = (rng.integers(-128, 128, (m, d)) + rng.random((m, d))).astype(np.float32)
    else:
        data = rng.random((N, d)).astype(np.float32)
        q = rng.random((m, d)).astype(np.float32)
    bd = np.full((m, 128), np.inf, np.float32)
    bi = np.full((m, 128), -1, np.int32)
    bv = np.ones((m, 128), np.int32)
    for r in range(m):
        ids = rng.choice(N, itopk, replace=False)
        dist = ((data[ids].astype(np.float32) - q[r]) ** 2).sum(1)
        order = np.argsort(dist)
        fill = itopk if r % 5 else itopk // 2          # some beams not yet full
        bi[r, :fill] = ids[order][:fill]
        bd[r, :fill] = dist[order][:fill]
        bv[r, :fill] = rng.integers(0, 2, fill)
        bv[r, fill:itopk] = 0 if r % 3 == 0 else 1
    nbrs = rng.integers(0, N, (m, cw)).astype(np.int32)
    nbrs[::2, 0] = bi[::2, 1]                 # a candidate already in the beam
    nbrs[::3, 1] = nbrs[::3, 2]               # a repeat within the row
    nbrs[::4, 3] = -1                         # no candidate
    valid = (rng.random((m, cw)) > 0.1).astype(np.int32)
    valid[7::9] = 0                           # a row whose picks all failed
    if prime:
        nbrs[:] = -1
        valid[:] = 0
    return q, bd, bi, bv, nbrs, data, valid


def _jax(q, bd, bi, bv, nbrs, data, valid, itopk, width, merge, profile="full"):
    out = j_hop(*(jnp.asarray(a) for a in (q, bd, bi, bv, nbrs, data[np.maximum(nbrs, 0)],
                                           valid)),
                itopk, width, interpret=True, merge=merge, profile=profile)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("d,width,dtype,merge,prime", [
    (24, 1, "f32", "extract", False),
    (24, 1, "f32", "arena", False),
    (128, 2, "f32", "arena", False),
    (128, 2, "int8", "extract", False),
    (24, 2, "f32", "extract", True),
    (24, 1, "int8", "arena", True),
    (24, 1, "f32", "arena_smem", False),
])
def test_plain_matches_jax_kernel(d, width, dtype, merge, prime):
    args = _inputs(d, 32, width, dtype, prime, seed=d + width)
    want = _jax(*args, 32, width, merge)
    got = [t.numpy() for t in cagra_hop_plain(*(torch.from_numpy(a) for a in args), 32,
                                              width, merge)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("beam_i", "beam_v", "pick", "no_cand"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if prime:
        assert got[1][:, 32:].max() == -1 and np.isinf(got[0][:, 32:]).all()


@pytest.mark.parametrize("merge", ["extract", "arena", "arena_smem"])
@pytest.mark.parametrize("profile", ["noscore", "nodedup", "nomerge", "nogate"])
def test_profile_carve_outs_match_jax_kernel(profile, merge):
    """Each carve-out of the plain version against the JAX kernel's, in
    interpret mode (under an arena merge, "noscore" and "nodedup" take the
    extract path there too), bit for bit. Without the dedup masks a beam id
    met again as a candidate keeps the visited flag of whichever copy ties,
    so the rows hold integers and every distance is exact in both."""
    args = _inputs(24, 32, 2, "exact", False, seed=11)
    want = _jax(*args, 32, 2, merge, profile)
    got = [t.numpy() for t in cagra_hop_plain(*(torch.from_numpy(a) for a in args), 32, 2,
                                              merge, profile)]
    for name, g, w in zip(("beam_d", "beam_i", "beam_v", "pick", "no_cand"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("merge", ["extract", "arena"])
def test_nogate_answers_as_full(merge):
    """The gate only skips arena steps that would insert nothing."""
    args = [torch.from_numpy(a) for a in _inputs(24, 32, 2, "f32", False, seed=12)]
    for a, b in zip(cagra_hop(*args, 32, 2, merge=merge, profile="nogate"),
                    cagra_hop(*args, 32, 2, merge=merge)):
        assert torch.equal(a, b)


def test_summation_order_is_the_kernels():
    """Lane l sums dims c*128 + 4l .. +3 in order; lane sums fold 16, 8, .., 1."""
    q, bd, bi, bv, nbrs, data, valid = _inputs(100, 32, 1, "f32", False, seed=5)
    valid[:] = 1
    ok = nbrs >= 0
    got = hop_mod._scores(*(torch.from_numpy(a) for a in (q, nbrs, data, valid))).numpy()
    want = np.full(nbrs.shape, np.inf, np.float32)
    for r, j in zip(*np.nonzero(ok)):
        diff = (data[nbrs[r, j]] - q[r]).astype(np.float32)
        sq = np.zeros(128, np.float32)
        sq[:100] = diff * diff
        lanes = np.zeros(32, np.float32)
        for c in range(4):
            lanes = lanes + sq.reshape(32, 4)[:, c]
        for h in (16, 8, 4, 2, 1):
            lanes = lanes[:h] + lanes[h:2 * h]
        want[r, j] = lanes[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("merge", ["extract", "arena"])
def test_cpu_tensors_run_the_plain_version(merge):
    args = [torch.from_numpy(a) for a in _inputs(24, 32, 2, "f32", False, seed=9)]
    before = cagra_hop.launches
    got = cagra_hop(*args, 32, 2, merge=merge)
    assert cagra_hop.launches == before
    for a, b in zip(got, cagra_hop_plain(*args, 32, 2, merge=merge)):
        assert torch.equal(a, b)
    if merge == "arena":
        smem = cagra_hop(*args, 32, 2, merge="arena_smem")
        assert all(torch.equal(a, b) for a, b in zip(got, smem))


def test_contract_errors():
    q, bd, bi, bv, nbrs, data, valid = (torch.from_numpy(a)
                                        for a in _inputs(24, 32, 1, "f32", False, seed=1))
    with pytest.raises(RaftError, match="merge"):
        cagra_hop(q, bd, bi, bv, nbrs, data, valid, 32, merge="sorted")
    with pytest.raises(ValueError, match="unknown profile 'fast'"):
        cagra_hop(q, bd, bi, bv, nbrs, data, valid, 32, profile="fast")
    with pytest.raises(RaftError, match="float32 or int8"):
        cagra_hop(q, bd, bi, bv, nbrs, data.to(torch.float64), valid, 32)
    with pytest.raises(RaftError, match="itopk"):
        cagra_hop(q, bd, bi, bv, nbrs, data, valid, 100)
    with pytest.raises(RaftError, match="beam_i"):
        cagra_hop(q, bd, bi.to(torch.int64), bv, nbrs, data, valid, 32)
    with pytest.raises(RaftError, match="valid"):
        cagra_hop(q, bd, bi, bv, nbrs, data, valid[:, :5], 32)
    meta = [t.to("meta") for t in (q, bd, bi, bv, nbrs, data, valid)]
    with pytest.raises(RaftError, match="cuda or cpu"):
        cagra_hop(*meta, 32)


def test_eligibility():
    assert hop_shapes_eligible(32, 32, 1, 128)
    assert hop_shapes_eligible(64, 32, 2, 128)            # fills the 128 lanes
    assert not hop_shapes_eligible(64, 24, 3, 24)         # 136 > 128
    assert hop_shapes_eligible(32, 32, 1, hop_mod.MAX_D)
    assert not hop_shapes_eligible(32, 32, 1, hop_mod.MAX_D + 1)
    # 4 zero-padded float32 query rows and 4 KB of candidate arrays per block
    assert 4 * hop_mod.MAX_D * 4 + 4096 <= 232448 < 4 * (hop_mod.MAX_D + 128) * 4 + 4096
