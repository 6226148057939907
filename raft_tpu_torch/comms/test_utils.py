"""Collective self-tests, runnable on any world.

Counterpart of raft_tpu/comms/test_utils.py (reference:
cpp/include/raft/comms/comms_test.hpp, detail/test.hpp:
test_collective_allreduce/broadcast/reduce/allgather/gather/gatherv/
reducescatter, test_pointToPoint_sendrecv, test_commsplit; raft-dask's
perform_test_comms_*, comms_utils.pyx:78-244). Every rank of the
communicator calls each test; each returns True iff every rank observed the
mathematically expected value.
"""

from __future__ import annotations

import torch

from .comms import Comms, P

__all__ = [
    "test_collective_allreduce",
    "test_collective_broadcast",
    "test_collective_reduce",
    "test_collective_allgather",
    "test_collective_reducescatter",
    "test_pointtopoint_ring",
    "test_commsplit",
    "run_all",
]


def _all_shards_ok(comms: Comms, ok_fn) -> bool:
    """Run ``ok_fn`` on every rank; AND the verdicts across the clique."""

    def prog():
        ok = torch.as_tensor(ok_fn(comms), device=comms.device)
        return comms.allreduce(ok.to(torch.int32), "min")

    out = comms.shard_map(prog, in_specs=(), out_specs=P())()
    return bool(out == 1)


def _rank(c: Comms) -> torch.Tensor:
    return torch.tensor(float(c.rank()), device=c.device)


def test_collective_allreduce(comms: Comms) -> bool:
    """Each rank contributes 1; everyone must see size (ref: detail/test.hpp:45)."""
    return _all_shards_ok(
        comms, lambda c: c.allreduce(torch.ones((), device=c.device), "sum") == c.size())


def test_collective_broadcast(comms: Comms) -> bool:
    """Root holds 42, the others -1; everyone must see 42 (ref:
    test_collective_bcast)."""
    return _all_shards_ok(
        comms, lambda c: c.bcast(torch.tensor(42.0 if c.rank() == 0 else -1.0,
                                              device=c.device), root=0) == 42.0)


def test_collective_reduce(comms: Comms) -> bool:
    return _all_shards_ok(
        comms, lambda c: c.reduce(_rank(c), root=0) == c.size() * (c.size() - 1) / 2)


def test_collective_allgather(comms: Comms) -> bool:
    """Rank r contributes r; the gathered vector must be 0..size-1."""

    def ok(c: Comms):
        g = c.allgather(_rank(c)[None])
        want = torch.arange(c.size(), dtype=torch.float32, device=c.device)[:, None]
        return torch.all(g == want)

    return _all_shards_ok(comms, ok)


def test_collective_reducescatter(comms: Comms) -> bool:
    """Each rank contributes ones(size); each gets back size (its slot's sum)."""

    def ok(c: Comms):
        out = c.reducescatter(torch.ones((c.size(),), device=c.device))
        return torch.all(out == c.size())

    return _all_shards_ok(comms, ok)


def test_pointtopoint_ring(comms: Comms) -> bool:
    """Ring sendrecv: after one +1 shift every rank holds its left neighbour's
    rank (ref: test_pointToPoint_simple_send_recv)."""

    def ok(c: Comms):
        got = c.shift(_rank(c)[None], offset=1)
        return torch.all(got == (c.rank() - 1) % c.size())

    return _all_shards_ok(comms, ok)


def test_commsplit(comms: Comms, sub_axis: str) -> bool:
    """Collectives over a sub-axis span that axis only (ref: test_commsplit)."""

    def ok(c: Comms):
        sub = c.comm_split(sub_axis)
        return sub.allreduce(torch.ones((), device=c.device), "sum") == sub.size()

    return _all_shards_ok(comms, ok)


def run_all(comms: Comms) -> dict:
    """The perform_test_comms_* battery (raft-dask test_comms.py analogue)."""
    return {
        "allreduce": test_collective_allreduce(comms),
        "broadcast": test_collective_broadcast(comms),
        "reduce": test_collective_reduce(comms),
        "allgather": test_collective_allgather(comms),
        "reducescatter": test_collective_reducescatter(comms),
        "p2p_ring": test_pointtopoint_ring(comms),
    }
