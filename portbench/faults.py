"""Faults planted under the timed path, for the tests that see ``correct``
come out false. Never used by a benchmark run.

- ``alter_answer``: the first id of every answer row replaced by the next
  row's id, where the answer is produced;
- ``half_batch``: half of each batch left out, its answers taken from the
  half that was searched;
- ``far_neighbours``: each query answered with the ids found for the next
  query of its batch, given their exact distances to it and sorted: valid
  answers whose distances are right and whose rows are not the neighbours.
"""

from __future__ import annotations

import math

import torch

FAULTS = ("alter_answer", "half_batch", "far_neighbours")


def wrap(fn, fault: str | None, x):
    """``fn(queries) -> (distances, ids)`` over the rows ``x`` with ``fault``
    planted."""
    if fault is None:
        return fn
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (one of {', '.join(FAULTS)})")

    def broken(q):
        if fault == "half_batch":
            m, h = q.shape[0], max(1, q.shape[0] // 2)
            d, ids = fn(q[:h])
            reps = math.ceil(m / h)
            return d.repeat(reps, 1)[:m], ids.repeat(reps, 1)[:m]
        if fault == "far_neighbours":
            _, ids = fn(q.roll(-1, dims=0))
            rows = x[ids.to(torch.int64)].to(torch.float32)
            d = ((rows - q.to(torch.float32)[:, None, :]) ** 2).sum(dim=-1)
            d, pos = torch.sort(d, dim=1)
            return d, torch.gather(ids, 1, pos)
        d, ids = fn(q)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % x.shape[0]
        return d, ids

    broken.__dict__.update(getattr(fn, "__dict__", {}))
    return broken
