"""CAGRA through raft_tpu_torch: ``cagra.build``; a batch is one
``cagra.search``."""

from __future__ import annotations

import dataclasses

import torch

from portbench import roofline


@dataclasses.dataclass
class State:
    index: object
    x: torch.Tensor
    params: object           # cagra.SearchParams
    k: int


def build(config: dict, x: torch.Tensor, device) -> State:
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra

    spec = config["index"]
    index = cagra.build(cagra.IndexParams(**spec["build"]), x, res=Resources(device=str(device)))
    return State(index, x, cagra.SearchParams(**spec["search"]), int(config["k"]))


def searcher(st: State):
    from raft_tpu_torch.neighbors import cagra

    def fn(q):
        return cagra.search(st.params, st.index, q, st.k)

    return fn


def cagra_hop_work(st: State, queries: torch.Tensor):
    """(bytes, operations, launches) of the ``cagra_hop`` launches of one
    search of ``queries``, read by running that search once more with each
    launch's inputs looked at (the distinct candidate rows it must read);
    None where the search launches no ``cagra_hop``."""
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as hop_mod

    seen = []
    real = hop_mod.cagra_hop

    def spy(*args, **kwargs):
        q, nbrs, data, valid, itopk = args[0], args[4], args[5], args[6], args[7]
        width = args[8] if len(args) > 8 else kwargs.get("width", 1)
        ok = (nbrs >= 0) & (valid > 0)
        seen.append((torch.unique(nbrs[ok]).numel(), int(ok.sum()), q.shape[0], nbrs.shape[1],
                     int(width), data.shape[1], data.element_size(), int(itopk)))
        return real(*args, **kwargs)

    spy.__dict__.update(real.__dict__)    # the launch counters the launcher adds to
    hop_mod.cagra_hop = spy
    try:
        cagra.search(st.params, st.index, queries, st.k)
    finally:
        hop_mod.cagra_hop = real
    if not seen:
        return None
    nbytes = sum(roofline.cagra_hop_bytes(dr, m, cw, w, d, eb, it)
                 for dr, _, m, cw, w, d, eb, it in seen)
    ops = sum(roofline.cagra_hop_ops(vp, d) for _, vp, _, _, _, d, _, _ in seen)
    return nbytes, ops, len(seen)
