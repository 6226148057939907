"""The ``batched_searcher`` serving hook every index module returns.

Counterpart of raft_tpu/neighbors/_hooks.py. ``fn(queries, k) -> (distances,
ids)`` carries ``kind``, ``dim`` and ``query_dtype`` attributes, the surface
a serving layer dispatches and warms through; the contract (the attribute
set and the byte-dtype rule) lives here once, and each index module supplies
only the search closure. The port's hooks also carry ``device``, the
``torch.device`` the index lives on, where the serve staging uploads the
queries. A hook returns tensors under any ``config.set_output_as`` setting:
it is the serving layer's contract, and the serving layer converts nothing.
"""

from __future__ import annotations

from typing import Callable

from ..config import keep_tensors

__all__ = ["make_hook"]


def make_hook(search_fn: Callable, kind: str, dim: int,
              data_kind: str = "float32", device=None) -> Callable:
    """Wrap ``search_fn(queries, k)`` as a serving hook. ``data_kind`` is the
    index's storage contract: byte indexes ("int8" / "uint8") serve byte
    queries of the same dtype, everything else serves float32."""

    def fn(queries, k):
        with keep_tensors():
            return search_fn(queries, k)

    fn.kind = kind
    fn.dim = int(dim)
    fn.query_dtype = data_kind if data_kind in ("int8", "uint8") else "float32"
    fn.device = device
    return fn
