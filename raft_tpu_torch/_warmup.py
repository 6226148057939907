"""Serving warm-up: run a searcher once at every batch shape it will serve.

Counterpart of raft_tpu/_warmup.py's :func:`warm_buckets`. On the port the
first call of a shape pays for what a later call does not: a kernel build
(nvcc, or loading the cached library), cuBLAS handle creation, the caching
allocator's first blocks. :func:`warm_buckets` pays all of them off the
serving path; the serve registry calls it from ``publish`` before the flip.

Not yet ported: ``warmup(kind, n, d)`` (raft_tpu/_warmup.py:126), the
deploy-time build-and-search warm-up, which waits for ``config`` and the
streamed builds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["warm_buckets"]

_DTYPES = {"float32": torch.float32, "int8": torch.int8, "uint8": torch.uint8}


def _random_queries(gen: torch.Generator, rows: int, d: int, dtype: str,
                    sample=None) -> torch.Tensor:
    if sample is not None:
        # rows resampled (with replacement) from the user's sample: the
        # warm calls see the real data distribution
        idx = torch.randint(0, sample.shape[0], (rows,), generator=gen)
        return sample[idx]
    if dtype == "float32":
        return torch.rand((rows, d), generator=gen, dtype=torch.float32)
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    return torch.randint(lo, hi, (rows, d), generator=gen).to(_DTYPES[dtype])


def _wait(out) -> None:
    """Wait for the card to finish the work that produced ``out``."""
    for a in out:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.current_stream(a.device).synchronize()
            return


def warm_buckets(searcher, *, dim: int, buckets, k: int = 10,
                 dtype: str = "float32", seed: int = 0,
                 sample=None) -> dict:
    """Warm one serving searcher at every batch-shape bucket.

    A micro-batched service flushes only the padded power-of-two shapes in
    ``buckets``, so running ``searcher(queries, k)`` once per bucket — with
    queries drawn in the index's own query ``dtype`` by a ``torch.Generator``
    seeded with ``seed`` — builds or loads every kernel the hot path will
    launch and pays every first-call cost there.

    ``sample`` (optional, (r, dim) in the serving query dtype) draws the
    bucket queries from real data instead of uniform noise: the same
    kernels, but data-dependent execution time (CAGRA's hop loop) becomes
    representative.

    Returns ``{bucket: {wall_s, compile_s, trace_s, programs, cache_hits,
    cache_misses}}`` from :func:`raft_tpu_torch.obs.compile.attribution`:
    ``programs`` counts nvcc runs and ``cache_hits`` cached libraries
    loaded, so a bucket whose kernels were ready reports zero of both.
    ``wall_s`` includes waiting for the card.
    """
    from .core.errors import expects
    from .obs import compile as obs_compile

    expects(dtype in _DTYPES,
            "dtype must be 'float32', 'int8' or 'uint8', got %r", dtype)
    if sample is not None:
        sample = (sample.cpu() if isinstance(sample, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(sample)))
        expects(sample.ndim == 2 and sample.shape[1] == dim,
                "warm sample must be (rows, %d), got %s", dim,
                tuple(sample.shape))
        expects(sample.dtype == _DTYPES[dtype],
                "warm sample dtype %s must match the serving dtype %s",
                str(sample.dtype).split(".")[-1], dtype)
    out = {}
    gen = torch.Generator().manual_seed(seed)
    for b in sorted(set(int(b) for b in buckets)):
        expects(b >= 1, "bucket sizes must be >= 1, got %d", b)
        q = _random_queries(gen, b, dim, dtype, sample=sample)
        t0 = time.perf_counter()
        with obs_compile.attribution() as rec:
            _wait(searcher(q, k))
        out[b] = {"wall_s": round(time.perf_counter() - t0, 3),
                  **rec.summary()}
    return out
