"""Warm-up: build and run the kernels a deployment will use before it serves.

Counterpart of raft_tpu/_warmup.py. On the port the first call of a shape
pays for what a later call does not: a kernel build (nvcc, or loading the
cached library), cuBLAS handle creation, the caching allocator's first
blocks.

- :func:`warmup` is the deploy-time build-and-search warm-up: run once per
  host (in a provisioning step, off the serving path) at the shapes you will
  build and search at, it points the kernel-build cache at ``cache_dir``
  (``config.enable_compilation_cache``), builds an index of the kind on
  random data (or a resample of a data sample) of the target shape on the
  card, searches it once at the target batch shape, and reports what each
  phase built. A second process on the host then loads every kernel from
  the cache.
- :func:`warm_buckets` runs a serving searcher once at every batch shape it
  will serve; the serve registry calls it from ``publish`` before the flip.

    import raft_tpu_torch
    raft_tpu_torch.warmup("ivf_pq", n=1_000_000, d=128)    # once, at deploy
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["warmup", "warm_buckets"]

_KINDS = ("brute_force", "ivf_flat", "ivf_pq", "cagra")
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


def _resample(gen: torch.Generator, sample: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, d) drawn with replacement from the sample's rows, on the
    sample's device: the warm-up data keeps the production data's cluster
    structure, repeating points when the sample is smaller than ``rows``."""
    idx = torch.randint(0, sample.shape[0], (rows,), generator=gen,
                        device=sample.device)
    return sample[idx]


def _random_rows(gen: torch.Generator, rows: int, d: int, dtype: str,
                 device) -> torch.Tensor:
    if dtype == "float32":
        return torch.rand((rows, d), generator=gen, device=device,
                          dtype=torch.float32)
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    return torch.randint(lo, hi, (rows, d), generator=gen, device=device,
                         dtype=torch.int32).to(_DTYPES[dtype])


def warmup(kind: str, n: int, d: int, *, k: int = 10, queries: int = 10_000,
           dtype: str = "float32", data=None, index_params=None,
           search_params=None, cache_dir: str | None = None, seed: int = 0,
           res=None) -> dict:
    """Build-and-search warm-up of one index kind at (n, d) build /
    (queries, d) search, on ``res``'s device (default: the default handle's,
    the card).

    Points the kernel-build cache at ``cache_dir`` (default: the
    repository's ``build/kernels/``; :func:`raft_tpu_torch.config.
    enable_compilation_cache`), builds the index on random data of the
    target shape drawn on the device by a ``torch.Generator`` seeded with
    ``seed``, runs one search of the target batch shape at EXACTLY ``k``,
    and returns the headline walls (``build_s`` / ``search_s`` /
    ``cache_dir``) and each phase's build attribution. Pass the
    ``index_params`` / ``search_params`` production uses: they decide which
    kernels (and which of their variants) run. Defaults per kind: IVF-Flat
    ``n_lists=1024`` and ``n_probes=8``; IVF-PQ ``n_lists=1024, pq_bits=4,
    pq_dim=min(64, d)`` with a bfloat16 LUT and ``n_probes=8``; CAGRA
    ``itopk_size=32``.

    ``dtype`` ("float32" | "int8" | "uint8") warms the byte-dataset paths.
    ``data`` (optional (r, d) array, any r) warms on a SAMPLE OF THE REAL
    DATA, resampled with replacement to the target shapes: the same kernels
    run, but the builds' own wall time is representative (uniform random
    data is the measured worst case of CAGRA's build). When ``data`` is
    int8 / uint8, ``dtype`` must agree (or be left at its default, which is
    then inferred from the sample). A bad sample fails before the cache
    directory moves.

    ``build`` / ``search`` each carry ``{wall_s, compile_s, trace_s,
    programs, cache_hits, cache_misses, program_compile_s}`` from
    :func:`raft_tpu_torch.obs.compile.attribution` (``attribution:
    "obs.compile"``): ``programs`` counts nvcc runs and ``cache_hits``
    cached libraries loaded, so a host whose cache already holds the
    kernels reports ``programs == 0``, and a process that already loaded
    them reports zero of both. Each wall ends with a wait on the card. A
    summary INFO line goes through the port's logger.
    """
    from .config import enable_compilation_cache, keep_tensors
    from .core.errors import expects
    from .core.logger import logger
    from .core.resources import default_resources
    from .obs import compile as obs_compile

    expects(kind in _KINDS, "unknown index kind %r (one of %s)", kind,
            ", ".join(_KINDS))
    expects(dtype in ("float32", "int8", "uint8"),
            "dtype must be 'float32', 'int8' or 'uint8', got %r", dtype)
    res = res or default_resources()
    sample = None
    if data is not None:
        # validate BEFORE the cache redirect below: a bad sample must fail
        # without re-pointing this process's build cache
        sample = (data if isinstance(data, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(data)))
        if sample.dtype == torch.float64:
            sample = sample.to(torch.float32)
        expects(sample.ndim == 2 and sample.shape[1] == d,
                "data sample must be (rows, %d), got %s", d,
                tuple(sample.shape))
        sdtype = str(sample.dtype).split(".")[-1]
        if sdtype in ("int8", "uint8") and dtype == "float32":
            dtype = sdtype  # infer byte kinds from the sample
        expects(sdtype == dtype,
                "data sample dtype %s must match dtype=%r", sdtype, dtype)
    dev = res.torch_device
    cache = enable_compilation_cache(cache_dir)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if sample is not None:
        sample = sample.to(dev)
        x = _resample(gen, sample, n)
        q = _resample(gen, sample, queries)
    else:
        x = _random_rows(gen, n, d, dtype, dev)
        q = _random_rows(gen, queries, d, dtype, dev)
    res.sync()

    t0 = time.perf_counter()
    with obs_compile.attribution() as build_attr:
        if kind == "brute_force":
            from .neighbors import brute_force

            idx = brute_force.BruteForce().build(x, res=res)
            searcher = lambda: idx.search(q, k)
        elif kind == "ivf_flat":
            from .neighbors import ivf_flat

            idx = ivf_flat.build(
                index_params or ivf_flat.IndexParams(n_lists=1024, seed=seed), x,
                res=res)
            searcher = lambda: ivf_flat.search(
                search_params or ivf_flat.SearchParams(n_probes=8), idx, q, k)
        elif kind == "ivf_pq":
            from .neighbors import ivf_pq

            idx = ivf_pq.build(
                index_params or ivf_pq.IndexParams(
                    n_lists=1024, pq_bits=4, pq_dim=min(64, d), seed=seed), x,
                res=res)
            # the caller's k, exactly: a pipeline that also searches a
            # refine-candidate width (k=40 feeding a refine to 10) warms
            # that width with a second call
            searcher = lambda: ivf_pq.search(
                search_params or ivf_pq.SearchParams(
                    n_probes=8, lut_dtype="bfloat16"), idx, q, k)
        else:  # cagra
            from .neighbors import cagra

            idx = cagra.build(index_params or cagra.IndexParams(seed=seed), x,
                              res=res)
            searcher = lambda: cagra.search(
                search_params or cagra.SearchParams(itopk_size=32), idx, q, k)
        res.sync()
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with obs_compile.attribution() as search_attr:
        with keep_tensors():
            _wait(searcher())
        res.sync()
    search_s = time.perf_counter() - t0

    def _phase(wall_s, rec) -> dict:
        return {
            "wall_s": round(wall_s, 2),
            **rec.summary(),
            "program_compile_s": [round(s, 3) for s in rec.program_compile_s],
        }

    out = {
        "build_s": round(build_s, 2), "search_s": round(search_s, 2),
        "cache_dir": cache, "attribution": "obs.compile",
        "build": _phase(build_s, build_attr),
        "search": _phase(search_s, search_attr),
    }
    logger.info(
        "warmup(%s, n=%d, d=%d, k=%d): build %.1fs (%.1fs compile over %d "
        "programs), search %.1fs (%.1fs compile), cache %d hits / %d misses "
        "at %s", kind, n, d, k, build_s, build_attr.compile_s,
        build_attr.programs, search_s, search_attr.compile_s,
        build_attr.cache_hits + search_attr.cache_hits,
        build_attr.cache_misses + search_attr.cache_misses, cache)
    return out
