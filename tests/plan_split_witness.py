"""How an IVF-Flat build whose lists split compares with ``obs.mem.plan()``,
in the JAX package and in the PyTorch port, on the same configuration.

``plan()`` prices an IVF-Flat index at ``n_lists`` lists of the capacity
bound (``list_cap_target``); in the JAX package a list past the bound splits
into more lists of that capacity, which it does not count. The port's build
splits at ``_list_utils.priced_capacity`` instead, which holds the split
within 1.2x the price. Each package streams uniform uint8
rows (made from ``--seed`` with numpy, written to a raw file in a temporary
directory) through its own ``ChunkedReader`` into its own
``ivf_flat.build``, on the CPU, and prints one JSON line: the lists built of
the lists asked, the built index's bytes against ``plan()``'s
``index_bytes``, and the build's ledger peak against ``plan(streamed=True)``'s
``build_peak_bytes``.

    JAX_PLATFORMS=cpu python tests/plan_split_witness.py \\
        --rows 10000000 --dim 128 --packages jax

is the 10M x 128 cell of ``chip_smoke.py``'s phase 6 in the JAX package
(about 5 GB of host memory, a minute or two); ``--rows 2000000
--trainset-fraction 0.1`` keeps that cell's trainset (200k rows for 1,024
lists) at a fifth of the rows, small enough for both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _index_bytes(arrays) -> int:
    return int(sum(int(np.prod(a.shape)) * np.dtype(str(a.dtype).split(".")[-1]).itemsize
                   for a in arrays))


def build_jax(path, rows, dim, kw, chunk_rows):
    import jax

    from raft_tpu.core import chunked
    from raft_tpu.neighbors import ivf_flat
    from raft_tpu.obs import mem

    params = ivf_flat.IndexParams(**kw)
    reader = chunked.ChunkedReader.from_file(path, dtype=np.uint8, shape=(rows, dim),
                                             chunk_rows=chunk_rows)
    plan = mem.plan("ivf_flat", params, rows, dim, dtype="uint8", streamed=True,
                    chunk_rows=chunk_rows)
    base = mem.totals()["device_bytes"]
    mem.reset_peak()
    idx = ivf_flat.build(params, reader)
    jax.block_until_ready(jax.tree_util.tree_leaves(idx))
    peak = mem.totals()["device_peak_bytes"] - base
    return idx, plan, peak


def build_torch(path, rows, dim, kw, chunk_rows):
    from raft_tpu_torch.core import Resources, chunked
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import mem

    params = ivf_flat.IndexParams(**kw)
    reader = chunked.ChunkedReader.from_file(path, dtype=np.uint8, shape=(rows, dim),
                                             chunk_rows=chunk_rows)
    plan = mem.plan("ivf_flat", params, rows, dim, dtype="uint8", streamed=True,
                    chunk_rows=chunk_rows)
    base = mem.totals()["device_bytes"]
    mem.reset_peak()
    idx = ivf_flat.build(params, reader, res=Resources(device="cpu"))
    peak = mem.totals()["device_peak_bytes"] - base
    return idx, plan, peak


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-lists", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--trainset-fraction", type=float, default=0.02)
    ap.add_argument("--chunk-rows", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--packages", default="jax,torch")
    args = ap.parse_args(argv)
    kw = dict(n_lists=args.n_lists, kmeans_n_iters=args.iters,
              kmeans_trainset_fraction=args.trainset_fraction, seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.u8")
        mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=(args.rows, args.dim))
        rng = np.random.default_rng(args.seed)
        for s in range(0, args.rows, 1_000_000):
            e = min(s + 1_000_000, args.rows)
            mm[s:e] = rng.integers(0, 256, (e - s, args.dim), dtype=np.uint8)
        mm.flush()
        del mm
        for pkg in args.packages.split(","):
            t0 = time.perf_counter()
            idx, plan, peak = {"jax": build_jax, "torch": build_torch}[pkg](
                path, args.rows, args.dim, kw, args.chunk_rows)
            built = _index_bytes((idx.centers, idx.list_data, idx.list_ids, idx.list_norms,
                                  idx.list_sizes))
            print(json.dumps(dict(
                package=pkg, rows=args.rows, dim=args.dim, params=kw,
                chunk_rows=args.chunk_rows, n_lists_built=int(idx.list_data.shape[0]),
                capacity=int(idx.list_data.shape[1]), index_bytes=built,
                plan_index_bytes=plan["index_bytes"], ledger_peak_bytes=int(peak),
                plan_build_peak_bytes=plan["build_peak_bytes"],
                ledger_over_plan=peak / plan["build_peak_bytes"],
                seconds=time.perf_counter() - t0)), flush=True)
            del idx


if __name__ == "__main__":
    main()
