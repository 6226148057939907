#!/usr/bin/env python3
"""Run raft_tpu_torch on one NVIDIA GPU and check it, kernel by kernel and
end to end.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases 01  # build and kernel checks only
    python3 chip_smoke.py --phases 0124  # all but phase 3's timings
    python3 chip_smoke.py --out DIR    # where the profile tables go
                                       # (default build/profiles)

Phases, each printing JSON lines:
  0. the card (name, power limit, count), the kernels' build with nvcc (the
     ptxas report: registers, spills, static shared memory) and the
     tensor-core ``fused_knn`` kernel's tile plans at d=128, k in {1, 10,
     64} (queries a block, resident query tile, ring stages, dynamic shared
     memory, resident blocks, splits at the main shape);
  1. each kernel against its plain PyTorch version on the card, at the main
     paths' widths: ``fused_knn`` over 1,000,000 x 128 rows (2,048 queries;
     modes f32 (FFMA kernel) and f32x3 / bf16 / s8 (tensor-core kernel), l2
     with and without sqrt, ip, k in {1, 10, 64}, a keep-mask that keeps
     fewer than k rows, a ragged n, d = 126); the tensor-core modes also
     over d in {64, 70, 100, 128, 256, 1024} at 100,003 rows (m of 1 to
     2,047, ties from a repeated half of the dataset, underfill; s8 bit for
     bit, bf16 / f32x3 at 1e-5 and at d = 1024 within ``tc_rounding_bound``)
     and uint8 inner product and L2 through ``knn``, bit for bit against the
     CPU; ``bf16_split`` (f32x3's operand planes) bit for bit on values at
     the bf16 rounding point, subnormals, ±0, ±inf, NaN and 1M x 128 rows;
     ``topk`` bit for bit, ids and value bits, on a 10,000 x 100,003
     float32 matrix (k in {10, 64, 128, 256}, min and max, int64 payload ids
     at k=10) and on the index paths' narrow rows (10,000 and 128 rows x
     1,024, 10,176 and 16,384 columns, float32 / bfloat16 / float16, k in
     {10, 40, 193}), each with ties, infinities, clamped extremes, -0 and
     NaN planted, one row all NaN and one sorted; ``pq_scan`` bit for bit
     (pq4 at S=64 and S=128 with float32 and bfloat16 LUTs, split pq8 at
     S=32, S of 24 and 96, caps that are not a multiple of the block,
     repeated lists, 1,024 pairs over indexes of real size);
     ``pq_scan_topk`` bit for bit, values' bits and ids (the GPU tests'
     grid of 180 cases: pq4 and split pq8, float32 and bfloat16 LUTs, L2 and
     inner product, k in {1, 7, 40, 256}, 1, 3 and 8 probes, S of 24, 64
     and 128, with ties, holes, short lists and an underfilled query; the
     main tile, 128 queries x 8 probes of a 1,024-list index at cap 1,272,
     S=64, k=40; the CAGRA build's, S=128, k=193, 8 and 32 probes);
     ``cagra_hop`` bit for bit (2,048 queries over the 1M x 128 CAGRA set, itopk 32 and
     64, width 1 and 2, both merges, float32 and int8 rows, d of 100 and
     126, the prime call, -1 ids, invalid lanes and repeated ids);
  2. the main paths, each with the launch counts set to 0 just before it and
     read just after: ``BruteForce("sqeuclidean").build(x).search(q, k=10)``
     at 1M x 128 float32 (uniform data from seed 0, 10,000 queries from
     seed 1), checked against the plain version; ``knn`` on the same data
     with ``compute="bfloat16"``, ``compute="float32x3"`` and as int8 codes
     under the default compute, each batch launching the tensor-core kernel
     once (bf16 / f32x3 checked by recall@10 against the float32 answer,
     int8 bit for bit on 1,024 queries); ``select_k`` on a
     10,000 x 100,003 matrix; IVF-PQ at SIFT-1M's shape in the JAX
     package's regression configuration (bench.py:660-668): 1M x 128 float32
     from 1,000 Gaussian blobs, ``build(n_lists=1024, pq_bits=4, pq_dim=64)``,
     ``search(n_probes=8, lut_dtype="bfloat16")`` at k=40 for 10,000 queries,
     ``refine`` to k=10; checked against the plain scan (``scan_impl=
     "onehot"``) and for recall@10 against exact ground truth on 1,000
     queries, and profiled for one batch; the search must launch
     ``pq_scan_topk`` once per 128-query tile and ``topk`` never; the
     unfused kernel route (``pq_scan``, bias, mask, ``topk``) must give its
     ids and values exactly and is timed and profiled beside it, the plain
     select route (``select_impl="xla"``, which launches ``pq_scan``) too,
     and ``_pq_search`` is timed at query tiles of 128 and 1,024; on the same
     index, filtered searches (bitsets keeping 50% and 2% of the ids,
     seeded) launch ``pq_scan_topk`` once a tile and ``topk`` never, equal
     ``pq_scan_topk_plain`` bit for bit on two tiles, return kept ids only
     and answer as the plain-select route, an all-ones bitset gives the
     unfiltered answer exactly, and each is profiled beside an unfiltered
     search; ``scan_order="grouped"`` matches the tiled order except on
     rows that tie within 1e-5; the blob set as int8 and as uint8 rows is
     built, searched and refined (recall@10 against the stored bytes'
     exact neighbours, floor 0.85; the select routes equal); per-cluster,
     scale-normed and OPQ + anisotropic + 4-bit fast-scan builds (the last
     searched through the funnel at ``funnel_widen=4``) print build
     seconds, QPS and recall@10 with the select routes equal; and CAGRA
     in the JAX package's
     ``cagra_1m_itopk32`` row (bench.py:3242-3260, data bench.py:527-552):
     1M x 128 float32 around 2,000 centers uniform in [0, 10) with N(0, 0.5^2)
     noise (seeds 20-22), ``cagra.build(IndexParams())`` and
     ``search(SearchParams(itopk_size=32))`` at k=10 for 10,000 queries;
     checked for graph validity, recall@10 against exact ground truth and
     against the ``hop_impl="xla"`` route on 1,000 queries, and profiled for
     one batch. On both indexes the plain top-k route (``select_impl=
     "xla"``; for CAGRA the wide-select threshold pinned above every row)
     must give the routed search's ids and values exactly, and is timed and
     profiled beside it in the same run; CAGRA's byte build on that set
     scaled into int8 (``search`` running ``cagra_hop`` over int8 rows,
     recall@10 against the stored bytes' exact neighbours, floor 0.95, the
     kernel route against ``hop_impl="xla"`` by overlap and recall);
     IVF-Flat in the JAX package's ``ivf_flat_1m_p8`` row (bench.py:3221-3239,
     the CAGRA set): ``build(IndexParams(n_lists=1024, seed=0))`` and
     ``search(SearchParams(n_probes=8))`` at k=10 for 10,000 queries,
     profiled for one batch; recall@10 against exact ground truth on 1,000
     queries (floor 0.99); the plain top-k route (threshold pinned above
     every row) gives equal ids and values; the search launches ``topk``
     as often as its tile plan says (tiles x chunks, plus the coarse
     select) and ``fused_knn`` never; a filter that drops half the ids on
     both routes; bfloat16 lists (recall floor 0.98 against the exact
     neighbours of the rows they store) and int8 lists (100,000
     rows, both routes equal); then the rest of the slice against float64
     or the port's plain route: every pairwise metric at 2,048 x 16,384 x
     128, ``knn(metric="l1")`` over the 1M set on both select routes,
     ``masked_l2_nn`` and ``gram_matrix`` (four kernel types) at 10,000 x
     100,000 x 128, ``eps_neighbors_l2sq``, and ``kmeans.fit`` at 100,000 x
     128 from ``init="array"`` against the same call on the CPU; the random
     ball cover over 1,000,000 x 3 uniform rows (sqeuclidean) and 1,000,000
     (lat, lon) points (haversine), 10,000 queries, k=10, against exact
     ``knn`` in the same metric; the 16 ``matrix.ops`` functions on the card
     against the CPU;
  3. ``fused_knn``'s bf16, f32x3 and s8 modes timed at the f32 row's shape
     beside their tensor-core bounds, their plain version and one library
     call each (and at k = 1 and 64), with ``knn``'s QPS in each mode and
     the cost of f32x3's bf16 planes (``bf16_split``); kernel
     times (CUDA events) beside their bound, their plain version's
     time and one library call's time (for ``cagra_hop``, which no single
     PyTorch call computes, the ``"xla"`` hop body's time instead; for
     ``pq_scan_topk`` also the unfused kernel route's time and its time
     under the 50% filter, whose bound gains the bitset's bytes); and a
     sweep of ``topk`` against the plain route and ``torch.topk`` over
     10,000 and 128 rows, 1,024 to 100,003 columns and k in {10, 32, 40,
     193}, with the crossover it gives beside ``WIDE_SELECT_COLS_DEFAULT``;
  4. ``raft_tpu_torch.serve`` on phase 2's indexes (run after phase 2, before
     phase 3's timings): the serve path's kernels at its small shapes
     against their plain versions (``fused_knn`` at m = 1 and 64 over the
     1M set, ``pq_scan_topk`` on one query and on 64, the entry-pool
     ``topk`` at m = 1 and 64, ``cagra_hop`` at m = 1); the JAX package's
     serving row (bench.py:733-869): the IVF-PQ + refine hook (4k
     candidates refined to k=10) behind ``SearchService(max_batch=64,
     max_wait_us=2000)``, 8 threads x 400 one-row requests, a second
     IVF-PQ build published at mid-load, with ``pipeline_depth`` 2 and 0,
     against the same hook called one row at a time; then brute force,
     IVF-Flat and CAGRA (itopk 32) published on the running service, 400
     requests each, and 20 full 64-row buckets back to back. Every request
     must be answered, no kernel built in a loaded window, each served
     row equal (``knn_equiv`` at 1e-5) to the serving index's direct
     search at the shape that served it (CAGRA: recall@10 >= 0.95), IVF-PQ
     + refine recall@10 >= 0.85, and the memory ledger's bytes for the
     second build within 10% of its allocation delta. Prints QPS, p50 /
     p99, occupancy, host syncs (``torch.cuda.set_sync_debug_mode``),
     device ms and launches a flush for each index kind.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

H100_F32_FLOPS = 67e12   # float32 on CUDA cores, H100 SXM data sheet
H100_BYTES_S = 3.35e12   # HBM3, H100 SXM data sheet

N_MAIN, D_MAIN, M_MAIN, K_MAIN = 1_000_000, 128, 10_000, 10
TOPK_SHAPE = (10_000, 100_003)
PQ_LISTS, PQ_CAP = 1024, 1272   # a 1M-row, 1,024-list index bounded at 1.3x the mean list
IVF_BLOBS, IVF_Q, IVF_K0, IVF_CHECK = 1_000, 10_000, 40, 1_000
IVF_RECALL_FLOOR = 0.85         # recall@10 after refine; the card's first run read 0.9153
CAGRA_CENTERS, CAGRA_Q, CAGRA_CHECK, HOP_M = 2_000, 10_000, 1_000, 2_048
CAGRA_ITOPK = 32
SWEEP_ROWS = (10_000, 128)      # a 10k-query batch; the IVF-PQ query tile
SWEEP_COLS = (1_024, 4_096, 10_176, 16_384, 32_768, 65_536, 100_003)
SWEEP_K = (10, 32, 40, 193)     # select_k; the CAGRA pool; IVF-PQ's k0; the CAGRA build
CAGRA_RECALL_FLOOR = 0.95       # recall@10 at itopk 32; the card's first full run read 0.9725
IVF_FLAT_LISTS, IVF_FLAT_PROBES, IVF_FLAT_CHECK = 1024, 8, 1_000
IVF_FLAT_RECALL_FLOOR = 0.99    # recall@10 of ivf_flat_1m_p8; an algorithm's property
IVF_FLAT_BF16_FLOOR = 0.98      # bfloat16 lists, against the stored rows' exact neighbours
INT8_ROWS, INT8_LISTS = 100_000, 256
PAIR_M, PAIR_N = 2_048, 16_384  # the pairwise-metric checks
SLICE_N = 100_000               # masked_l2_nn, gram_matrix, eps_neighbors, kmeans rows
KMEANS_K, KMEANS_ITERS = 256, 20
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, H100 SXM data sheet
H100_INT8_OPS = 1979e12         # dense int8 tensor cores, H100 SXM data sheet
FILTER_KEEP = (0.5, 0.02)       # shares of the ids the filtered IVF-PQ searches keep
BYTE_SCALE = 12.0               # the IVF-PQ blob set as bytes: round(12 x) (+128 for uint8)
SERVE_THREADS, SERVE_PER_THREAD, SERVE_SEQ = 8, 400, 512   # bench.py:733 _row_serve
SERVE_MAX_BATCH, SERVE_WAIT_US = 64, 2000.0
SERVE_OTHER_THREADS, SERVE_OTHER_PER_THREAD = 4, 100       # brute force, IVF-Flat, CAGRA
SERVE_CHECK = 1_000              # served rows held against a direct search
LEDGER_TOL = 0.10                # ledger bytes against the build's allocation delta


def emit(**kw):
    print(json.dumps(kw), flush=True)


def knn_equiv(dv, di, rd, ri, rtol, atol):
    """Distances agree within tolerance; ids agree except where two rows'
    distances tie within that tolerance. Returns the max abs error."""
    import torch

    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(dv)), "underfill slots differ"
    assert torch.equal(dv[~fin], rd[~fin]), "underfill values differ"
    assert torch.allclose(dv[fin], rd[fin], rtol=rtol, atol=atol), (
        f"distances differ: max abs err {float((dv[fin] - rd[fin]).abs().max())}")
    bad = (di != ri).any(dim=1).nonzero().flatten().tolist()
    for r in bad:
        same_set = set(di[r].tolist()) == set(ri[r].tolist())
        assert same_set or torch.allclose(torch.sort(dv[r]).values,
                                          torch.sort(rd[r]).values,
                                          rtol=rtol, atol=atol), f"row {r} ids differ"
    return float((dv[fin] - rd[fin]).abs().max()) if fin.any() else 0.0


def cuda_ms(fn, reps=3, warm=1):
    """Device milliseconds per call of ``fn`` (CUDA events). The timed calls
    are queued behind a ~0.1 s device-side wait, so they run back to back and
    the host's launch cost (tens of microseconds a call, more than a short
    kernel takes) does not show; ``fn`` must not synchronise."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_build(st):
    import torch

    from raft_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    st["card"] = smi.splitlines()[0]
    emit(phase="card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    t0 = time.perf_counter()
    secs = _build.build_all()
    report = {}
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.report(name).splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        report[name] = lines
    emit(phase="build", seconds=round(time.perf_counter() - t0, 2),
         per_source=secs, ptxas=report)
    from raft_tpu_torch.ops.fused_knn import _INSERT_TILES, _nsplit, fused_knn_config

    for mode in ("bf16", "f32x3", "s8"):
        for k in (1, 10, 64):
            c = fused_knn_config(mode, D_MAIN, k)
            emit(phase="plan", kernel="fused_knn_tc", mode=mode, d=D_MAIN, k=k,
                 nsplit_main=_nsplit(M_MAIN, N_MAIN, c["qt"], c["slots"], c["nb"],
                                     _INSERT_TILES * k), **c)


def phase_kernels(st):
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((N_MAIN + 3, D_MAIN), generator=g, device=dev)
    q = torch.rand((2048, D_MAIN), generator=g, device=dev)
    xs8 = torch.randint(-128, 128, (N_MAIN, D_MAIN), generator=g, device=dev,
                        dtype=torch.int8)
    qs8 = torch.randint(-128, 128, (2048, D_MAIN), generator=g, device=dev,
                        dtype=torch.int8)
    few = torch.zeros(N_MAIN, dtype=torch.bool, device=dev)
    few[torch.randperm(N_MAIN, generator=g, device=dev)[:5]] = True
    cases = [
        dict(mode="f32", metric="l2", k=10),
        dict(mode="f32", metric="l2", k=10, sqrt=True),
        dict(mode="f32", metric="ip", k=10),
        dict(mode="f32", metric="l2", k=1),
        dict(mode="f32", metric="l2", k=64),
        dict(mode="f32x3", metric="l2", k=10),
        dict(mode="bf16", metric="l2", k=10),
        dict(mode="bf16", metric="ip", k=64),
        dict(mode="f32", metric="l2", k=10, keep_mask=few),
        dict(mode="f32", metric="l2", k=10, ragged=True),
        dict(mode="f32", metric="l2", k=10, narrow=True),   # d=126: padded to 128
        dict(mode="s8", metric="l2", k=10),
        dict(mode="s8", metric="ip", k=64),
        dict(mode="s8", metric="l2", k=10, sqrt=True, keep_mask=few),
        # the tensor-core modes at the main width: k 1 and 64, sqrt, ip, a
        # filter that keeps 5 rows, a ragged n, d = 126 (padded to 128)
        dict(mode="bf16", metric="l2", k=1),
        dict(mode="bf16", metric="l2", k=10, sqrt=True, keep_mask=few),
        dict(mode="bf16", metric="l2", k=10, ragged=True),
        dict(mode="bf16", metric="l2", k=10, narrow=True),
        dict(mode="f32x3", metric="ip", k=64),
        dict(mode="f32x3", metric="l2", k=1, sqrt=True),
        dict(mode="f32x3", metric="l2", k=10, keep_mask=few),
        dict(mode="f32x3", metric="l2", k=10, ragged=True),
        dict(mode="f32x3", metric="l2", k=10, narrow=True),
        dict(mode="s8", metric="l2", k=1),
    ]
    err = {"fused_knn": 0.0, "fused_knn_tc": 0.0}
    for c in cases:
        c = dict(c)
        kernel = "fused_knn" if c["mode"] == "f32" else "fused_knn_tc"
        ragged, narrow = c.pop("ragged", False), c.pop("narrow", False)
        k = c.pop("k")
        if c["mode"] == "s8":
            ds, qq = xs8, qs8
            if ragged:
                ds = ds[:N_MAIN - 5]
        elif narrow:
            ds, qq = x[:N_MAIN, :126], q[:, :126]
        else:
            ds, qq = (x if ragged else x[:N_MAIN]), q
        dv, di = fused_knn(ds, qq, k, **c)
        torch.cuda.synchronize()
        rd, ri = fused_knn_plain(ds, qq, k, **c)
        if c["mode"] == "s8":
            assert torch.equal(dv, rd) and torch.equal(di, ri), f"s8 differs: {c}"
            e = 0.0
        else:
            e = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
        err[kernel] = max(err[kernel], e)
        if "keep_mask" in c:
            assert bool((di[:, 5:] == -1).all()), "underfill ids are not -1"
        emit(phase="check", kernel=kernel, n=ds.shape[0], d=ds.shape[1],
             m=qq.shape[0], k=k, mode=c["mode"], metric=c["metric"], sqrt=c.get("sqrt", False),
             keep_mask="keep_mask" in c, max_abs_err=e, ok=True)
    st["fused_err"], st["tc_err"] = err["fused_knn"], err["fused_knn_tc"]
    del x, q, xs8, qs8
    check_tc_edges(st, g)
    check_split(g)

    m, n = TOPK_SHAPE
    v = torch.rand(TOPK_SHAPE, generator=g, device=dev)
    plant_topk_rows(v, g)
    ids = torch.randint(0, 1 << 30, TOPK_SHAPE, generator=g, device=dev)
    for k in (10, 64, 128, 256):
        for smin in (True, False):
            check_topk(v, k, smin, ids if k == 10 else None)
            emit(phase="check", kernel="topk", shape=list(TOPK_SHAPE), k=k,
                 select_min=smin, payload=k == 10, nan_rows=True, max_abs_err=0.0,
                 bit_equal=True, ok=True)
    del v, ids
    # the index paths' narrow rows: the IVF-PQ tile (128 rows), the CAGRA
    # entry pool's 16,384 columns, each float type
    for rows, n, dt in [(r, c, t) for r in (10_000, 128) for c in (1_024, 10_176, 16_384)
                        for t in (torch.float32, torch.bfloat16, torch.float16)]:
        v = torch.rand((rows, n), generator=g, device=dev)
        plant_topk_rows(v, g)
        v = v.to(dt)
        for k in (10, 40, 193):
            for smin in (True, False):
                check_topk(v, k, smin)
        emit(phase="check", kernel="topk", shape=[rows, n], dtype=str(dt).split(".")[1],
             k=[10, 40, 193], select_min=[True, False], nan_rows=True, max_abs_err=0.0,
             bit_equal=True, ok=True)
    err = 0.0
    st["topk_err"] = err
    phase_pq_kernel(st)
    phase_pq_topk_kernel(st)
    phase_hop_kernel(st)


def check_split(g):
    """``bf16_split`` (f32x3's operand planes) against its plain version,
    value bits compared: values at and around the bf16 rounding point,
    subnormals, ±0, ±inf, NaN, a length that is not a multiple of four, and
    the main path's 1M x 128 rows."""
    import numpy as np
    import torch

    from raft_tpu_torch.ops.fused_knn import bf16_split, bf16_split_plain

    rng = np.random.default_rng(11)
    base = rng.integers(0x00800000, 0x7F000000, 4096, dtype=np.uint32) & 0xFFFF0000
    lows = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    bits = (base[:, None] | lows[None, :]).ravel()
    bits |= rng.integers(0, 2, bits.size, dtype=np.uint32) << 31
    special = np.array([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x00008000, 0x00018000,
                        0x807F8000, 0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000],
                       np.uint32)
    edge = torch.from_numpy(np.concatenate([bits, special]).view(np.float32)).cuda()
    dev = torch.device("cuda")
    for name, t in (("edge values", edge), ("odd length", edge[:-3]),
                    ("1M x 128 uniform", torch.rand((N_MAIN, D_MAIN), generator=g, device=dev)),
                    ("normal x 1e3", torch.randn((4097, 100), generator=g, device=dev) * 1e3)):
        hi, lo = bf16_split(t)
        torch.cuda.synchronize()
        ph, pl = bf16_split_plain(t)
        same = (torch.equal(hi.view(torch.int16), ph.view(torch.int16))
                and torch.equal(lo.view(torch.int16), pl.view(torch.int16)))
        assert same, f"bf16_split differs on {name}"
        emit(phase="check", kernel="bf16_split", values=name, n=t.numel(),
             bit_equal=True, ok=True)


# (d, m, n, k, metric, extra) of the tensor-core modes' edge sweep: every d
# of the fused gate's sweep, m not a multiple of the query tile, n ragged
# against the tile and the split, k of 1 / 10 / 64, l2 / ip / sqrt, a filter
# that keeps fewer than k rows, and a dataset whose second half repeats its
# first (ties must go to the lower row)
TC_EDGES = [
    (64, 1, 100_003, 1, "ip", None),
    (70, 300, 100_003, 10, "l2", None),
    (70, 65, 100_003, 64, "l2", "sqrt"),
    (100, 1000, 100_003, 10, "ip", None),
    (100, 300, 100_003, 10, "l2", "underfill"),
    (128, 2047, 100_006, 10, "l2", "ties"),
    (128, 65, 4099, 64, "ip", None),
    (256, 300, 100_003, 64, "ip", None),
    (256, 1000, 100_003, 1, "l2", "sqrt"),
    (1024, 300, 100_003, 10, "l2", None),
]


def check_tc_edges(st, g):
    """``fused_knn``'s tensor-core modes over TC_EDGES against the plain
    version: s8 bit for bit; bf16 and f32x3 by knn_equiv at rtol = atol =
    1e-5, and at d = 1024 within ``tc_rounding_bound`` (wgmma truncates its
    float32 sums; the largest error and its row are printed). Then uint8
    inner products and L2 through ``knn``, bit for bit against the CPU."""
    import numpy as np
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain, tc_rounding_bound

    dev = torch.device("cuda")
    saved = fused_knn.launches, dict(fused_knn.launches_by_mode)
    err = 0.0
    for mode in ("bf16", "f32x3", "s8"):
        for d, m, n, k, metric, extra in TC_EDGES:
            if mode == "s8":
                x = torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
                q = torch.randint(-128, 128, (m, d), generator=g, device=dev, dtype=torch.int8)
            else:
                x = torch.rand((n, d), generator=g, device=dev)
                q = torch.rand((m, d), generator=g, device=dev)
            kw = dict(metric=metric, mode=mode)
            if extra == "ties":
                x[n // 2:] = x[:n // 2].clone()
            if extra == "sqrt":
                kw["sqrt"] = True
            if extra == "underfill":
                keep = torch.zeros(n, dtype=torch.bool, device=dev)
                keep[torch.randperm(n, generator=g, device=dev)[:5]] = True
                kw["keep_mask"] = keep
            before = dict(fused_knn.launches_by_mode)
            dv, di = fused_knn(x, q, k, **kw)
            torch.cuda.synchronize()
            assert fused_knn.launches_by_mode == dict(before, **{mode: before[mode] + 1})
            rd, ri = fused_knn_plain(x, q, k, **kw)
            case = dict(mode=mode, d=d, m=m, n=n, k=k, metric=metric, extra=extra)
            tol = "1e-5"
            if mode == "s8":
                assert torch.equal(dv, rd) and torch.equal(di, ri), f"s8 differs: {case}"
                e = 0.0
            elif d > 256:
                bound = tc_rounding_bound(x, q, ri, metric, mode)
                ad = (dv - rd).abs()
                e = float(ad.max())
                row = int(ad.max(dim=1).values.argmax())
                assert bool((ad <= 1e-5 + 1e-5 * rd.abs() + bound).all()), f"beyond bound: {case}"
                knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5 + float(bound.max()))
                tol = (f"1e-5 + tc_rounding_bound (max {float(bound.max()):.3g}); "
                       f"worst row {row}, err/bound {float((ad / bound.clamp_min(1e-30)).max()):.3g}, "
                       f"err/|d| {float((ad / rd.abs().clamp_min(1e-30)).max()):.3g}")
            else:
                e = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
            if extra == "underfill":
                assert bool((di[:, 5:] == -1).all()), "underfill ids are not -1"
            if extra == "ties":
                half = n // 2
                # each repeated row ranks right behind its first copy
                for r in range(m):
                    ids = di[r].tolist()
                    for j, i in enumerate(ids):
                        if i >= half:
                            assert i - half in ids[:j], (r, ids)
            err = max(err, e)
            emit(phase="check", kernel="fused_knn_tc", tolerance=tol, max_abs_err=e,
                 ok=True, **case)
            del x, q
    rng = np.random.default_rng(3)
    xu = rng.integers(0, 256, (100_003, 96), dtype=np.uint8)
    qu = rng.integers(0, 256, (1000, 96), dtype=np.uint8)
    for metric in ("inner_product", "sqeuclidean"):
        before = fused_knn.launches_by_mode["s8"]
        kd, ki = knn(xu, qu, 10, metric=metric, res=Resources(device="cuda"))
        torch.cuda.synchronize()
        assert fused_knn.launches_by_mode["s8"] == before + 1
        cd, ci = knn(xu, qu, 10, metric=metric, res=Resources(device="cpu"))
        assert torch.equal(kd.cpu(), cd) and torch.equal(ki.cpu(), ci), metric
        emit(phase="check", kernel="fused_knn_tc", path=f"knn uint8 {metric}", n=100_003,
             d=96, m=1000, k=10, bit_equal_to_cpu=True, ok=True)
    st["tc_err"] = max(st["tc_err"], err)
    fused_knn.launches, fused_knn.launches_by_mode = saved[0], saved[1]


def plant_topk_rows(v, g):
    """Plant ties, infinities, clamped extremes, -0 and NaN in rows of ``v``
    (in place), a tenth of the rows each; one row all NaN, one sorted."""
    import torch

    m, n = v.shape
    rows = torch.arange(m, device=v.device)[:, None]
    cols = torch.randint(0, n, (m, min(n, 300)), generator=g, device=v.device)
    t = max(1, m // 10)
    part = [slice(i * t, (i + 1) * t) for i in range(7)]
    v[rows[part[0]], cols[part[0]]] = 0.0                  # ties among the smallest
    v[rows[part[1]], cols[part[1]]] = 1.0                  # ties among the largest
    v[rows[part[2]], cols[part[2], :40]] = float("inf")
    v[rows[part[2]], cols[part[2], 40:80]] = float("-inf")
    v[rows[part[3]], cols[part[3], :40]] = 3.1e38          # clamps to 2.9e38
    v[rows[part[3]], cols[part[3], 40:80]] = -3.3e38
    v[rows[part[4]], cols[part[4], :40]] = float("nan")
    v[rows[part[4]], cols[part[4], 40:80]] = -float("nan")
    v[rows[part[5]], cols[part[5], :100]] = -0.0
    v[rows[part[6]], cols[part[6], :100]] = float("nan")
    v[rows[part[6]], cols[part[6], 100:]] = -0.0
    v[-1] = float("nan")
    v[-2] = torch.sort(v[-2], descending=True).values


def check_topk(v, k, smin, ids=None):
    """``topk`` (one launch: values, ids) against ``topk_plain`` on the card,
    bit for bit: ids, and the values' bits (NaN included)."""
    import torch

    from raft_tpu_torch.ops.topk import topk, topk_plain

    before = topk.launches
    ov, oi = topk(v, k, select_min=smin, in_idx=ids)
    torch.cuda.synchronize()
    assert topk.launches == before + 1, "topk did not launch once"
    pv, pi = topk_plain(v, k, select_min=smin)
    if ids is not None:
        pi = torch.gather(ids, 1, pi.long()).to(torch.int32)
    as_int = torch.int32 if v.element_size() == 4 else torch.int16
    same_i = torch.equal(oi, pi)
    same_v = torch.equal(ov.view(as_int), pv.view(as_int))
    assert same_i and same_v, (
        f"topk differs from topk_plain: shape {tuple(v.shape)} {v.dtype} k={k} "
        f"min={smin}; rows {(oi != pi).any(1).nonzero().flatten()[:5].tolist()}")


def phase_pq_kernel(st):
    """``pq_scan`` against ``pq_scan_plain`` on the card, bit for bit."""
    import torch

    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    n_lists, cap = PQ_LISTS, PQ_CAP
    cases = [   # (S, split, lut dtype, lists, cap, pairs, probes, code range)
        (64, False, torch.float32, n_lists, cap, 1024, "random", 16),
        (64, False, torch.bfloat16, n_lists, cap, 1024, "random", 16),
        (32, True, torch.float32, n_lists, cap, 1024, "random", 256),
        (32, True, torch.bfloat16, n_lists, cap, 1024, "random", 256),
        (24, False, torch.float32, 64, 1000, 256, "random", 16),
        (24, True, torch.bfloat16, 64, 1000, 256, "random", 256),
        (96, False, torch.bfloat16, 64, 777, 300, "random", 16),
        (64, False, torch.bfloat16, n_lists, cap, 1024, "repeated", 16),
        (32, True, torch.float32, n_lists, cap, 1024, "repeated", 256),
        (64, False, torch.float32, 64, 1000, 256, "random", 256),   # stray bytes: & 15
        (128, False, torch.float32, 1000, 1300, 1024, "random", 16),  # the CAGRA build's
    ]
    for s, split, dt, nl, cp, pairs, how, hi in cases:
        codes = torch.randint(0, hi, (nl, cp, s), generator=g, device=dev,
                              dtype=torch.uint8)
        top = 4 if how == "repeated" else nl
        probes = torch.randint(0, top, (pairs,), generator=g, device=dev,
                               dtype=torch.int32)
        if how == "repeated":
            probes[: pairs // 2] = 1
        lut = (torch.randn((pairs, s, 32 if split else 16), generator=g, device=dev)
               * 50.0).to(dt)
        before = pq_scan.launches
        got = pq_scan(codes, probes, lut, split=split)
        torch.cuda.synchronize()
        assert pq_scan.launches == before + 1, "pq_scan did not launch"
        want = pq_scan_plain(codes, probes, lut, split=split)
        assert torch.equal(got, want), (
            f"pq_scan differs from its plain version: S={s} split={split} {dt} "
            f"max abs err {float((got - want).abs().max())}")
        emit(phase="check", kernel="pq_scan", n_lists=nl, cap=cp, S=s, split=split,
             lut_dtype=str(dt).split(".")[1], pairs=pairs, probes=how,
             code_range=hi, max_abs_err=0.0, bit_equal=True, ok=True)
    st["pq_err"] = 0.0


def pq_topk_case(g, n_lists, cap, s, t, pc, split, dt, inner, top):
    """Inputs of ``pq_scan_topk`` on the card: lists with holes and short
    fills, list 0 empty, query 0's probes all on list 0 but one (fewer
    filled slots than k), a duplicated code row probed twice by query 1 with
    equal LUTs and biases (ties across probes and within a list)."""
    import torch

    dev = torch.device("cuda")
    kk = 32 if split else 16
    codes = torch.randint(0, 256 if split else 16, (n_lists, cap, s), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[2, 9] = codes[2, 5]
    codes[3, 0] = codes[2, 5]
    size = cap - (torch.arange(n_lists, device=dev)[:, None] * 37) % (cap // 3 + 1)
    ids = torch.randperm(n_lists * cap, generator=g, device=dev).to(torch.int32)
    ids = torch.where(torch.arange(cap, device=dev)[None, :] < size,
                      ids.reshape(n_lists, cap), -1)
    ids[1::7, ::5] = -1
    ids[0] = -1
    probes = torch.randint(1, top, (t, pc), generator=g, device=dev, dtype=torch.int32)
    lut = torch.randn((t, pc, s, kk), generator=g, device=dev) * 20
    bias = torch.randn((t, pc), generator=g, device=dev) * 100
    probes[0] = 0
    probes[0, -1] = 5
    probes[1, 0] = 2
    if pc > 1:
        probes[1, 1] = 3
        lut[1, 1] = lut[1, 0]
        bias[1, 1] = bias[1, 0]
    consts = None
    if split and not inner:
        consts = torch.randn((n_lists, cap), generator=g, device=dev) * 5
        consts[2, 9] = consts[3, 0] = consts[2, 5]
    return codes, ids, probes.contiguous(), lut.to(dt).contiguous(), bias, consts


def phase_pq_topk_kernel(st):
    """``pq_scan_topk`` against ``pq_scan_topk_plain`` on the card, bit for
    bit (values' bits and ids): the GPU tests' grid (pq4 and split pq8, f32
    and bf16 LUTs, L2 and inner product, k in {1, 7, 40, 256}, pc in {1, 3,
    8}, S of 24, 64 and 128), the main tile (128 queries x 8 probes of a
    1,024-list index, cap 1,272, S=64, bf16, k=40) and the CAGRA build's
    (1,000 lists, cap 1,300, S=128, f32, k=193, pc 8 and 32)."""
    import torch

    from raft_tpu_torch.ops.pq_scan import pq_scan_topk, pq_scan_topk_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    grid = [dict(n_lists=40, cap=300, s=s, t=16, pc=pc, split=split, dt=dt, inner=inner,
                 top=40, k=k)
            for split, dt, inner in ((False, torch.float32, False),
                                     (False, torch.bfloat16, True),
                                     (True, torch.float32, False),
                                     (True, torch.bfloat16, False),
                                     (True, torch.float32, True))
            for s in (24, 64, 128) for pc in (1, 3, 8) for k in (1, 7, 40, 256)]
    main = [dict(n_lists=PQ_LISTS, cap=PQ_CAP, s=64, t=128, pc=8, split=False,
                 dt=torch.bfloat16, inner=False, top=300, k=40),
            dict(n_lists=1000, cap=1300, s=128, t=128, pc=8, split=False,
                 dt=torch.float32, inner=False, top=1000, k=193),
            dict(n_lists=1000, cap=1300, s=128, t=128, pc=32, split=False,
                 dt=torch.float32, inner=False, top=1000, k=193)]
    for n, c in enumerate(grid + main):
        c = dict(c)
        k, inner = c.pop("k"), c["inner"]
        codes, ids, probes, lut, bias, consts = pq_topk_case(g, **c)
        before = pq_scan_topk.launches
        v, i = pq_scan_topk(codes, ids, probes, lut, bias, k, not inner, split=c["split"],
                            list_consts=consts)
        torch.cuda.synchronize()
        assert pq_scan_topk.launches == before + 1, "pq_scan_topk did not launch"
        pv, pi = pq_scan_topk_plain(codes, ids, probes, lut, bias, k, not inner, c["split"],
                                    consts)
        same_v = torch.equal(v.view(torch.int32), pv.view(torch.int32))
        assert same_v and torch.equal(i, pi), (
            f"pq_scan_topk differs from its plain version: {c} k={k}; rows "
            f"{(i != pi).any(1).nonzero().flatten()[:5].tolist()}")
        if n >= len(grid) or (k == 256 and c["pc"] == 8 and c["s"] == 64):
            emit(phase="check", kernel="pq_scan_topk", n_lists=c["n_lists"], cap=c["cap"],
                 S=c["s"], T=c["t"], pc=c["pc"], k=k, split=c["split"],
                 lut_dtype=str(c["dt"]).split(".")[1], inner_product=inner,
                 underfilled_rows=int((i == -1).any(1).sum()), max_abs_err=0.0,
                 bit_equal=True, ok=True)
    emit(phase="check", kernel="pq_scan_topk", grid_cases=len(grid), main_cases=len(main),
         max_abs_err=0.0, bit_equal=True, ok=True)
    st["pq_topk_err"] = 0.0


def hop_candidates(beam_i, lq, lx, cw, g):
    """(m, cw) candidate ids: half from each query's own cluster (they beat
    a random beam and get merged), half uniform; with a beam id, a repeat
    within the row and a -1 planted."""
    import torch

    m, dev = beam_i.shape[0], beam_i.device
    order = torch.argsort(lx)
    counts = torch.bincount(lx, minlength=CAGRA_CENTERS)
    starts = torch.cumsum(counts, 0) - counts
    pos = starts[lq][:, None] + (torch.rand((m, cw), generator=g, device=dev)
                                 * counts[lq][:, None]).long()
    near = order[pos]
    far = torch.randint(0, lx.shape[0], (m, cw), generator=g, device=dev)
    nbrs = torch.where(torch.rand((m, cw), generator=g, device=dev) < 0.5, near, far)
    nbrs = nbrs.to(torch.int32)
    nbrs[::2, 0] = beam_i[::2, 1]
    nbrs[::3, 1] = nbrs[::3, 2]
    nbrs[::4, 3] = -1
    return nbrs.contiguous()


HOP_CASES = [   # (itopk, width, merge, rows, d)
    (32, 1, "extract", "f32", 128), (32, 1, "arena", "f32", 128),
    (32, 2, "extract", "f32", 128), (32, 2, "arena", "f32", 128),
    (64, 1, "arena", "f32", 128), (64, 2, "extract", "f32", 128),
    (64, 2, "arena", "f32", 128), (32, 1, "arena", "int8", 128),
    (64, 2, "extract", "int8", 128), (32, 1, "extract", "f32", 100),
    (32, 2, "arena", "f32", 126), (32, 1, "arena", "int8", 100),
]


def phase_hop_kernel(st, m=HOP_M, cases=HOP_CASES):
    """``cagra_hop`` against ``cagra_hop_plain`` on the card, bit for bit, on
    ``m`` queries of the CAGRA set (2,048; the serve phase checks m=1). Each
    case starts from a beam of random ids with their true distances (every
    7th row half full), sorted by one plain prime call, then checks the
    kernel's prime call and one hop."""
    import torch

    from raft_tpu_torch.ops.cagra_hop import cagra_hop, cagra_hop_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x, q, lx, lq = cagra_data()
    q, lq = q[:m].contiguous(), lq[:m]
    sets = {("f32", 128): (x, q),
            ("int8", 128): ((x * 12.7 - 64.0).round().clamp(-128, 127).to(torch.int8),
                            q * 12.7 - 64.0),
            ("f32", 100): (x[:, :100].contiguous(), q[:, :100].contiguous()),
            ("f32", 126): (x[:, :126].contiguous(), q[:, :126].contiguous()),
            ("int8", 100): (x[:, :100].mul(12.7).sub(64.0).round().clamp(-128, 127)
                            .to(torch.int8).contiguous(), q[:, :100] * 12.7 - 64.0)}
    for itopk, width, merge, kind, d in cases:
        data, qq = sets[(kind, d)]
        qq = qq.contiguous()
        cw = 32 * width
        ids = torch.randint(0, N_MAIN, (m, itopk), generator=g, device=dev, dtype=torch.int32)
        bd = torch.full((m, 128), float("inf"), device=dev)
        bi = torch.full((m, 128), -1, dtype=torch.int32, device=dev)
        bv = torch.ones((m, 128), dtype=torch.int32, device=dev)
        bd[:, :itopk] = ((data[ids.long()].float() - qq[:, None]) ** 2).sum(-1)
        bi[:, :itopk] = ids
        bv[:, :itopk] = 0
        bd[::7, itopk // 2:itopk] = float("inf")
        bi[::7, itopk // 2:itopk] = -1
        none = torch.full((m, cw), -1, dtype=torch.int32, device=dev)
        zero = torch.zeros((m, cw), dtype=torch.int32, device=dev)
        prime = (qq, bd, bi, bv, none, data, zero, itopk, width)
        beam = cagra_hop_plain(*prime, merge="extract")[:3]
        nbrs = hop_candidates(beam[1], lq, lx, cw, g)
        valid = (torch.rand((m, cw), generator=g, device=dev) > 0.1).to(torch.int32)
        valid[5::11] = 0
        for what, args in (("prime", prime), ("hop", (qq, *beam, nbrs, data, valid, itopk,
                                                      width))):
            before = cagra_hop.launches
            got = cagra_hop(*args, merge=merge)
            torch.cuda.synchronize()
            assert cagra_hop.launches == before + 1, "cagra_hop did not launch"
            want = cagra_hop_plain(*args, merge=merge)
            for name, a, b in zip(("beam_d", "beam_i", "beam_v", "pick", "no_cand"), got, want):
                assert torch.equal(a, b), (
                    f"cagra_hop differs from its plain version in {name}: {what} itopk={itopk} "
                    f"width={width} {merge} {kind} d={d}; {int((a != b).sum())} entries")
            inserted = int((got[2][:, :itopk] == 0).sum()) if what == "hop" else 0
            emit(phase="check", kernel="cagra_hop", call=what, m=m, n=data.shape[0], d=d,
                 rows=kind, itopk=itopk, width=width, cw=cw, merge=merge,
                 unvisited_after=inserted, no_cand_rows=int(got[4][:, 0].sum()),
                 max_abs_err=0.0, bit_equal=True, ok=True)
    st["hop_err"] = 0.0


def phase_main(st):
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.topk import topk

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    x = torch.rand((N_MAIN, D_MAIN), generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    q = torch.rand((M_MAIN, D_MAIN), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    index = BruteForce(metric="sqeuclidean").build(x, res=res)
    index.search(q, K_MAIN)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = 3
    fused_knn.launches = topk.launches = 0
    t0 = time.perf_counter()
    for _ in range(batches):
        dist, ids = index.search(q, K_MAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_knn": fused_knn.launches, "topk": topk.launches}
    assert launches["fused_knn"] > 0, "the main path did not launch fused_knn"
    peak = torch.cuda.max_memory_allocated()
    assert dist.shape == (M_MAIN, K_MAIN) and ids.shape == (M_MAIN, K_MAIN)
    assert bool(torch.isfinite(dist).all()) and bool((ids >= 0).all())
    rd, ri = fused_knn_plain(x, q[:1024], K_MAIN, metric="l2")
    err = knn_equiv(dist[:1024], ids[:1024], rd, ri, rtol=1e-5, atol=1e-5)
    st["launches"] = launches
    emit(phase="main", path="BruteForce.search", n=N_MAIN, d=D_MAIN, m=M_MAIN,
         k=K_MAIN, batches=batches, qps=batches * M_MAIN / wall,
         seconds_per_batch=wall / batches, peak_device_bytes=peak,
         launches=launches, check_rows=1024, max_abs_err=err, card=st["card"])

    xf = x[:100_000].contiguous()
    flag = BruteForce(metric="sqeuclidean").build(xf, res=res)
    flag.search(q, K_MAIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        flag.search(q, K_MAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit(phase="main", path="BruteForce.search (bench.py flagship shape)",
         n=100_000, d=D_MAIN, m=M_MAIN, k=K_MAIN, qps=batches * M_MAIN / wall,
         card=st["card"])
    st["main"] = (x, q)
    st["main_ids"] = ids

    vals = torch.rand(TOPK_SHAPE, generator=torch.Generator(device=dev).manual_seed(2),
                      device=dev)
    select_k(vals, K_MAIN, res=res)          # warm-up
    torch.cuda.synchronize()
    fused_knn.launches = topk.launches = 0
    t0 = time.perf_counter()
    out_v, out_i = select_k(vals, K_MAIN, res=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert topk.launches > 0, "select_k did not launch topk"
    st["launches"]["topk"] = topk.launches
    ref = torch.sort(vals[:64], dim=1, stable=True)
    assert torch.equal(out_v[:64], ref.values[:, :K_MAIN])
    assert torch.equal(out_i[:64].long(), ref.indices[:, :K_MAIN])
    emit(phase="main", path="select_k", shape=list(TOPK_SHAPE), k=K_MAIN,
         ms=wall * 1e3, launches={"topk": topk.launches}, card=st["card"])
    st["select"] = vals


def phase_tc_path(st):
    """``knn`` at 1M x 128, one 10k-query batch, k=10, in each tensor-core
    mode through the public entry point: ``compute="bfloat16"``,
    ``compute="float32x3"`` and int8 data under the default compute. The
    counts are set to 0 just before each batch and read just after; each
    must launch the mode's kernel once and never the FFMA kernel. Each
    batch is held against the plain version on all its queries: int8 bit
    for bit, bf16 and f32x3 by knn_equiv at rtol = atol = 1e-5. bf16's and
    f32x3's recall@10 against the float32 answer of the main path is
    reported beside them."""
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.fused_knn import bf16_split, fused_knn, fused_knn_plain

    res = Resources(device="cuda")
    x, q = st["main"]
    truth = st["main_ids"]
    xs, qs = (as_bytes(a, 255.0, -128.0) for a in (x, q))
    runs = {"bf16": (x, q, "bfloat16"), "f32x3": (x, q, "float32x3"), "s8": (xs, qs, "float32")}
    st["tc_launches"] = {}
    for mode, (ds, qq, compute) in runs.items():
        fused_knn.launches = bf16_split.launches = 0
        fused_knn.launches_by_mode = dict.fromkeys(fused_knn.launches_by_mode, 0)
        dist, ids = knn(ds, qq, K_MAIN, compute=compute, res=res)
        torch.cuda.synchronize()
        counts = dict(fused_knn.launches_by_mode, bf16_split=bf16_split.launches)
        assert counts[mode] == 1 and fused_knn.launches == 1, counts
        # f32x3 splits the queries and the dataset into bf16 planes
        assert counts["bf16_split"] == (2 if mode == "f32x3" else 0), counts
        if mode == "f32x3":
            st["split_launches"] = counts["bf16_split"]
        assert dist.shape == (M_MAIN, K_MAIN) and bool(torch.isfinite(dist).all())
        st["tc_launches"][mode] = counts[mode]
        out = dict(mode=mode, compute=compute, launches=counts, check_rows=M_MAIN)
        rd, ri = fused_knn_plain(ds, qq, K_MAIN, mode=mode)
        if mode == "s8":
            assert torch.equal(dist, rd) and torch.equal(ids, ri), "int8 knn differs"
            out["max_abs_err"] = 0.0
        else:
            out["max_abs_err"] = knn_equiv(dist, ids, rd, ri, rtol=1e-5, atol=1e-5)
            out["recall_at_10_vs_f32"] = recall(ids, truth)
        st["tc_err"] = max(st.get("tc_err", 0.0), out["max_abs_err"])
        del rd, ri
        emit(phase="main", path="knn (tensor-core mode)", n=N_MAIN, d=D_MAIN, m=M_MAIN,
             k=K_MAIN, card=st["card"], **out)
    fused_knn.launches = bf16_split.launches = 0


def as_bytes(a, scale, shift=0.0, kind="int8"):
    """Float rows as bytes: round(scale·a + shift) clamped into int8, or as
    uint8 with 128 added after the rounding. The byte cells' data: the
    uniform main set at (255, -128), the IVF-PQ blob set at (12, 0), the
    CAGRA set at (12.7, -64)."""
    import torch

    v = (a * scale + shift).round()
    if kind == "uint8":
        return (v + 128.0).clamp(0, 255).to(torch.uint8)
    return v.clamp(-128, 127).to(torch.int8)


def blobs(n, centers, seed, scale=1.0):
    """n rows, each one of ``centers`` plus N(0, scale^2) noise, and their
    center labels."""
    import torch

    g = torch.Generator(device=centers.device).manual_seed(seed)
    lab = torch.randint(0, centers.shape[0], (n,), generator=g, device=centers.device)
    return centers[lab] + scale * torch.randn((n, centers.shape[1]), generator=g,
                                              device=centers.device), lab


def cagra_data():
    """The CAGRA set (bench.py's ``_make_clustered(1_000_000, 128, 10_000,
    2000)`` drawn with torch): dataset, queries and their labels."""
    import torch

    dev = torch.device("cuda")
    centers = 10.0 * torch.rand((CAGRA_CENTERS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(20))
    x, lx = blobs(N_MAIN, centers, 21, 0.5)
    q, lq = blobs(CAGRA_Q, centers, 22, 0.5)
    return x, q, lx, lq


def recall(ids, truth):
    return float((ids[:, :, None] == truth[:, None, :]).any(-1).sum()) / truth.numel()


def phase_ivf(st):
    """IVF-PQ build, search and refine at 1M x 128 (the synthetic stand-in for
    SIFT-1M, whose files the repository does not hold)."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    def reset():
        fused_knn.launches = topk.launches = pq_scan.launches = pq_scan_topk.launches = 0

    def counts():
        return {"fused_knn": fused_knn.launches, "topk": topk.launches,
                "pq_scan": pq_scan.launches, "pq_scan_topk": pq_scan_topk.launches}

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    centers = 2.0 * torch.randn((IVF_BLOBS, D_MAIN), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(10))
    x, _ = blobs(N_MAIN, centers, 11)
    q, _ = blobs(IVF_Q, centers, 12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_pq.build(ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0),
                         x, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index_bytes = sum(t.numel() * t.element_size() for t in (
        index.centers, index.centers_rot, index.rotation, index.codebooks,
        index.list_codes, index.list_ids, index.list_sizes, index.list_consts))
    assert index.size == N_MAIN and index.pq_dim == 64 and not index.pq_split
    emit(phase="ivf_build", n=N_MAIN, d=D_MAIN, blobs=IVF_BLOBS, build_seconds=build_s,
         n_lists=index.n_lists, capacity=index.capacity, pq_dim=index.pq_dim,
         pq_bits=index.pq_bits, index_bytes=index_bytes,
         code_bytes=index.list_codes.numel(), card=st["card"])

    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    d, i = ivf_pq.search(sp, index, q, IVF_K0, res=res)      # warm-up
    refine(x, q, i, K_MAIN, res=res)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()      # data, index and earlier phases' tensors
    batches = 3
    reset()
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = ivf_pq.search(sp, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    search_s = (time.perf_counter() - t0) / batches
    launches = counts()
    tiles = -(-IVF_Q // 128)
    assert launches["pq_scan_topk"] == tiles * batches, (
        f"the IVF-PQ search launched pq_scan_topk {launches['pq_scan_topk']} times, "
        f"not {tiles} a batch")
    assert launches["topk"] == 0 and launches["pq_scan"] == 0, launches
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = ivf_pq.search(sp, index, q, IVF_K0, res=res)
        rd, ri = refine(x, q, i, K_MAIN, res=res)
    torch.cuda.synchronize()
    both_s = (time.perf_counter() - t0) / batches
    peak = torch.cuda.max_memory_allocated()
    assert d.shape == (IVF_Q, IVF_K0) and rd.shape == (IVF_Q, K_MAIN)
    assert bool(torch.isfinite(rd).all()) and bool((ri >= 0).all())
    assert bool((ri < N_MAIN).all())

    # the plain route (the one-hot contraction) on 1,000 of the queries
    pd, pi = ivf_pq.search(dataclasses.replace(sp, scan_impl="onehot"), index,
                           q[:IVF_CHECK], IVF_K0, res=res)
    err = knn_equiv(d[:IVF_CHECK], i[:IVF_CHECK], pd, pi, rtol=1e-5, atol=1e-5)
    _, truth = BruteForce("sqeuclidean").build(x, res=res).search(q[:IVF_CHECK], K_MAIN)
    rec = recall(ri[:IVF_CHECK], truth)
    rec_pq = recall(i[:IVF_CHECK, :K_MAIN], truth)
    assert rec >= IVF_RECALL_FLOOR, f"recall@10 {rec} below {IVF_RECALL_FLOOR}"
    # the plain top-k route ("xla") answers as the routed one ("auto"); its
    # search time and device profile, in this same run, stand beside them
    sp_x = dataclasses.replace(sp, select_impl="xla")
    reset()
    xd, xi = ivf_pq.search(sp_x, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    xla_launches = counts()            # the plain-select route: the unfused scan
    assert xla_launches["pq_scan"] == tiles and xla_launches["pq_scan_topk"] == 0, xla_launches
    xla_same = torch.equal(xi, i) and torch.equal(xd, d)
    assert xla_same, (f"select_impl='xla' and 'auto' differ on "
                      f"{int((xi != i).any(1).sum())} of {IVF_Q} rows")
    t0 = time.perf_counter()
    for _ in range(batches):
        ivf_pq.search(sp_x, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    xla_s = (time.perf_counter() - t0) / batches
    # the unfused kernel route (pq_scan, bias, mask, topk, merge), as before
    # the fused kernel: the same answers, timed and profiled in this run
    fuses = ivf_pq._fuses_scan_and_select
    ivf_pq._fuses_scan_and_select = lambda *a: False
    try:
        reset()
        ud, ui = ivf_pq.search(sp, index, q, IVF_K0, res=res)
        torch.cuda.synchronize()
        unfused_launches = counts()
        t0 = time.perf_counter()
        for _ in range(batches):
            ivf_pq.search(sp, index, q, IVF_K0, res=res)
        torch.cuda.synchronize()
        unfused_s = (time.perf_counter() - t0) / batches
        profile_batch(st, "ivf_pq.search + refine, unfused scan and select",
                      "ivf_profile_unfused.txt",
                      lambda: refine(x, q, ivf_pq.search(sp, index, q, IVF_K0, res=res)[1],
                                     K_MAIN, res=res))
    finally:
        ivf_pq._fuses_scan_and_select = fuses
    assert unfused_launches["pq_scan"] == tiles and unfused_launches["topk"] == tiles, (
        unfused_launches)
    unfused_same = torch.equal(ui, i) and torch.equal(ud, d)
    assert unfused_same, (f"the fused and unfused routes differ on "
                          f"{int((ui != i).any(1).sum())} of {IVF_Q} rows")
    # the query tile (the JAX package's cap is 128), for the record
    tile_s = {}
    for qt in (128, 1024):
        ivf_pq._pq_search(index, q, 8, IVF_K0, qt, 8, "bfloat16", "kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            ivf_pq._pq_search(index, q, 8, IVF_K0, qt, 8, "bfloat16", "kernel")
        torch.cuda.synchronize()
        tile_s[qt] = (time.perf_counter() - t0) / batches
    emit(phase="query_tile", path="ivf_pq._pq_search", m=IVF_Q,
         seconds_per_batch={str(k): v for k, v in tile_s.items()},
         qps={str(k): IVF_Q / v for k, v in tile_s.items()}, default=128, card=st["card"])
    st["launches"]["pq_scan_topk"] = launches["pq_scan_topk"]
    st["launches"]["pq_scan"] = xla_launches["pq_scan"]
    emit(phase="main", path="ivf_pq.search + refine", n=N_MAIN, d=D_MAIN, m=IVF_Q,
         n_probes=8, lut_dtype="bfloat16", k0=IVF_K0, k=K_MAIN, batches=batches,
         qps_search=IVF_Q / search_s, qps_search_refine=IVF_Q / both_s,
         seconds_per_batch_search=search_s, seconds_per_batch_search_refine=both_s,
         peak_device_bytes=peak, peak_above_live_bytes=peak - live, launches=launches,
         pq_scan_topk_launches_per_batch=launches["pq_scan_topk"] / batches,
         topk_launches_per_batch=launches["topk"] / batches,
         select_xla_equals_auto=xla_same, qps_search_select_xla=IVF_Q / xla_s,
         launches_select_xla=xla_launches, unfused_equals_fused=unfused_same,
         qps_search_unfused=IVF_Q / unfused_s, launches_unfused=unfused_launches,
         onehot_check_rows=IVF_CHECK, max_abs_err=err, recall_at_10=rec,
         recall_at_10_before_refine=rec_pq, recall_floor=IVF_RECALL_FLOOR,
         card=st["card"])
    profile_batch(st, "ivf_pq.search + refine", "ivf_profile.txt",
                  lambda: refine(x, q, ivf_pq.search(sp, index, q, IVF_K0, res=res)[1],
                                 K_MAIN, res=res))
    profile_batch(st, "ivf_pq.search + refine, select_impl xla", "ivf_profile_select_xla.txt",
                  lambda: refine(x, q, ivf_pq.search(sp_x, index, q, IVF_K0, res=res)[1],
                                 K_MAIN, res=res))
    # this slice's paths on the same index and data, each with its own counts
    phase_ivf_filter(st, index, q, sp, (d, i))
    phase_ivf_grouped(st, index, q, sp, (d, i))
    phase_ivf_bytes(st, x, q, IVF_CHECK)
    phase_ivf_codecs(st, x, q, truth)
    st["ivf"] = (index, q)
    st["ivf_x"], st["ivf_truth"] = x, truth


def pq_counts():
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    return {"topk": topk.launches, "pq_scan": pq_scan.launches,
            "pq_scan_topk": pq_scan_topk.launches}


def pq_reset():
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    topk.launches = pq_scan.launches = pq_scan_topk.launches = 0


def timed_batches(fn, batches):
    """Host seconds per call of ``fn`` over ``batches`` calls, after a
    synchronise; and the last call's result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / batches, out


def phase_ivf_filter(st, index, q, sp, unfiltered):
    """Filtered IVF-PQ on the main index: bitsets keeping 50% and 2% of the
    ids (seeded). Each filtered batch must launch ``pq_scan_topk`` once a
    tile and ``topk`` never; the kernel equals ``pq_scan_topk_plain`` with
    the same bitset bit for bit on two of its tiles; every returned id is
    kept and -1 stands exactly where a distance is +inf; the plain-select
    route (``pq_scan``, the filter, the plain top-k) gives the same answers;
    an all-ones bitset gives the unfiltered answer exactly."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import pack_keep_words, pq_scan_topk, pq_scan_topk_plain

    res = Resources(device="cuda")
    dev = q.device
    d0, i0 = unfiltered
    tiles, batches = -(-IVF_Q // 128), 3
    ones = torch.ones(N_MAIN, dtype=torch.bool, device=dev)
    od, oi = ivf_pq.search(sp, index, q, IVF_K0, sample_filter=ones, res=res)
    assert torch.equal(od, d0) and torch.equal(oi, i0), "an all-ones filter changes the answer"
    base_s, _ = timed_batches(lambda: ivf_pq.search(sp, index, q, IVF_K0, res=res), batches)
    prof = {"unfiltered": profile_batch(st, "ivf_pq.search (no refine)",
                                        "ivf_profile_search.txt",
                                        lambda: ivf_pq.search(sp, index, q, IVF_K0, res=res))}
    out = {}
    for frac in FILTER_KEEP:
        g = torch.Generator(device=dev).manual_seed(30)
        keep = torch.rand(N_MAIN, generator=g, device=dev) < frac
        ivf_pq.search(sp, index, q, IVF_K0, sample_filter=keep, res=res)      # warm-up
        pq_reset()
        search_s, (d, i) = timed_batches(
            lambda: ivf_pq.search(sp, index, q, IVF_K0, sample_filter=keep, res=res), batches)
        launches = pq_counts()
        assert launches["pq_scan_topk"] == tiles * batches, (
            f"a filtered batch launched pq_scan_topk {launches['pq_scan_topk']} times")
        assert launches["topk"] == 0 and launches["pq_scan"] == 0, launches
        assert bool(keep[i[i >= 0].long()].all()), "a filtered id came back"
        assert torch.equal(i < 0, torch.isinf(d)), "-1 ids and +inf distances disagree"
        words = pack_keep_words(keep)
        tile_bits = []
        for t0 in (0, 128 * 40):
            qt = q[t0:t0 + 128]
            probes = ivf_pq._coarse_probes(index, qt, 8).to(torch.int64)
            with full_f32():
                qrot = qt @ index.rotation.T
            lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
            args = (index.list_codes, index.list_ids, probes.to(torch.int32).contiguous(),
                    lut.to(torch.bfloat16).contiguous(), bias.contiguous(), IVF_K0, True)
            before = pq_scan_topk.launches
            kv, ki = pq_scan_topk(*args, keep_words=words)
            pv, pi = pq_scan_topk_plain(*args, keep_words=words)
            pq_scan_topk.launches = before
            same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
            assert same, f"pq_scan_topk and its plain version differ at tile {t0 // 128}"
            tile_bits.append(same)
        xd, xi = ivf_pq.search(dataclasses.replace(sp, select_impl="xla"), index, q, IVF_K0,
                               sample_filter=keep, res=res)
        xla_same = torch.equal(xd, d) and torch.equal(xi, i)
        assert xla_same, (f"the filtered search differs between select routes on "
                          f"{int((xi != i).any(1).sum())} rows")
        prof[str(frac)] = profile_batch(
            st, f"ivf_pq.search, filter keeping {frac:.0%}",
            f"ivf_profile_filtered_{int(frac * 100)}.txt",
            lambda: ivf_pq.search(sp, index, q, IVF_K0, sample_filter=keep, res=res))
        underfilled = int((i < 0).any(1).sum())
        out[str(frac)] = dict(qps=IVF_Q / search_s, seconds_per_batch=search_s,
                              launches=launches, kept_ids_only=True,
                              kernel_tiles_bit_equal_plain=tile_bits, select_xla_equal=xla_same,
                              rows_underfilled=underfilled,
                              device_busy_ms=prof[str(frac)]["device_busy_ms"])
        st["launches"][f"pq_scan_topk_filtered_{frac}"] = launches["pq_scan_topk"]
        if frac == 0.5:
            st["ivf_keep"] = keep
    emit(phase="main", path="ivf_pq.search with a sample filter", n=N_MAIN, d=D_MAIN, m=IVF_Q,
         n_probes=8, lut_dtype="bfloat16", k=IVF_K0, batches=batches, keep_shares=FILTER_KEEP,
         unfiltered=dict(qps=IVF_Q / base_s, seconds_per_batch=base_s,
                         device_busy_ms=prof["unfiltered"]["device_busy_ms"]),
         filtered=out, all_ones_equals_unfiltered=True, card=st["card"])


def phase_ivf_grouped(st, index, q, sp, unfiltered):
    """``scan_order="grouped"`` on the main index against the tiled order:
    ids equal except on rows whose distances tie within 1e-5 (printed as
    ``route_row`` lines)."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq

    res = Resources(device="cuda")
    d0, i0 = unfiltered
    spg = dataclasses.replace(sp, scan_order="grouped")
    pq_reset()
    gd, gi = ivf_pq.search(spg, index, q, IVF_K0, res=res)
    torch.cuda.synchronize()
    launches = pq_counts()
    grouped_s, _ = timed_batches(lambda: ivf_pq.search(spg, index, q, IVF_K0, res=res), 1)
    differ = (torch.sort(gi, 1).values != torch.sort(i0, 1).values).any(1)
    rows = torch.nonzero(differ)[:, 0].tolist()
    ties_ok = True
    for r in rows:
        ok = bool(torch.allclose(torch.sort(gd[r]).values, torch.sort(d0[r]).values,
                                 rtol=1e-5, atol=1e-5))
        ties_ok &= ok
        if len(rows) <= 50:
            emit(phase="route_row", path="ivf_pq grouped vs tiled", row=r,
                 grouped_dists=gd[r].tolist(), tiled_dists=d0[r].tolist(), tie_within_1e5=ok)
    fin = torch.isfinite(d0)
    err = float((gd[fin] - d0[fin]).abs().max())
    emit(phase="main", path="ivf_pq.search, scan_order grouped", n=N_MAIN, m=IVF_Q, k=IVF_K0,
         group_size=spg.group_size, qps=IVF_Q / grouped_s, launches=launches,
         rows_differing=len(rows), max_abs_err=err, card=st["card"])
    assert ties_ok, "the grouped order's ids differ from the tiled order's beyond ties"


def phase_ivf_bytes(st, x, q, truth_rows):
    """Byte IVF-PQ: the blob set as int8 and uint8 rows (``as_bytes``),
    built in the main configuration, searched (k=40) and refined to 10;
    recall@10 against the stored bytes' exact neighbours (``knn``, the s8
    kernel) with the float configuration's floor; the kernel and ``"xla"``
    select routes equal."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.neighbors.refine import refine

    res = Resources(device="cuda")
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    tiles, batches = -(-IVF_Q // 128), 2
    for kind in ("int8", "uint8"):
        xb, qb = as_bytes(x, BYTE_SCALE, kind=kind), as_bytes(q, BYTE_SCALE, kind=kind)
        build_s, index = timed_batches(lambda: ivf_pq.build(
            ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0), xb, res=res), 1)
        assert index.data_kind == kind and index.size == N_MAIN
        ivf_pq.search(sp, index, qb, IVF_K0, res=res)
        pq_reset()
        search_s, (d, i) = timed_batches(lambda: ivf_pq.search(sp, index, qb, IVF_K0, res=res),
                                         batches)
        launches = pq_counts()
        assert launches["pq_scan_topk"] == tiles * batches and launches["topk"] == 0, launches
        xd, xi = ivf_pq.search(dataclasses.replace(sp, select_impl="xla"), index, qb, IVF_K0,
                               res=res)
        xla_same = torch.equal(xd, d) and torch.equal(xi, i)
        assert xla_same, f"{kind}: the select routes differ"
        _, ri = refine(xb, qb, i, K_MAIN, res=res)
        _, truth = knn(xb, qb[:truth_rows], K_MAIN, res=res)
        rec = recall(ri[:truth_rows], truth)
        emit(phase="main", path=f"ivf_pq {kind} build + search + refine", n=N_MAIN, d=D_MAIN,
             m=IVF_Q, k0=IVF_K0, k=K_MAIN, scale=BYTE_SCALE, build_seconds=build_s,
             qps_search=IVF_Q / search_s, launches=launches, select_xla_equal=xla_same,
             recall_at_10_vs_stored_bytes=rec, recall_floor=IVF_RECALL_FLOOR,
             check_rows=truth_rows, card=st["card"])
        assert rec >= IVF_RECALL_FLOOR, f"{kind}: recall@10 {rec} below {IVF_RECALL_FLOOR}"
        del index, xb, qb


# name -> IndexParams fields beyond the main configuration's
PQ_CODECS = {
    "per_cluster": dict(codebook_kind="per_cluster"),
    "residual_scale_norm": dict(residual_scale_norm=True),
    "opq_anisotropic_4bit": dict(rotation="opq", codebook_loss="anisotropic", fast_scan="4bit"),
}


def codec_tile_check(index, q):
    """One 128-query tile of a codec index through its scan kernel's wrapper
    and the plain version, on the same card inputs, bit for bit: the
    funnel's signature scan (``pq_scan`` over ``list_sig`` with the nibble
    LUT of ``_sig_nibble_lut``, split, S = the signature words) against
    ``pq_scan_plain``; otherwise ``pq_scan_topk`` with the index's own LUTs
    (per-cluster codebooks, per-list scales) against
    ``pq_scan_topk_plain``. The launch is taken back out of the count."""
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_plain, pq_scan_topk, pq_scan_topk_plain

    qt = q[:128]
    probes = ivf_pq._coarse_probes(index, qt, 8).to(torch.int64)
    with full_f32():
        qrot = qt @ index.rotation.T
    if index.has_fast_scan:
        t, p = probes.shape
        sig_w = index.list_sig.shape[2]
        r = qrot[:, None, :] - index.centers_rot[probes]
        slut = ivf_pq._sig_nibble_lut(r, index.fast_scan, sig_w)
        args = (index.list_sig, probes.reshape(-1).to(torch.int32).contiguous(),
                slut.reshape(t * p, sig_w, 32).to(torch.bfloat16).contiguous())
        before = pq_scan.launches
        got = pq_scan(*args, split=True)
        pq_scan.launches = before
        want = pq_scan_plain(*args, split=True)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        return "pq_scan", sig_w, same
    lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
    args = (index.list_codes, index.list_ids, probes.to(torch.int32).contiguous(),
            lut.to(torch.bfloat16).contiguous(), bias.contiguous(), IVF_K0, True)
    before = pq_scan_topk.launches
    kv, ki = pq_scan_topk(*args, split=index.pq_split)
    pq_scan_topk.launches = before
    pv, pi = pq_scan_topk_plain(*args, index.pq_split)
    same = torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)
    return "pq_scan_topk", index.pq_dim, same


def phase_ivf_codecs(st, x, q, truth):
    """Per-cluster, scale-normed and codec (OPQ, anisotropic, 4-bit
    fast-scan, searched through the funnel at ``funnel_widen=4``) builds of
    the main configuration: build seconds, QPS and recall@10 after refine,
    held to the main configuration's floor; one tile's kernel against its
    plain version bit for bit (``codec_tile_check``); each batch's launches
    exactly (per-cluster and scale-normed: ``pq_scan_topk`` once a tile, no
    ``topk`` or ``pq_scan``; the funnel: ``pq_scan`` and ``topk`` once a
    tile each, no ``pq_scan_topk``); the kernel and ``"xla"`` select routes
    equal."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    res = Resources(device="cuda")
    tiles, batches = -(-IVF_Q // 128), 2
    for name, kw in PQ_CODECS.items():
        build_s, index = timed_batches(lambda: ivf_pq.build(
            ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0, **kw), x, res=res), 1)
        widen = 4 if index.has_fast_scan else 1
        sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16", funnel_widen=widen)
        kernel, s_words, tile_same = codec_tile_check(index, q)
        assert tile_same, f"{name}: {kernel} differs from its plain version on a tile"
        ivf_pq.search(sp, index, q, IVF_K0, res=res)
        pq_reset()
        search_s, (d, i) = timed_batches(lambda: ivf_pq.search(sp, index, q, IVF_K0, res=res),
                                         batches)
        launches = pq_counts()
        want = ({"topk": tiles * batches, "pq_scan": tiles * batches, "pq_scan_topk": 0}
                if index.has_fast_scan else
                {"topk": 0, "pq_scan": 0, "pq_scan_topk": tiles * batches})
        assert launches == want, f"{name}: launches {launches}, want {want}"
        xd, xi = ivf_pq.search(dataclasses.replace(sp, select_impl="xla"), index, q, IVF_K0,
                               res=res)
        xla_same = torch.equal(xd, d) and torch.equal(xi, i)
        _, ri = refine(x, q, i, K_MAIN, res=res)
        rec = recall(ri[:truth.shape[0]], truth)
        st["launches"][f"{kernel}_{name}"] = launches[kernel]
        emit(phase="main", path=f"ivf_pq {name} build + search + refine", n=N_MAIN, d=D_MAIN,
             m=IVF_Q, k0=IVF_K0, k=K_MAIN, codebook_kind=index.codebook_kind,
             rotation=index.rotation_kind, codebook_loss=index.codebook_loss,
             fast_scan=index.fast_scan, funnel_widen=widen, build_seconds=build_s,
             qps_search=IVF_Q / search_s, launches=launches, tile_kernel=kernel,
             tile_S=s_words, tile_bit_equal_plain=tile_same, select_xla_equal=xla_same,
             recall_at_10=rec, recall_floor=IVF_RECALL_FLOOR, card=st["card"])
        assert xla_same, f"{name}: the select routes differ"
        assert rec >= IVF_RECALL_FLOOR, f"{name}: recall@10 {rec} below {IVF_RECALL_FLOOR}"
        del index


def plain_hop_search(sp, index, q):
    """``cagra.search`` with every hop on ``cagra_hop_plain`` in place of the
    kernel: the same route, merge and tie rules, in plain PyTorch."""
    import raft_tpu_torch.ops.cagra_hop as hop_mod
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra

    kernel = hop_mod.cagra_hop
    hop_mod.cagra_hop = hop_mod.cagra_hop_plain
    try:
        return cagra.search(sp, index, q, K_MAIN, res=Resources(device="cuda"))
    finally:
        hop_mod.cagra_hop = kernel


def phase_cagra_bytes(st):
    """CAGRA's byte build: the clustered 1M set scaled into int8 as the
    IVF-Flat phase scales it, ``build(IndexParams())``, and
    ``search(itopk_size=32)`` running ``cagra_hop`` over int8 rows; recall@10
    against the stored bytes' exact neighbours (``knn``, the s8 kernel),
    floor 0.95. The routes, on 1,000 queries: the kernel route
    (``fused_arena``) equals the same route with its hops on
    ``cagra_hop_plain``, bit for bit; the extract-merge kernel route
    (``hop_impl="fused"``, lowest-id ties as ``"xla"``) holds the float
    phase's per-row rule against ``"xla"``; the arena route against ``"xla"``:
    ids overlap >= 0.99, equal distances where the id sets agree, recall no
    lower than the "xla" route's less 0.002, and its differing rows
    printed. int8 rows score exact integers, so ties are common; the arena
    merge keeps the incumbent on a tie with its worst entry (the JAX
    kernel's rule, raft_tpu/ops/cagra_hop.py:150-192), where extract and
    "xla" take the lower id, and a beam can part there."""
    import dataclasses

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.cagra_hop import cagra_hop

    res = Resources(device="cuda")
    x, q, _, _ = cagra_data()
    x8, q8 = as_bytes(x, 12.7, -64.0), as_bytes(q, 12.7, -64.0)
    del x, q
    build_s, index = timed_batches(lambda: cagra.build(cagra.IndexParams(), x8, res=res), 1)
    g = index.graph
    assert index.dataset.dtype == torch.int8 and index.data_kind == "int8"
    assert int(g.min()) >= 0 and int(g.max()) < N_MAIN, "graph ids out of range"
    sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    assert cagra.resolve_hop_impl(sp, index.graph_degree, index.dim) == "fused_arena"
    cagra.search(sp, index, q8, K_MAIN, res=res)
    cagra_hop.launches = 0
    search_s, (d, i) = timed_batches(lambda: cagra.search(sp, index, q8, K_MAIN, res=res), 2)
    hops = cagra_hop.launches
    assert hops > 0, "the byte CAGRA search did not launch cagra_hop"
    qc = q8[:CAGRA_CHECK]
    _, truth = knn(x8, qc, K_MAIN, res=res)
    rec = recall(i[:CAGRA_CHECK], truth)
    kd, ki = cagra.search(sp, index, qc, K_MAIN, res=res)
    pd, pi = plain_hop_search(sp, index, qc)
    plain_same = torch.equal(kd.view(torch.int32), pd.view(torch.int32)) and torch.equal(ki, pi)
    ed, ei = cagra.search(dataclasses.replace(sp, hop_impl="fused"), index, qc, K_MAIN, res=res)
    xd, xi = cagra.search(dataclasses.replace(sp, hop_impl="xla"), index, qc, K_MAIN, res=res)

    def versus_xla(rd, ri):
        """Rows whose id sets differ from the "xla" route's, whether the
        agreeing rows' distances are equal, and whether each differing row's
        k-th distance is no worse than the "xla" route's (the float phase's
        rule)."""
        same = (torch.sort(ri, 1).values == torch.sort(xi, 1).values).all(1)
        equal = torch.equal(torch.sort(rd[same], 1).values, torch.sort(xd[same], 1).values)
        kth = torch.sort(rd[~same], 1).values[:, -1]
        kth_x = torch.sort(xd[~same], 1).values[:, -1]
        return same, equal, bool((kth <= kth_x * (1 + 1e-4) + 3e-3).all())

    e_same, e_equal, e_kth = versus_xla(ed, ei)
    same, route_ok, kth_ok = versus_xla(kd, ki)
    overlap = recall(ki, xi)
    rec_k, rec_x = recall(ki, truth), recall(xi, truth)
    for r in torch.nonzero(~same)[:, 0].tolist():
        emit(phase="route_row", path="cagra int8", row=r,
             kernel_dists=torch.sort(kd[r]).values.tolist(),
             xla_dists=torch.sort(xd[r]).values.tolist(),
             extract_dists=torch.sort(ed[r]).values.tolist(),
             kernel_recall=recall(ki[r:r + 1], truth[r:r + 1]),
             xla_recall=recall(xi[r:r + 1], truth[r:r + 1]))
    st["launches"]["cagra_hop_int8"] = hops
    emit(phase="main", path="cagra int8 build + search", n=N_MAIN, d=D_MAIN, m=CAGRA_Q,
         k=K_MAIN, itopk=CAGRA_ITOPK, build_seconds=build_s, qps=CAGRA_Q / search_s,
         cagra_hop_launches=hops, recall_at_10_vs_stored_bytes=rec,
         recall_floor=CAGRA_RECALL_FLOOR, check_rows=CAGRA_CHECK,
         arena_kernel_bit_equal_plain_hops=plain_same,
         extract_vs_xla=dict(rows_differing=int((~e_same).sum()), equal_where_same=e_equal,
                             kth_no_worse=e_kth),
         arena_vs_xla=dict(overlap=overlap, rows_differing=int((~same).sum()),
                           equal_where_same=route_ok, kth_no_worse=kth_ok),
         kernel_route_recall_at_10=rec_k, xla_route_recall_at_10=rec_x,
         seed_pool_hint=index.seed_pool_hint, card=st["card"])
    assert rec >= CAGRA_RECALL_FLOOR, f"int8 CAGRA recall@10 {rec} below {CAGRA_RECALL_FLOOR}"
    assert plain_same, "the int8 kernel route differs from its plain hops"
    assert e_equal and e_kth, "the int8 extract route breaks the per-row rule against xla"
    assert overlap >= 0.99, f"the int8 kernel route overlaps the xla route at {overlap}"
    assert route_ok, "int8 distances differ between the hop routes on rows of equal ids"
    assert rec_k >= rec_x - 0.002, f"int8 kernel route recall {rec_k} below the xla route's {rec_x}"


def phase_ball_cover(st):
    """Random ball cover at RAPIDS' documented home (low-dimensional and
    geospatial data): 1,000,000 x 3 uniform float32 under sqeuclidean and
    1,000,000 (lat, lon) points in radians under haversine, 10,000 queries
    each, k=10, held against exact ``knn`` in the same metric (sorted
    distances within rtol 1e-4, ids equal except where distances tie)."""
    import math

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ball_cover
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.topk import topk

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)

    def points(n, metric):
        if metric == "haversine":
            lat = torch.asin(2.0 * torch.rand(n, generator=g, device=dev) - 1.0)
            lon = (2.0 * torch.rand(n, generator=g, device=dev) - 1.0) * math.pi
            return torch.stack([lat, lon], 1)
        return torch.rand((n, 3), generator=g, device=dev)

    for metric in ("sqeuclidean", "haversine"):
        x, q = points(N_MAIN, metric), points(M_MAIN, metric)
        build_s, index = timed_batches(lambda: ball_cover.build(x, metric=metric, res=res), 1)
        ball_cover.knn_query(index, q[:100], K_MAIN, res=res)
        topk.launches = 0
        search_s, (d, i) = timed_batches(lambda: ball_cover.knn_query(index, q, K_MAIN, res=res),
                                         1)
        launches = topk.launches
        rd, ri = knn(x, q, K_MAIN, metric=metric, res=res)
        err = knn_equiv(d, i, rd, ri, rtol=1e-4, atol=1e-6)
        emit(phase="main", path=f"ball_cover.knn_query {metric}", n=N_MAIN, d=x.shape[1],
             m=M_MAIN, k=K_MAIN, n_landmarks=index.n_landmarks, capacity=index.capacity,
             build_seconds=build_s, qps=M_MAIN / search_s, topk_launches=launches,
             max_abs_err_vs_exact=err, card=st["card"])
        st["launches"][f"topk_ball_cover_{metric}"] = launches
        del index, x, q


def phase_matrix_ops(st):
    """The 16 ``matrix.ops`` functions on the card against the CPU."""
    import torch

    from raft_tpu_torch.matrix import ops

    g = torch.Generator().manual_seed(41)
    m = torch.randn((1000, 777), generator=g)
    m[3, 5] = m[3, 9] = m[3].max() + 1.0
    m[7] = m[7].round()
    rows = torch.randint(0, 1000, (300,), generator=g)
    mask = torch.rand(300, generator=g) > 0.5
    vec = torch.randn(777, generator=g)
    calls = {
        "argmax": lambda a: ops.argmax(a), "argmin": lambda a: ops.argmin(a),
        "gather": lambda a: ops.gather(a, rows.to(a.device)),
        "gather_if": lambda a: ops.gather_if(a, rows.to(a.device), mask.to(a.device), -1.0),
        "slice": lambda a: ops.slice(a, 10, 500, 3, 700), "copy": lambda a: ops.copy(a),
        "fill": lambda a: ops.fill((5, 7), 2.5, device=a.device),
        "eye": lambda a: ops.eye(9, device=a.device),
        "linewise_op": lambda a: ops.linewise_op(a, vec.to(a.device), True,
                                                 lambda u, v: u * v + 1.0),
        "col_wise_sort": lambda a: ops.col_wise_sort(a, ascending=False),
        "reverse": lambda a: ops.reverse(a, along_rows=False),
        "sign_flip": lambda a: ops.sign_flip(a),
        "upper_triangular": lambda a: ops.upper_triangular(a),
        "lower_triangular": lambda a: ops.lower_triangular(a),
        "get_diagonal": lambda a: ops.get_diagonal(a),
        "set_diagonal": lambda a: ops.set_diagonal(a, vec.to(a.device)),
    }
    assert set(calls) == set(ops.__all__)
    for name, fn in calls.items():
        card, cpu = fn(m.cuda()), fn(m)
        for a, b in zip(card if isinstance(card, tuple) else (card,),
                        cpu if isinstance(cpu, tuple) else (cpu,)):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b), name
    emit(phase="check", what="matrix.ops card vs cpu", functions=len(calls), equal=True,
         shape=list(m.shape), card=st["card"])


def profile_batch(st, path, filename, batch, what="10,000-query batch"):
    """Device time by kernel over one call of ``batch`` (torch.profiler),
    and the device's idle share of the batch's host time. The whole table
    goes to ``filename`` in the ``--out`` directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key, str(e.device_type).endswith("CUDA")))
    if any(r[3] for r in rows):
        rows = [r for r in rows if r[3]]       # kernels only: ops would count twice
    rows = sorted((r[:3] for r in rows), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    os.makedirs(st["out"], exist_ok=True)
    with open(os.path.join(st["out"], filename), "w") as f:
        f.write(f"# {st['card']}; one {what} of {path}; "
                f"host {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms\n")
        for ms, n, key in rows:
            f.write(f"{ms:12.3f} ms {n:8d}  {key}\n")
    rec = dict(phase="profile", path=path, wall_ms=wall_ms,
               device_busy_ms=busy_ms, device_ops=sum(r[1] for r in rows),
               idle_share=1.0 - busy_ms / wall_ms,
               top=[dict(ms=ms, count=n, kernel=key[:100]) for ms, n, key in rows[:15]],
               card=st["card"])
    emit(**rec)
    return rec


def phase_cagra(st):
    """CAGRA build and search at 1M x 128 in the JAX package's
    ``cagra_1m_itopk32`` configuration: ``IndexParams()`` (every default),
    ``SearchParams(itopk_size=32)``, k=10, 10,000-query batches."""
    import dataclasses
    import logging
    import re

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_pq
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.ops.cagra_hop import cagra_hop
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    def counts():
        return {"fused_knn": fused_knn.launches, "topk": topk.launches,
                "pq_scan": pq_scan.launches, "pq_scan_topk": pq_scan_topk.launches,
                "cagra_hop": cagra_hop.launches}

    def reset():
        fused_knn.launches = topk.launches = pq_scan.launches = 0
        pq_scan_topk.launches = cagra_hop.launches = 0

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    x, q, _, _ = cagra_data()
    notes = []
    handler = logging.Handler()
    handler.emit = lambda record: notes.append(record.getMessage())
    log = logging.getLogger("raft_tpu_torch")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    params = cagra.IndexParams()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    reset()
    t0 = time.perf_counter()
    index = cagra.build(params, x, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = counts()
    build_peak = torch.cuda.max_memory_allocated() - live
    log.removeHandler(handler)
    tuned = [m for m in notes if "build_n_probes auto" in m]
    probes = int(re.search(r"using (\d+) probes", tuned[0]).group(1)) if (
        tuned and "using" in tuned[0]) else 32
    g = index.graph
    n_self = int((g == torch.arange(N_MAIN, device=dev, dtype=torch.int32)[:, None]).sum())
    assert g.shape == (N_MAIN, params.graph_degree) and g.dtype == torch.int32
    assert int(g.min()) >= 0 and int(g.max()) < N_MAIN, "graph ids out of range"
    assert n_self == 0, f"{n_self} self-edges"
    k, gpu_top_k, n_lists, pq_bits = cagra.knn_build_plan(params, N_MAIN, D_MAIN)
    assert build_launches["pq_scan_topk"] > 0, "the CAGRA build did not launch pq_scan_topk"
    emit(phase="cagra_build", n=N_MAIN, d=D_MAIN, centers=CAGRA_CENTERS,
         build_seconds=build_s, n_lists=n_lists, pq_bits=pq_bits,
         pq_dim=ivf_pq._default_pq_dim(D_MAIN, pq_bits), self_search_k=gpu_top_k + 1, refine_k=k + 1,
         probes_after_chunk_0=probes, autotune_note=tuned, seed_pool_hint=index.seed_pool_hint,
         graph_shape=list(g.shape), self_edges=n_self, graph_ids_in_range=True,
         launches=build_launches, peak_above_live_bytes=build_peak, card=st["card"])

    sp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    impl = cagra.resolve_hop_impl(sp, index.graph_degree, index.dim)
    assert impl == "fused_arena", impl
    cagra.search(sp, index, q, K_MAIN, res=res)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    batches = 3
    reset()
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = cagra.search(sp, index, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    search_s = (time.perf_counter() - t0) / batches
    launches = counts()
    assert launches["cagra_hop"] > 0, "the CAGRA search did not launch cagra_hop"
    peak = torch.cuda.max_memory_allocated()
    assert d.shape == (CAGRA_Q, K_MAIN) and i.shape == (CAGRA_Q, K_MAIN)
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all()) and bool((i < N_MAIN).all())

    qc = q[:CAGRA_CHECK]
    _, truth = BruteForce("sqeuclidean").build(x, res=res).search(qc, K_MAIN)
    rec = recall(i[:CAGRA_CHECK], truth)
    # the kernel route against the "xla" route: ids overlap >= 0.99; where a
    # row's id set agrees, its sorted distances agree within rtol 1e-4. The
    # routes score in different forms (direct against expanded, ~3e-3 apart
    # at distances ~64), so a near-tie can swap an id: on such a row the
    # kernel route's k-th distance is no worse than the "xla" route's
    # (1 + 1e-4) plus 3e-3, and both rows' distances are printed.
    kd, ki = cagra.search(sp, index, qc, K_MAIN, res=res)
    xd, xi = cagra.search(dataclasses.replace(sp, hop_impl="xla"), index, qc, K_MAIN, res=res)
    overlap = recall(ki, xi)
    same = (torch.sort(ki, 1).values == torch.sort(xi, 1).values).all(1)
    ks, xs = torch.sort(kd[same], 1).values, torch.sort(xd[same], 1).values
    route_err = float((ks - xs).abs().max()) if bool(same.any()) else 0.0
    route_ok = bool(torch.allclose(ks, xs, rtol=1e-4, atol=1e-4))
    kth_k = torch.sort(kd[~same], 1).values[:, -1]
    kth_x = torch.sort(xd[~same], 1).values[:, -1]
    kth_ok = bool((kth_k <= kth_x * (1 + 1e-4) + 3e-3).all())
    for r in torch.nonzero(~same)[:, 0].tolist():
        emit(phase="route_row", row=r, kernel_dists=torch.sort(kd[r]).values.tolist(),
             xla_dists=torch.sort(xd[r]).values.tolist(),
             kernel_recall=recall(ki[r:r + 1], truth[r:r + 1]),
             xla_recall=recall(xi[r:r + 1], truth[r:r + 1]))
    # the plain top-k route answers as the routed one: a threshold above
    # every row sends the entry pool's select to the plain route ("xla")
    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    sk.set_wide_cols_threshold(1 << 30)
    try:
        pd, pi = cagra.search(sp, index, q, K_MAIN, res=res)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            cagra.search(sp, index, q, K_MAIN, res=res)
        torch.cuda.synchronize()
        plain_s = (time.perf_counter() - t0) / batches
        profile_batch(st, "cagra.search, plain top-k", "cagra_profile_plain_topk.txt",
                      lambda: cagra.search(sp, index, q, K_MAIN, res=res))
    finally:
        sk.set_wide_cols_threshold(None)
    select_same = torch.equal(pi, i) and torch.equal(pd, d)
    st["launches"]["cagra_hop"] = launches["cagra_hop"]
    emit(phase="main", path="cagra.search", n=N_MAIN, d=D_MAIN, m=CAGRA_Q, k=K_MAIN,
         itopk=CAGRA_ITOPK, hop_impl=impl, batches=batches, qps=CAGRA_Q / search_s,
         seconds_per_batch=search_s, launches=launches,
         cagra_hop_launches_per_batch=launches["cagra_hop"] / batches,
         hops_per_batch=launches["cagra_hop"] / batches - 1,
         topk_launches_per_batch=launches["topk"] / batches,
         select_xla_equals_auto=select_same, qps_plain_topk=CAGRA_Q / plain_s,
         peak_device_bytes=peak, peak_above_live_bytes=peak - live,
         recall_at_10=rec, recall_floor=CAGRA_RECALL_FLOOR, check_rows=CAGRA_CHECK,
         xla_route_overlap=overlap, xla_route_recall_at_10=recall(xi, truth),
         xla_route_rows_differing=int((~same).sum()),
         xla_route_max_abs_err_same_rows=route_err, card=st["card"])
    assert rec >= CAGRA_RECALL_FLOOR, f"recall@10 {rec} below {CAGRA_RECALL_FLOOR}"
    assert overlap >= 0.99, f"kernel route overlaps the xla route at {overlap}"
    assert route_ok, f"kernel and xla route distances differ by {route_err}"
    assert kth_ok, "where the ids differ, the kernel route's k-th distance is worse"
    assert select_same, (f"the plain and routed entry-pool top-k differ on "
                         f"{int((pi != i).any(1).sum())} of {CAGRA_Q} rows")
    profile_batch(st, "cagra.search", "cagra_profile.txt",
                  lambda: cagra.search(sp, index, q, K_MAIN, res=res))
    st["cagra"] = (index, q)
    st["cagra_truth"] = truth


def phase_ivf_flat(st):
    """IVF-Flat build and search in the JAX package's ``ivf_flat_1m_p8`` row
    (bench.py:3221-3239): the CAGRA set, ``IndexParams(n_lists=1024,
    seed=0)``, ``SearchParams(n_probes=8)``, k=10, 10,000-query batches."""
    import math

    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.matrix.select_k import set_wide_cols_threshold, wide_dispatch_ok
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.neighbors.brute_force import BruteForce
    from raft_tpu_torch.neighbors.sample_filter import BitsetFilter
    from raft_tpu_torch.ops.fused_knn import fused_knn
    from raft_tpu_torch.ops.topk import topk

    def reset():
        fused_knn.launches = topk.launches = 0

    def counts():
        return {"fused_knn": fused_knn.launches, "topk": topk.launches}

    def plain_route(fn):
        """``fn()`` with the wide-select threshold above every row: every
        select on the plain top-k route; no topk launch."""
        set_wide_cols_threshold(1 << 30)
        try:
            before = topk.launches
            out = fn()
            torch.cuda.synchronize()
            assert topk.launches == before, "the plain route launched topk"
            return out
        finally:
            set_wide_cols_threshold(None)

    def index_bytes(ix):
        return sum(t.numel() * t.element_size() for t in (
            ix.centers, ix.list_data, ix.list_ids, ix.list_norms, ix.list_sizes))

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    x, q, _, _ = cagra_data()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS, seed=0), x, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert index.size == N_MAIN and index.list_data.dtype == torch.float32
    emit(phase="ivf_flat_build", n=N_MAIN, d=D_MAIN, n_lists_asked=IVF_FLAT_LISTS,
         n_lists=index.n_lists, capacity=index.capacity, build_seconds=build_s,
         index_bytes=index_bytes(index), card=st["card"])

    sp = ivf_flat.SearchParams(n_probes=IVF_FLAT_PROBES)
    ivf_flat.search(sp, index, q, K_MAIN, res=res)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    batches = 3
    reset()
    t0 = time.perf_counter()
    for _ in range(batches):
        d, i = ivf_flat.search(sp, index, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    search_s = (time.perf_counter() - t0) / batches
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    assert d.shape == (CAGRA_Q, K_MAIN) and i.shape == (CAGRA_Q, K_MAIN)
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all()) and bool((i < N_MAIN).all())
    # (c) the topk launches the tile plan gives: one a (tile, chunk) select,
    # one for the coarse select and one a tile's merge where those are wide
    qt, pc = ivf_flat.search_plan(index, CAGRA_Q, IVF_FLAT_PROBES, K_MAIN, res)
    tiles, chunks = -(-CAGRA_Q // qt), IVF_FLAT_PROBES // pc
    chunk_wide = wide_dispatch_ok(pc * index.capacity, K_MAIN, torch.float32, dev)
    coarse_wide = wide_dispatch_ok(index.n_lists, IVF_FLAT_PROBES, torch.float32, dev)
    merge_wide = wide_dispatch_ok(chunks * K_MAIN, K_MAIN, torch.float32, dev)
    planned = tiles * chunks * chunk_wide + coarse_wide + tiles * merge_wide
    assert chunk_wide, "the IVF-Flat chunk select does not reach the topk kernel"
    assert launches["topk"] == planned * batches, (
        f"the IVF-Flat search launched topk {launches['topk'] / batches} times a batch, "
        f"not the plan's {planned}")
    assert launches["fused_knn"] == 0, launches

    # (a) recall@10 against exact ground truth (the fused_knn path)
    qc = q[:IVF_FLAT_CHECK]
    _, truth = BruteForce("sqeuclidean").build(x, res=res).search(qc, K_MAIN)
    rec = recall(i[:IVF_FLAT_CHECK], truth)
    # (b) the plain top-k route answers as the routed one
    pd, pi = plain_route(lambda: ivf_flat.search(sp, index, q, K_MAIN, res=res))
    routes_equal = torch.equal(pi, i) and torch.equal(pd, d)
    assert routes_equal, (f"the plain and topk routes differ on "
                          f"{int((pi != i).any(1).sum())} of {CAGRA_Q} rows")
    # (d) a filter that drops half the ids
    keep = torch.rand(N_MAIN, generator=torch.Generator(device=dev).manual_seed(30),
                      device=dev) < 0.5
    fd, fi = ivf_flat.search(sp, index, q, K_MAIN, sample_filter=BitsetFilter(keep), res=res)
    kept = fi[fi >= 0].long()
    assert bool(keep[kept].all()), "a filtered-out id came back"
    fpd, fpi = plain_route(lambda: ivf_flat.search(sp, index, q, K_MAIN,
                                                   sample_filter=BitsetFilter(keep), res=res))
    filter_equal = torch.equal(fpi, fi) and torch.equal(fpd, fd)
    assert filter_equal, "the filtered search differs between the select routes"
    underfilled = int((fi == -1).any(1).sum())
    assert bool(torch.isinf(fd[fi == -1]).all())
    profile_batch(st, "ivf_flat.search", "ivf_flat_profile.txt",
                  lambda: ivf_flat.search(sp, index, q, K_MAIN, res=res))
    # one chunk of the first tile: the gather of its probed lists and the
    # batched product, and the same gather at random probes of that shape
    probes = ivf_flat._coarse_probes(index, q[:qt], IVF_FLAT_PROBES).long()[:, :pc]
    rand = torch.randint(0, index.n_lists, tuple(probes.shape), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(31))
    block = index.list_data[probes].reshape(qt, pc * index.capacity, D_MAIN)
    with full_f32():
        prod_ms = cuda_ms(lambda: torch.bmm(block, q[:qt, :, None]), reps=20)
    chunk = dict(gather_ms=cuda_ms(lambda: index.list_data[probes], reps=20),
                 gather_random_probes_ms=cuda_ms(lambda: index.list_data[rand], reps=20),
                 product_ms=prod_ms, block_bytes=block.numel() * 4,
                 distinct_lists=int(torch.unique(probes).numel()))
    emit(phase="time", what="ivf_flat chunk", T=qt, pc=pc, cap=index.capacity,
         card=st["card"], **chunk)
    del block
    st["launches"]["topk_ivf_flat"] = launches["topk"]
    emit(phase="main", path="ivf_flat.search", n=N_MAIN, d=D_MAIN, m=CAGRA_Q, k=K_MAIN,
         n_probes=IVF_FLAT_PROBES, batches=batches, qps=CAGRA_Q / search_s,
         seconds_per_batch=search_s, query_tile=qt, probe_chunk=pc,
         chunk_select_cols=pc * index.capacity, launches=launches,
         topk_launches_per_batch=launches["topk"] / batches, planned_topk_per_batch=planned,
         fused_knn_launches=launches["fused_knn"], peak_device_bytes=peak,
         peak_above_live_bytes=peak - live, recall_at_10=rec,
         recall_floor=IVF_FLAT_RECALL_FLOOR, check_rows=IVF_FLAT_CHECK,
         plain_route_equal=routes_equal, filter_kept_share=float(keep.float().mean()),
         filter_routes_equal=filter_equal, filter_underfilled_rows=underfilled,
         chunk=chunk, card=st["card"])
    assert rec >= IVF_FLAT_RECALL_FLOOR, f"recall@10 {rec} below {IVF_FLAT_RECALL_FLOOR}"
    st["ivf_flat"] = (index, sp)
    del index, d, i, pd, pi, fd, fi, fpd, fpi

    # (e) bfloat16 lists
    t0 = time.perf_counter()
    bindex = ivf_flat.build(ivf_flat.IndexParams(n_lists=IVF_FLAT_LISTS, seed=0,
                                                 list_dtype="bfloat16"), x, res=res)
    torch.cuda.synchronize()
    b_build = time.perf_counter() - t0
    assert bindex.list_data.dtype == torch.bfloat16 and bindex.data_kind == "bfloat16"
    ivf_flat.search(sp, bindex, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        bd, bi = ivf_flat.search(sp, bindex, q, K_MAIN, res=res)
    torch.cuda.synchronize()
    b_search = (time.perf_counter() - t0) / batches
    # rounding the rows to bfloat16 moves their distances by about the gap
    # between the 10th and 11th neighbours of this set, so even an exact
    # search over the stored rows misses some of the float32 truth: the
    # floor holds the search to the exact neighbours of the rows it stores
    _, truth_b = BruteForce("sqeuclidean").build(x.bfloat16().float(), res=res).search(
        qc, K_MAIN)
    b_rec = recall(bi[:IVF_FLAT_CHECK], truth)
    b_rec_stored = recall(bi[:IVF_FLAT_CHECK], truth_b)
    emit(phase="main", path="ivf_flat.search, list_dtype bfloat16", n=N_MAIN, d=D_MAIN,
         m=CAGRA_Q, k=K_MAIN, n_probes=IVF_FLAT_PROBES, build_seconds=b_build,
         index_bytes=index_bytes(bindex), qps=CAGRA_Q / b_search, recall_at_10=b_rec,
         exact_recall_over_stored_rows=recall(truth_b, truth),
         recall_at_10_vs_stored_rows=b_rec_stored, recall_floor_vs_stored_rows=IVF_FLAT_BF16_FLOOR,
         card=st["card"])
    assert b_rec_stored >= IVF_FLAT_BF16_FLOOR, (
        f"bf16 recall@10 against the stored rows' neighbours {b_rec_stored} below "
        f"{IVF_FLAT_BF16_FLOOR}")
    del bindex, bd, bi

    # (f) int8 lists: the set scaled and rounded into int8; integer scores
    # are exact, so the two select routes agree exactly
    x8, q8 = as_bytes(x[:INT8_ROWS], 12.7, -64.0), as_bytes(q, 12.7, -64.0)
    iindex = ivf_flat.build(ivf_flat.IndexParams(n_lists=INT8_LISTS, seed=0), x8, res=res)
    assert iindex.data_kind == "int8" and iindex.list_data.dtype == torch.int8
    reset()
    idd, iid = ivf_flat.search(sp, iindex, q8, K_MAIN, res=res)
    torch.cuda.synchronize()
    i_launches = counts()
    ipd, ipi = plain_route(lambda: ivf_flat.search(sp, iindex, q8, K_MAIN, res=res))
    int8_equal = torch.equal(ipi, iid) and torch.equal(ipd, idd)
    assert int8_equal, "the int8 search differs between the select routes"
    assert bool((idd == idd.round()).all()), "int8 distances are not integers"
    emit(phase="main", path="ivf_flat.search, int8 lists", n=INT8_ROWS, d=D_MAIN, m=CAGRA_Q,
         k=K_MAIN, n_lists=iindex.n_lists, capacity=iindex.capacity,
         launches=i_launches, plain_route_equal=int8_equal, card=st["card"])
    del iindex, x8, q8


def expanded_bound(xn, yn):
    """Error bound of the float32 expanded L2 form ‖x‖² + ‖y‖² − 2·x·y over d
    terms, d·2⁻²⁴·(‖x‖² + ‖y‖² + 2‖x‖‖y‖), from the squared norms ``xn`` and
    ``yn`` (float64, broadcast against each other)."""
    return D_MAIN * 2.0 ** -24 * (xn + yn + 2.0 * (xn * yn).sqrt())


def _ref64(metric, xt, y, p):
    """The metric's formula in float64 over one row tile: xt (t, d), y (n, d)."""
    import torch

    def glog(v):
        return torch.where(v > 0, torch.log(torch.where(v > 0, v, 1.0)), 0.0)

    def cos(a, b):
        return 1.0 - (a @ b.T) / (a.norm(dim=1)[:, None] * b.norm(dim=1)[None, :])

    if metric == "inner_product":
        return xt @ y.T
    if metric == "cosine":
        return cos(xt, y)
    if metric == "correlation":
        return cos(xt - xt.mean(1, keepdim=True), y - y.mean(1, keepdim=True))
    if metric == "hellinger":
        return torch.sqrt(torch.clamp_min(1.0 - xt.sqrt() @ y.sqrt().T, 0.0))
    if metric == "russellrao":
        return (xt.shape[1] - xt @ y.T) / xt.shape[1]
    if metric == "kl_divergence":
        return 0.5 * ((xt * glog(xt)).sum(1)[:, None] - xt @ glog(y).T)
    if metric in ("jaccard", "dice"):
        inter = xt @ y.T
        tot = xt.sum(1)[:, None] + y.sum(1)[None, :]
        den = tot - inter if metric == "jaccard" else tot
        num = inter if metric == "jaccard" else 2.0 * inter
        return torch.where(den > 0, 1.0 - num / torch.where(den > 0, den, 1.0), 0.0)
    a, b = xt[:, None, :], y[None, :, :]
    if metric == "haversine":
        s1 = torch.sin(0.5 * (b[..., 0] - a[..., 0]))
        s2 = torch.sin(0.5 * (b[..., 1] - a[..., 1]))
        h = s1 * s1 + torch.cos(a[..., 0]) * torch.cos(b[..., 0]) * s2 * s2
        return 2.0 * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0))), h
    diff = a - b
    if metric in ("sqeuclidean", "euclidean", "l2_expanded", "l2_sqrt_expanded"):
        d2 = (diff * diff).sum(-1)
        return d2 if metric in ("sqeuclidean", "l2_expanded") else d2.sqrt()
    if metric == "l1":
        return diff.abs().sum(-1)
    if metric == "chebyshev":
        return diff.abs().amax(-1)
    if metric == "canberra":
        den = a.abs() + b.abs()
        return torch.where(den > 0, diff.abs() / torch.where(den > 0, den, 1.0), 0.0).sum(-1)
    if metric == "minkowski":
        return diff.abs().pow(p).sum(-1).pow(1.0 / p)
    if metric == "braycurtis":
        den = (a + b).abs().sum(-1)
        return torch.where(den > 0, diff.abs().sum(-1) / torch.where(den > 0, den, 1.0), 0.0)
    if metric == "jensenshannon":
        logm = glog(0.5 * (a + b))
        acc = (-a * (logm - glog(a)) - b * (logm - glog(b))).sum(-1)
        return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))
    if metric == "hamming":
        return (a != b).double().mean(-1)
    raise ValueError(metric)


# metric -> (inputs, metric_arg, rtol): every pairwise metric, at the rtol the
# CPU parity tests use (atol 1e-5 throughout)
PAIRWISE_METRICS = {
    "l2_expanded": ("uniform", 2.0, 1e-5), "l2_sqrt_expanded": ("uniform", 2.0, 1e-5),
    "sqeuclidean": ("uniform", 2.0, 1e-5), "euclidean": ("uniform", 2.0, 1e-5),
    "cosine": ("uniform", 2.0, 1e-5), "inner_product": ("uniform", 2.0, 1e-5),
    "correlation": ("uniform", 2.0, 1e-5), "hellinger": ("simplex", 2.0, 1e-5),
    "russellrao": ("binary", 2.0, 1e-5), "kl_divergence": ("simplex", 2.0, 1e-4),
    "jaccard": ("binary", 2.0, 1e-5), "dice": ("binary", 2.0, 1e-5),
    "l1": ("uniform", 2.0, 1e-5), "chebyshev": ("uniform", 2.0, 1e-5),
    "canberra": ("uniform", 2.0, 1e-5), "minkowski": ("uniform", 3.0, 1e-5),
    "braycurtis": ("uniform", 2.0, 1e-5), "jensenshannon": ("simplex", 2.0, 1e-4),
    "hamming": ("binary", 2.0, 1e-5), "haversine": ("latlon", 2.0, 1e-5),
}


def phase_slice(st):
    """The rest of this slice on the card, each against float64 or the port's
    own plain route: every pairwise metric at 2,048 x 16,384 x 128 (haversine
    at d = 2); ``knn(metric="l1")`` over the 1M set on both select routes;
    ``masked_l2_nn`` and ``gram_matrix`` at 10,000 x 100,000 x 128;
    ``kmeans.fit`` at 100,000 x 128 from ``init="array"`` against the same
    call on the CPU; ``eps_neighbors_l2sq`` at 10,000 x 100,000."""
    import torch

    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.distance import (DistanceType, KernelParams, KernelType,
                                         gram_matrix, masked_l2_nn, pairwise_distance)
    from raft_tpu_torch.matrix.select_k import set_wide_cols_threshold
    from raft_tpu_torch.neighbors import eps_neighbors_l2sq
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops.topk import topk

    res = Resources(device="cuda")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    m, n, d = PAIR_M, PAIR_N, D_MAIN
    names = {"l2_expanded": DistanceType.L2Expanded,
             "l2_sqrt_expanded": DistanceType.L2SqrtExpanded}

    def inputs(kind):
        if kind == "latlon":
            lat = (torch.rand((m + n,), generator=g, device=dev) - 0.5) * 3.14159
            lon = (torch.rand((m + n,), generator=g, device=dev) - 0.5) * 6.28318
            a = torch.stack([lat, lon], 1)
        else:
            a = torch.rand((m + n, d), generator=g, device=dev)
            a[torch.rand((m + n, d), generator=g, device=dev) < 0.1] = 0.0
            if kind == "binary":
                a = (a < 0.3).float()
            elif kind == "simplex":
                a[:, 0] += 1e-3
                a = a / a.sum(1, keepdim=True)
        return a[:m].contiguous(), a[m:].contiguous()

    worst = {}
    t_all = time.perf_counter()
    for name, (kind, arg, rtol) in PAIRWISE_METRICS.items():
        xm, ym = inputs(kind)
        got = pairwise_distance(xm, ym, names.get(name, name), metric_arg=arg, res=res)
        assert got.shape == (m, n) and got.dtype == torch.float32
        y64 = ym.double()
        err, rel = 0.0, 0.0
        for i in range(0, m, 128):
            ref = _ref64(name, xm[i:i + 128].double(), y64, arg)
            tol_extra = 0.0
            if name in ("l2_expanded", "l2_sqrt_expanded"):
                # the float32 expanded form ‖x‖² + ‖y‖² − 2·x·y: its error bound
                b = expanded_bound(xm[i:i + 128].double().square().sum(1)[:, None],
                                   y64.square().sum(1)[None, :])
                tol_extra = b if name == "l2_expanded" else torch.minimum(
                    b.sqrt(), b / ref.clamp_min(1e-30))
            if name == "haversine":
                # asin√h is ill-conditioned near antipodes: h's own float32
                # rounding (8 ulps) through the slope 1/√(h(1-h))
                ref, h = ref
                tol_extra = 8 * h * 2.0 ** -23 / torch.sqrt(torch.clamp_min(h * (1 - h), 1e-30))
            gi = got[i:i + 128].double()
            diff = (gi - ref).abs()
            ok = diff <= rtol * ref.abs() + 1e-5 + tol_extra
            assert bool(ok.all()), (f"pairwise {name} differs from float64: "
                                    f"{int((~ok).sum())} entries, max abs err {float(diff.max())}")
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / ref.abs().clamp_min(1e-6)).max()))
        worst[name] = (err, rel)
    emit(phase="check", what="pairwise_distance vs float64", m=m, n=n, d=d,
         metrics=len(PAIRWISE_METRICS), max_abs_err={k: v[0] for k, v in worst.items()},
         max_rel_err={k: v[1] for k, v in worst.items()},
         seconds=time.perf_counter() - t_all, ok=True, card=st["card"])

    # knn(metric="l1") over the 1M set: the topk kernel and the plain route
    x, q, _, _ = cagra_data()
    qk = q[:1000]
    before = topk.launches
    t0 = time.perf_counter()
    kd, ki = knn(x, qk, K_MAIN, metric="l1", res=res)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    k_launches = topk.launches - before
    assert k_launches > 0, "knn(metric='l1') did not launch topk"
    set_wide_cols_threshold(1 << 30)
    try:
        pd, pi = knn(x, qk, K_MAIN, metric="l1", res=res)
        torch.cuda.synchronize()
    finally:
        set_wide_cols_threshold(None)
    l1_equal = torch.equal(pi, ki) and torch.equal(pd, kd)
    assert l1_equal, "knn(metric='l1') differs between the select routes"
    ref = (x[ki[:8].long()] - qk[:8, None]).abs().sum(-1)
    assert bool(torch.allclose(kd[:8], ref, rtol=1e-5)), "l1 distances are not the rows'"
    emit(phase="check", what="knn l1 on both select routes", n=N_MAIN, d=D_MAIN, m=1000,
         k=K_MAIN, seconds=k_s, topk_launches=k_launches, routes_equal=l1_equal, ok=True,
         card=st["card"])
    del x, q, kd, ki, pd, pi

    # masked_l2_nn and gram_matrix: 10,000 x 100,000 x 128 uniform rows
    xu, qu = st["main"]
    y = xu[:SLICE_N]
    y64 = y.double()
    yn64 = y64.square().sum(1)
    ends = torch.linspace(SLICE_N / 64, SLICE_N, 64, device=dev).round().long()
    group = torch.searchsorted(ends, torch.arange(SLICE_N, device=dev), right=True)
    adj = torch.rand((M_MAIN, 64), generator=g, device=dev) < 0.3
    adj[::97] = False
    ref2, refi, qn64 = [], [], []
    for i in range(0, M_MAIN, 1000):
        qb = qu[i:i + 1000].double()
        qn = qb.square().sum(1)
        d2 = (qn[:, None] + yn64[None, :] - 2.0 * qb @ y64.T).clamp_min(0.0)
        v, ix = torch.where(adj[i:i + 1000][:, group], d2, float("inf")).min(1)
        ref2.append(v)
        refi.append(torch.where(torch.isinf(v), -1, ix))
        qn64.append(qn)
    ref2, refi, qn64 = torch.cat(ref2), torch.cat(refi), torch.cat(qn64)
    none = torch.isinf(ref2)
    for sqrt in (False, True):
        md, mi = masked_l2_nn(qu, y, adj, ends.cpu().numpy(), sqrt=sqrt, res=res)
        torch.cuda.synchronize()
        assert torch.equal(mi[none].long(), refi[none]) and bool(torch.isinf(md[none]).all())
        # compared squared, within rtol 1e-5 plus the float32 expanded form's
        # error bound at the float64 pick
        got2 = md[~none].double() ** (2 if sqrt else 1)
        r2 = ref2[~none]
        tol = 1e-5 * r2 + 1e-5 + expanded_bound(qn64[~none], yn64[refi[~none]])
        m_err = float((got2 - r2).abs().max())
        assert bool(((got2 - r2).abs() <= tol).all()), f"masked_l2_nn off by {m_err}"
        # where the ids differ, the port's pick is as near within that tolerance
        diff = (mi.long() != refi) & ~none
        picked = (qu[diff].double() - y64[mi[diff].long()]).square().sum(1)
        assert bool(((picked - ref2[diff]).abs() <= tol[diff[~none]]).all()), "masked ids"
        assert bool(adj[diff][torch.arange(int(diff.sum()), device=dev),
                              group[mi[diff].long()]].all()), "a masked group was picked"
        emit(phase="check", what="masked_l2_nn vs float64", m=M_MAIN, n=SLICE_N, d=D_MAIN,
             groups=64, sqrt=sqrt, rows_without_group=int(none.sum()),
             ids_differing_within_tol=int(diff.sum()), max_abs_err_squared=m_err, ok=True,
             card=st["card"])
    kparams = [KernelParams(KernelType.LINEAR),
               KernelParams(KernelType.POLYNOMIAL, degree=3, gamma=1 / 128, coef0=1.0),
               KernelParams(KernelType.TANH, gamma=1 / 128, coef0=-0.25),
               KernelParams(KernelType.RBF, gamma=0.05)]
    for kp in kparams:
        g_err = 0.0
        for i in range(0, M_MAIN, 2500):
            got = gram_matrix(kp, qu[i:i + 2500], y, res=res).double()
            qb = qu[i:i + 2500].double()
            dot = qb @ y64.T
            if kp.kernel == KernelType.LINEAR:
                ref = dot
            elif kp.kernel == KernelType.POLYNOMIAL:
                ref = (kp.gamma * dot + kp.coef0) ** kp.degree
            elif kp.kernel == KernelType.TANH:
                ref = torch.tanh(kp.gamma * dot + kp.coef0)
            else:
                d2 = (qb.square().sum(1)[:, None] + yn64[None, :] - 2.0 * dot).clamp_min(0.0)
                ref = torch.exp(-kp.gamma * d2)
            tol = 1e-5 * ref.abs() + 1e-5
            if kp.kernel == KernelType.RBF:
                # the expanded distance's error bound through exp's slope
                tol = tol + kp.gamma * ref * expanded_bound(qb.square().sum(1)[:, None],
                                                            yn64[None, :])
            diff = (got - ref).abs()
            assert bool((diff <= tol).all()), (
                f"gram {kp.kernel.value} differs from float64 by {float(diff.max())}")
            g_err = max(g_err, float(diff.max()))
            del got, dot, ref, diff, tol
        emit(phase="check", what="gram_matrix vs float64", kernel=kp.kernel.value, m=M_MAIN,
             n=SLICE_N, d=D_MAIN, max_abs_err=g_err, rtol=1e-5, atol=1e-5, ok=True,
             card=st["card"])

    # eps_neighbors_l2sq: adjacency equal except pairs within the float32
    # expanded form's error of the radius
    eps = 16.0
    adj_e, vd = eps_neighbors_l2sq(qu, y, eps, res=res)
    assert adj_e.shape == (M_MAIN, SLICE_N) and vd.shape == (M_MAIN + 1,)
    assert torch.equal(vd[:-1], adj_e.sum(1, dtype=torch.int32)) and int(vd[-1]) == int(adj_e.sum())
    flips = 0
    for i in range(0, M_MAIN, 1000):
        qb = qu[i:i + 1000].double()
        d2 = (qb.square().sum(1)[:, None] + yn64[None, :] - 2.0 * qb @ y64.T).clamp_min(0.0)
        band = expanded_bound(qb.square().sum(1)[:, None], yn64[None, :])
        wrong = adj_e[i:i + 1000] != (d2 <= eps)
        assert not bool((wrong & ((d2 - eps).abs() > band)).any()), "eps adjacency differs"
        flips += int(wrong.sum())
    emit(phase="check", what="eps_neighbors_l2sq vs float64", m=M_MAIN, n=SLICE_N, d=D_MAIN,
         eps=eps, edges=int(vd[-1]), flips_within_band=flips, ok=True, card=st["card"])

    # kmeans.fit from init="array": the card against the CPU
    xk = cagra_data()[0][:SLICE_N]
    init = xk[:KMEANS_K]
    params = kmeans.KMeansParams(n_clusters=KMEANS_K, init="array", max_iter=KMEANS_ITERS)
    t0 = time.perf_counter()
    gpu = kmeans.fit(params, xk, centroids=init, res=res)
    torch.cuda.synchronize()
    k_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = kmeans.fit(params, xk.cpu(), centroids=init.cpu(), res=Resources(device="cpu"))
    k_cpu = time.perf_counter() - t0
    same = float((gpu.labels.cpu() == cpu.labels).float().mean())
    inertia_rel = abs(float(gpu.inertia) - float(cpu.inertia)) / float(cpu.inertia)
    emit(phase="check", what="kmeans.fit card vs cpu", n=SLICE_N, d=D_MAIN, k=KMEANS_K,
         max_iter=KMEANS_ITERS, n_iter_card=gpu.n_iter, n_iter_cpu=cpu.n_iter,
         labels_equal_share=same, inertia_card=float(gpu.inertia),
         inertia_cpu=float(cpu.inertia), inertia_rel_diff=inertia_rel,
         seconds_card=k_gpu, seconds_cpu=k_cpu, card=st["card"])
    assert same >= 0.999, f"k-means labels agree on {same} of the rows"
    assert inertia_rel <= 1e-4, f"k-means inertia differs by {inertia_rel}"
    del xk, init, gpu, cpu


def time_fused_modes(st):
    """``fused_knn``'s tensor-core modes (bf16, f32x3, s8) at the f32 row's
    shape (10,000 x 1M x 128, k=10), each beside its bound, its plain
    version and one library call per 2,500-query chunk; the QPS of
    ``knn`` in each mode through the public entry point (host clock around
    three synchronised batches); and what f32x3's bf16 hi/lo planes cost."""
    import torch

    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors.brute_force import knn
    from raft_tpu_torch.ops import fused_knn as fk

    fused_knn, fused_knn_plain = fk.fused_knn, fk.fused_knn_plain
    x, q = st["main"]
    m, n, d, k = M_MAIN, N_MAIN, D_MAIN, K_MAIN
    saved = fused_knn.launches, dict(fused_knn.launches_by_mode), fk.bf16_split.launches
    xb, qb = x.bfloat16(), q.bfloat16()
    xh, qh = xb, qb
    xl, ql = (x - xh.float()).bfloat16(), (q - qh.float()).bfloat16()
    xs, qs = as_bytes(x, 255.0, -128.0), as_bytes(q, 255.0, -128.0)
    yn = x.square().sum(1)
    yns = xs.float().square().sum(1)

    def lib_bf16():
        for i in range(0, m, 2500):
            s = torch.mm(qb[i:i + 2500], xb.T, out_dtype=torch.float32)
            torch.topk(yn - 2.0 * s, k, dim=1, largest=False)

    def lib_f32x3():
        for i in range(0, m, 2500):
            s = (torch.mm(qh[i:i + 2500], xh.T, out_dtype=torch.float32)
                 + torch.mm(qh[i:i + 2500], xl.T, out_dtype=torch.float32)
                 + torch.mm(ql[i:i + 2500], xh.T, out_dtype=torch.float32))
            torch.topk(yn - 2.0 * s, k, dim=1, largest=False)

    def lib_s8():
        for i in range(0, m, 2500):
            s = torch._int_mm(qs[i:i + 2500], xs.T)
            torch.topk(yns - 2.0 * s, k, dim=1, largest=False)

    cases = {   # mode: (dataset, queries, library, its calls, bytes/elt, peak op/s, products, compute)
        "bf16": (xb, qb, lib_bf16, "torch.mm (bf16, float32 out) + score + torch.topk",
                 2, H100_BF16_FLOPS, 1, "bfloat16"),
        "f32x3": (x, q, lib_f32x3, "3 x torch.mm (bf16 hi/lo, float32 out) + score + torch.topk",
                  4, H100_BF16_FLOPS, 3, "float32x3"),
        "s8": (xs, qs, lib_s8, "torch._int_mm (int8, int32 out) + score + torch.topk",
               1, H100_INT8_OPS, 1, "float32"),
    }
    res = Resources(device="cuda")
    st["fused_modes_t"] = {}
    for mode, (ds, qq, lib, lib_calls, elt, peak, products, compute) in cases.items():
        ms = cuda_ms(lambda: fused_knn(ds, qq, k, mode=mode), reps=3)
        plain_ms = cuda_ms(lambda: fused_knn_plain(ds, qq, k, mode=mode), reps=1)
        lib_ms = cuda_ms(lib, reps=1)
        ops = products * 2.0 * m * n * d
        nbytes = (n * d + m * d) * elt + n * 4 + m * k * 8
        t_ops, t_bytes = ops / peak, nbytes / H100_BYTES_S
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        # k = 1 and 64 beside k = 10: what the per-query lists' insertions cost
        row["ms_by_k"] = {kk: (ms if kk == k else
                               cuda_ms(lambda: fused_knn(ds, qq, kk, mode=mode), reps=2))
                          for kk in (1, k, 64)}
        row.update(fit_insert_tiles(mode, row["ms_by_k"]))
        knn(ds, qq, k, compute=compute, res=res)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            knn(ds, qq, k, compute=compute, res=res)
        torch.cuda.synchronize()
        row["knn_qps"] = 3 * m / (time.perf_counter() - t0)
        if mode == "f32x3":
            # the wrapper's split of both operands into bf16 hi/lo planes
            # (two bf16_split launches): bytes read and written, and time
            row["planes_ms"] = cuda_ms(lambda: fk._operands(q, x, "f32x3"), reps=3)
            row["planes_bytes"] = (n + m) * d * (4 + 2 * 2)
            split_bytes = n * d * (4 + 2 * 2)
            st["split_t"] = dict(
                ms=cuda_ms(lambda: fk.bf16_split(x), reps=5),
                plain_ms=cuda_ms(lambda: fk.bf16_split_plain(x), reps=2),
                library_ms=None, bound_ms=split_bytes / H100_BYTES_S * 1e3, bound_by="bytes")
            emit(phase="time", kernel="bf16_split", shape=[n, d], bytes=split_bytes,
                 card=st["card"], **st["split_t"])
        st["fused_modes_t"][mode] = row
        emit(phase="time", kernel="fused_knn_tc", mode=mode, shape=[m, n, d, k],
             library=lib_calls, ops=ops, bytes=nbytes, knn_compute=compute,
             library_over_kernel=lib_ms / ms, card=st["card"], **row)
    fused_knn.launches, fused_knn.launches_by_mode, fk.bf16_split.launches = saved


def fit_insert_tiles(mode, ms_by_k):
    """The insertion cost of ``_nsplit``'s warm-up term (tile-steps per
    list insertion per query row) that fits this run's kernel times at the
    main shape best: least squares of ms = c x ``_split_steps`` over k =
    1, 10 and 64, each at the splits the launcher took, the cost on a grid
    of 0.1. Printed beside the one in use (``_INSERT_TILES``)."""
    from raft_tpu_torch.ops import fused_knn as fk

    c = fk.fused_knn_config(mode, D_MAIN, K_MAIN)
    qt, nb, slots = c["qt"], c["nb"], c["slots"]
    mt, tiles = -(-M_MAIN // qt), -(-N_MAIN // nb)
    ks = sorted(ms_by_k)
    splits = [fk._nsplit(M_MAIN, N_MAIN, qt, slots, nb, fk._INSERT_TILES * kk) for kk in ks]
    ts = [ms_by_k[kk] for kk in ks]
    best = None
    for i in range(10, 301):
        steps = [fk._split_steps(mt, tiles, s, slots, nb, i / 10 * kk)
                 for s, kk in zip(splits, ks)]
        scale = sum(a * b for a, b in zip(steps, ts)) / sum(a * a for a in steps)
        resid = sum((scale * a - b) ** 2 for a, b in zip(steps, ts))
        if best is None or resid < best[0]:
            best = (resid, i / 10)
    return dict(nsplit_by_k=dict(zip(ks, splits)), insert_tiles=fk._INSERT_TILES,
                insert_tiles_fit=best[1])


def time_cagra_hop(st):
    """``cagra_hop`` at the main path's shape: 10,000 queries, a mid-search
    beam (the best 32 of a 10-hop search, the best 10 visited), cw=32,
    d=128, arena merge."""
    import torch

    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops.cagra_hop import cagra_hop, cagra_hop_plain

    index, q = st.pop("cagra")
    x, graph = index.dataset, index.graph
    m, d = q.shape
    it = CAGRA_ITOPK
    dev = q.device
    dist, ids = cagra.search(cagra.SearchParams(itopk_size=it, max_iterations=10), index, q, it)
    bd = torch.full((m, 128), float("inf"), device=dev)
    bi = torch.full((m, 128), -1, dtype=torch.int32, device=dev)
    bv = torch.ones((m, 128), dtype=torch.int32, device=dev)
    bd[:, :it], bi[:, :it], bv[:, 10:it] = dist, ids, 0
    _, _, _, pick, nocand = cagra_hop_plain(
        q, bd, bi, bv, torch.full((m, 32), -1, dtype=torch.int32, device=dev), x,
        torch.zeros((m, 32), dtype=torch.int32, device=dev), it, 1, merge="arena")
    nbrs = graph[pick.long().clamp_max(N_MAIN - 1)].reshape(m, 32).contiguous()
    valid = (1 - nocand).repeat_interleave(32, dim=1).contiguous()
    args = (q, bd, bi, bv, nbrs, x, valid, it, 1)
    saved = cagra_hop.launches
    ms = cuda_ms(lambda: cagra_hop(*args, merge="arena"), reps=20, warm=3)
    extract_ms = cuda_ms(lambda: cagra_hop(*args, merge="extract"), reps=20, warm=3)
    plain_ms = cuda_ms(lambda: cagra_hop_plain(*args, merge="arena"), reps=2)
    for a, b in zip(cagra_hop(*args, merge="arena"), cagra_hop_plain(*args, merge="arena")):
        assert torch.equal(a, b), "cagra_hop differs from its plain version at the timed shape"
    # the "xla" route's hop body on the same beam: its beam is (m, itopk + cw)
    # and holds distances without |q|^2
    qn = (q * q).sum(1, keepdim=True)
    xb_i = torch.cat([ids, torch.full((m, 32), -1, dtype=torch.int32, device=dev)], 1)
    xb_d = torch.cat([dist - qn, torch.full((m, 32), float("inf"), device=dev)], 1)
    xb_v = torch.zeros((m, it + 32), dtype=torch.bool, device=dev)
    xb_v[:, :10] = True
    dn2 = x.square().sum(1)
    xla_ms = cuda_ms(lambda: cagra._xla_hop(x, dn2, q, graph, xb_i, xb_d, xb_v, it, 1),
                     reps=10)
    # bytes: each distinct candidate row read once (queries share clusters,
    # so their neighbour lists overlap); operations: every valid pair scored
    ok = (nbrs >= 0) & (valid > 0)
    rows = int(ok.sum())
    distinct = int(torch.unique(nbrs[ok]).numel())
    nbytes = distinct * d * 4 + m * d * 4 + 3 * m * 128 * 4 * 2 + 2 * m * 32 * 4 + 2 * m * 4
    ops = 3 * rows * d
    t_bytes, t_ops = nbytes / H100_BYTES_S, ops / H100_F32_FLOPS
    st["hop_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       xla_hop_ms=xla_ms)
    emit(phase="time", kernel="cagra_hop", m=m, cw=32, d=d, itopk=it, merge="arena",
         pairs_scored=rows, distinct_rows=distinct, bytes=nbytes, flops=ops, extract_ms=extract_ms,
         library="none: no single PyTorch call computes a hop",
         xla_hop="the port's hop_impl='xla' hop body (gather, bmm, three stable sorts: "
                 "several calls)",
         card=st["card"], **st["hop_t"])
    cagra_hop.launches = saved


def time_pq_scan(st):
    """``pq_scan`` and ``pq_scan_topk`` at the main path's shape: one query
    tile of the 1M index (128 queries x 8 probes, 1,024 pairs), bfloat16
    LUT, k=40; beside the fused kernel, the unfused kernel route it replaced
    (``pq_scan``, bias, mask, ``topk``, the one-chunk merge) in this call."""
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.matrix.select_k import select_k_impl
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.pq_scan import (pack_keep_words, pq_scan, pq_scan_plain,
                                            pq_scan_topk, pq_scan_topk_plain)
    from raft_tpu_torch.ops.topk import topk

    index, q = st.pop("ivf")
    t, pc, k = 128, 8, IVF_K0
    qf = q[:t]
    probes = ivf_pq._coarse_probes(index, qf, pc).to(torch.int64)
    with full_f32():
        qrot = qf @ index.rotation.T
    lut, bias = ivf_pq._probe_luts(index, qrot, probes, *ivf_pq._codebooks_f32(index))
    pairs, s, cap = probes.numel(), index.pq_dim, index.capacity
    lut4 = lut.to(torch.bfloat16).contiguous()                  # (T, pc, S, K)
    lut = lut4.reshape(pairs, s, 16)
    plist = probes.reshape(-1).to(torch.int32).contiguous()
    probes32 = probes.to(torch.int32).contiguous()
    bias = bias.contiguous()
    codes, ids = index.list_codes, index.list_ids
    saved = pq_scan.launches, pq_scan_topk.launches, topk.launches
    ms = cuda_ms(lambda: pq_scan(codes, plist, lut), reps=50, warm=3)
    plain_ms = cuda_ms(lambda: pq_scan_plain(codes, plist, lut), reps=3)
    gathered = codes[plist.to(torch.int64)].to(torch.int64)[..., None]   # (pairs, cap, S, 1)
    lutf = lut.to(torch.float32)[:, None].expand(pairs, cap, s, 16)

    def library():
        # the same sum as two PyTorch calls over the codes gathered beforehand
        return torch.gather(lutf, 3, gathered).sum(dim=(2, 3))

    lib_ms = cuda_ms(library, reps=10)
    assert torch.equal(pq_scan(codes, plist, lut), pq_scan_plain(codes, plist, lut))
    lists = int(torch.unique(plist).numel())
    nbytes = lists * cap * s + pairs * s * 16 * 2 + pairs * 4 + pairs * cap * 4
    ops = pairs * cap * s
    t_bytes, t_ops = nbytes / H100_BYTES_S, ops / H100_F32_FLOPS
    st["pq_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=max(t_bytes, t_ops) * 1e3,
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit(phase="time", kernel="pq_scan", pairs=pairs, distinct_lists=lists, cap=cap, S=s,
         lut_dtype="bfloat16", bytes=nbytes, adds=ops,
         library="torch.gather + .sum over the gathered codes (two calls)",
         card=st["card"], **st["pq_t"])

    def fused():
        return pq_scan_topk(codes, ids, probes32, lut4, bias, k, True)

    def unfused():
        sc = pq_scan(codes, plist, lut).reshape(t, pc, cap) + bias[:, :, None]
        sid = ids[probes]
        sc = torch.where(sid >= 0, sc, float("inf"))
        v, i = topk(sc.reshape(t, -1), k, True, in_idx=sid.reshape(t, -1))
        return select_k_impl(v, i, k, True)     # the merge the route ran on one chunk

    def library_topk():
        # the scan as above, then torch.topk over the tile's pc x cap scores
        # (three calls; the bias and the mask are left out)
        return torch.topk(library().reshape(t, pc * cap), k, dim=1, largest=False)

    f_ms = cuda_ms(fused, reps=50, warm=3)
    f_plain_ms = cuda_ms(lambda: pq_scan_topk_plain(codes, ids, probes32, lut4, bias, k, True),
                         reps=3)
    unfused_ms = cuda_ms(unfused, reps=20, warm=3)
    f_lib_ms = cuda_ms(library_topk, reps=10)
    fv, fi = fused()
    pv, pi = pq_scan_topk_plain(codes, ids, probes32, lut4, bias, k, True)
    uv, ui = unfused()
    assert torch.equal(fv, pv) and torch.equal(fi, pi), "pq_scan_topk differs at the timed tile"
    assert torch.equal(fv, uv) and torch.equal(fi, ui), "fused and unfused differ at the tile"
    # bytes: each distinct probed list's codes and ids once, the LUTs, the
    # probe ids and biases, the (T, k) values and ids written
    f_bytes = lists * cap * (s + 4) + pairs * s * 16 * 2 + pairs * 8 + t * k * 8
    t_bytes = f_bytes / H100_BYTES_S
    # the same tile under the phase's 50% filter: the kernel against its
    # plain version, and its time; the bound gains the bitset's bytes
    words = pack_keep_words(st.pop("ivf_keep"))
    kv, ki = pq_scan_topk(codes, ids, probes32, lut4, bias, k, True, keep_words=words)
    pv, pi = pq_scan_topk_plain(codes, ids, probes32, lut4, bias, k, True, keep_words=words)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi), (
        "filtered pq_scan_topk differs at the timed tile")
    ff_ms = cuda_ms(lambda: pq_scan_topk(codes, ids, probes32, lut4, bias, k, True,
                                         keep_words=words), reps=50, warm=3)
    ff_bytes = f_bytes + words.numel() * 4
    st["pq_topk_t"] = dict(ms=f_ms, plain_ms=f_plain_ms, library_ms=f_lib_ms,
                           bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           unfused_route_ms=unfused_ms,
                           filtered=dict(keep_share=FILTER_KEEP[0], ms=ff_ms, bytes=ff_bytes,
                                         bound_ms=max(ff_bytes / H100_BYTES_S, t_ops) * 1e3))
    # by tile size: a block's latency (8 queries) against the card's
    # throughput (1,024 queries, many blocks an SM in turn)
    by_t = {}
    for tt in (8, 128, 1024):
        pt = ivf_pq._coarse_probes(index, q[:tt], pc)
        with full_f32():
            lt, bt = ivf_pq._probe_luts(index, q[:tt] @ index.rotation.T, pt.to(torch.int64),
                                        *ivf_pq._codebooks_f32(index))
        pt, lt = pt.to(torch.int32).contiguous(), lt.to(torch.bfloat16).contiguous()
        by_t[str(tt)] = cuda_ms(lambda: pq_scan_topk(codes, ids, pt, lt, bt.contiguous(), k, True),
                                reps=20, warm=2)
    emit(phase="time", kernel="pq_scan_topk", T=t, pc=pc, k=k, distinct_lists=lists, cap=cap,
         S=s, lut_dtype="bfloat16", bytes=f_bytes, adds=ops,
         library="torch.gather + .sum + torch.topk (three calls, no bias or mask)",
         unfused_route="pq_scan + bias + torch.where + topk + merge (the route before)",
         ms_by_queries=by_t, card=st["card"], **st["pq_topk_t"])
    pq_scan.launches, pq_scan_topk.launches, topk.launches = saved


def phase_times(st):
    import torch

    from raft_tpu_torch.distance.pairwise import full_f32
    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.topk import topk, topk_plain

    x, q = st.pop("main")
    m, n, d, k = M_MAIN, N_MAIN, D_MAIN, K_MAIN
    saved = fused_knn.launches, topk.launches
    ms = cuda_ms(lambda: fused_knn(x, q, k), reps=3)
    plain_ms = cuda_ms(lambda: fused_knn_plain(x, q, k), reps=1)

    def library():
        # the same function as two PyTorch calls per chunk of queries:
        # expanded-L2 product (torch.mm, full float32), then torch.topk
        yn = x.square().sum(1)
        for i in range(0, m, 2500):
            qb = q[i:i + 2500]
            with full_f32():
                dd = torch.addmm(yn[None, :], qb, x.T, alpha=-2.0)
            torch.topk(dd, k, dim=1, largest=False)

    lib_ms = cuda_ms(library, reps=1)
    flops = 2.0 * m * n * d
    nbytes = (n * d + m * d + n) * 4 + m * k * 8
    f_bound = max(flops / H100_F32_FLOPS, nbytes / H100_BYTES_S) * 1e3
    st["fused_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=f_bound,
                         bound_by="operations" if flops / H100_F32_FLOPS
                         >= nbytes / H100_BYTES_S else "bytes")
    emit(phase="time", kernel="fused_knn", shape=[m, n, d, k], ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, library="torch.addmm + torch.topk "
         "(two calls per 2,500-query chunk)", bound_ms=f_bound,
         bound_by=st["fused_t"]["bound_by"], card=st["card"])
    del x, q

    vals = st.pop("select")
    mm, nn = TOPK_SHAPE
    ms = cuda_ms(lambda: topk(vals, k), reps=5)
    plain_ms = cuda_ms(lambda: topk_plain(vals, k), reps=1)
    lib_ms = cuda_ms(lambda: torch.topk(vals, k, dim=1, largest=False), reps=5)
    nbytes = mm * nn * 4 + mm * k * 8
    t_bound = nbytes / H100_BYTES_S * 1e3
    st["topk_t"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=t_bound, bound_by="bytes")
    emit(phase="time", kernel="topk", shape=[mm, nn, k], ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, library="torch.topk", bound_ms=t_bound,
         bound_by="bytes", card=st["card"])
    del vals
    topk_sweep(st)
    fused_knn.launches, topk.launches = saved


def topk_sweep(st):
    """``topk`` against the plain route (``_select_k``) and ``torch.topk``
    over the rows of the index paths, and the crossover it gives: the
    smallest swept width at and above which the kernel beats the plain
    route at every swept k and row count (``WIDE_SELECT_COLS_DEFAULT``)."""
    import torch

    from raft_tpu_torch.ops.topk import topk

    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    wins = {}
    for n in SWEEP_COLS:
        for rows in SWEEP_ROWS:
            x = torch.rand((rows, n), generator=g, device=dev)
            for k in SWEEP_K:
                ov, oi = topk(x, k)
                pv, pi = sk._select_k(x, None, k, True)
                assert torch.equal(oi, pi) and torch.equal(ov, pv), (
                    f"topk and the plain route differ at {rows} x {n}, k={k}")
                ms = cuda_ms(lambda: topk(x, k), reps=5)
                plain_ms = cuda_ms(lambda: sk._select_k(x, None, k, True), reps=2)
                lib_ms = cuda_ms(lambda: torch.topk(x, k, dim=1, largest=False), reps=3)
                bound = (rows * n * 4 + rows * k * 8) / H100_BYTES_S * 1e3
                wins[(n, rows, k)] = ms < plain_ms
                emit(phase="sweep", kernel="topk", rows=rows, n=n, k=k, ms=ms,
                     plain_ms=plain_ms, torch_topk_ms=lib_ms, bound_ms=bound,
                     kernel_wins=ms < plain_ms, card=st["card"])
            del x
    crossover = None
    for n in reversed(SWEEP_COLS):
        if not all(w for (c, _, _), w in wins.items() if c == n):
            break
        crossover = n
    emit(phase="sweep", kernel="topk", crossover_cols=crossover,
         wide_select_cols_default=sk.WIDE_SELECT_COLS_DEFAULT,
         matches_default=crossover == sk.WIDE_SELECT_COLS_DEFAULT, card=st["card"])


def all_counts():
    """Every kernel wrapper's launch count (``fused_knn`` by mode)."""
    from raft_tpu_torch.ops.cagra_hop import cagra_hop
    from raft_tpu_torch.ops.fused_knn import bf16_split, fused_knn
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    return {"fused_knn": fused_knn.launches_by_mode["f32"],
            "fused_knn_tc": sum(v for m, v in fused_knn.launches_by_mode.items()
                                if m != "f32"),
            "bf16_split": bf16_split.launches, "topk": topk.launches,
            "pq_scan": pq_scan.launches, "pq_scan_topk": pq_scan_topk.launches,
            "cagra_hop": cagra_hop.launches}


def reset_all_counts():
    from raft_tpu_torch.ops.cagra_hop import cagra_hop
    from raft_tpu_torch.ops.fused_knn import bf16_split, fused_knn
    from raft_tpu_torch.ops.pq_scan import pq_scan, pq_scan_topk
    from raft_tpu_torch.ops.topk import topk

    for fn in (fused_knn, bf16_split, topk, pq_scan, pq_scan_topk, cagra_hop):
        fn.launches = 0
    fused_knn.launches_by_mode = dict.fromkeys(fused_knn.launches_by_mode, 0)


def row_equiv(d, i, rd, ri, rtol=1e-5, atol=1e-5):
    """Per-row ``knn_equiv``: True where a row's distances agree within
    tolerance (underfill slots exactly) and its ids agree, or differ only
    where distances tie within that tolerance."""
    import torch

    fin = torch.isfinite(rd)
    close = torch.where(fin, (d - rd).abs() <= atol + rtol * rd.abs(), d == rd)
    dist_ok = close.all(1) & (torch.isfinite(d) == fin).all(1)
    same_ids = (i == ri).all(1)
    same_set = (torch.sort(i, 1).values == torch.sort(ri, 1).values).all(1)
    sd, srd = torch.sort(d, 1).values, torch.sort(rd, 1).values
    ties = torch.where(torch.isfinite(srd), (sd - srd).abs() <= atol + rtol * srd.abs(),
                       sd == srd).all(1)
    return dist_ok & (same_ids | same_set | ties)


def add_serve_launches(st, launches):
    """Add one loaded window's launch counts to the serve phase's total."""
    total = st.setdefault("launches_serve", {})
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def serve_kernel_checks(st):
    """The kernels the serve path launches, at its small shapes, against
    their plain versions (phase 1's rules: bit for bit, f32 ``fused_knn`` by
    knn_equiv at 1e-5): ``fused_knn`` at m = 1 and 64 over the 1M set,
    ``pq_scan_topk`` on one query (an underfilled one and one with ties)
    and on 64 at the main tile's shape, the entry-pool ``topk`` at m = 1
    and 64 over 16,384 columns, and ``cagra_hop`` at m = 1."""
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.pq_scan import pq_scan_topk, pq_scan_topk_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    x, q = st["main"]
    err = 0.0
    for m in (1, 64):
        dv, di = fused_knn(x, q[:m], K_MAIN)
        torch.cuda.synchronize()
        rd, ri = fused_knn_plain(x, q[:m], K_MAIN)
        e = knn_equiv(dv, di, rd, ri, rtol=1e-5, atol=1e-5)
        err = max(err, e)
        # its time at the serving shape, beside the bound of reading the set
        t_ops = 2.0 * m * N_MAIN * D_MAIN / H100_F32_FLOPS
        t_bytes = ((N_MAIN * D_MAIN + m * D_MAIN + N_MAIN) * 4 + m * K_MAIN * 8) / H100_BYTES_S
        emit(phase="check", kernel="fused_knn", n=N_MAIN, d=D_MAIN, m=m, k=K_MAIN,
             mode="f32", max_abs_err=e, ok=True, serve=True,
             ms=cuda_ms(lambda: fused_knn(x, q[:m], K_MAIN), reps=5),
             bound_ms=max(t_ops, t_bytes) * 1e3,
             bound_by="operations" if t_ops >= t_bytes else "bytes", card=st["card"])
    st["fused_err"] = max(st.get("fused_err", 0.0), err)
    codes, ids, probes, lut, bias, _ = pq_topk_case(
        g, n_lists=PQ_LISTS, cap=PQ_CAP, s=64, t=64, pc=8, split=False,
        dt=torch.bfloat16, inner=False, top=300)
    for rows in (slice(0, 1), slice(1, 2), slice(0, 64)):
        args = (codes, ids, probes[rows].contiguous(), lut[rows].contiguous(),
                bias[rows].contiguous(), IVF_K0, True)
        v, i = pq_scan_topk(*args)
        torch.cuda.synchronize()
        pv, pi = pq_scan_topk_plain(*args)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi), (
            f"pq_scan_topk differs from its plain version at T={rows}")
        emit(phase="check", kernel="pq_scan_topk", n_lists=PQ_LISTS, cap=PQ_CAP, S=64,
             T=rows.stop - rows.start, pc=8, k=IVF_K0, lut_dtype="bfloat16",
             underfilled_rows=int((i == -1).any(1).sum()), max_abs_err=0.0,
             bit_equal=True, ok=True, serve=True)
    for m in (1, 64):
        v = torch.rand((m, 16_384), generator=g, device=dev)
        if m > 1:
            plant_topk_rows(v, g)
        for k in (K_MAIN, CAGRA_ITOPK, IVF_K0):
            check_topk(v, k, True)
        emit(phase="check", kernel="topk", shape=[m, 16_384], k=[K_MAIN, CAGRA_ITOPK, IVF_K0],
             select_min=True, max_abs_err=0.0, bit_equal=True, ok=True, serve=True)
    phase_hop_kernel(st, m=1, cases=[(32, 1, "arena", "f32", 128),
                                     (32, 1, "extract", "f32", 128),
                                     (64, 2, "arena", "f32", 128)])


COLD_PUBLISH = """
import json, sys
import torch
from raft_tpu_torch.core import Resources
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.serve import IndexRegistry

index = ivf_pq.load(sys.argv[1], res=Resources(device="cuda"))
sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
reg = IndexRegistry()
first = reg.publish("serve", index, search_params=sp, k=10)
again = reg.publish("serve", index, search_params=sp, k=10)
print(json.dumps({"first": first["warm"][10], "again": again["warm"][10]}))
"""


def serve_cold_publish(st, index):
    """First calls in a fresh process: the IVF-PQ index saved to a file,
    loaded by a new Python process that publishes it (the warm ladder: one
    search a bucket) and publishes it again. The first publish pays the
    CUDA context, cuBLAS handles, the allocator's first blocks and the
    cached kernel library's load; the build attribution beside each bucket
    says which were kernel builds (nvcc runs: ``programs``) and which
    cached loads (``cache_hits``)."""
    import shutil

    from raft_tpu_torch.neighbors import ivf_pq

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(root, "build", "serve")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "ivf_pq.bin")
    try:
        ivf_pq.save(index, path)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", COLD_PUBLISH, path], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                             text=True, timeout=300)
        proc_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert out.returncode == 0, out.stderr[-4000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    emit(phase="serve_first_call", index="ivf_pq (1M, n_probes 8, bf16 LUT)", k=K_MAIN,
         process_seconds=proc_s, first_publish=rep["first"], second_publish=rep["again"],
         card=st["card"])
    assert all(b["programs"] == 0 and b["cache_hits"] == 0 for b in rep["again"].values())


def serve_load(svc, name, pool, threads, per_thread, k, check_rows, swap=None):
    """Closed-loop load (bench.py:733 ``_row_serve``): ``threads`` threads
    each send ``per_thread`` one-row requests to ``name`` and wait for each
    answer; ``swap`` (a zero-argument publish) runs once half the requests
    are answered. Returns the per-request latencies, the answers of rows
    below ``check_rows`` by row (with the request id the service's request
    log holds them under), the failures, the load seconds and the swap's
    report."""
    import threading

    lats, results, failures = [], {}, []
    lock = threading.Lock()
    served = [0]
    half = threading.Event()

    def submitter(tid):
        mine_l, mine_r = [], {}
        for j in range(per_thread):
            qi = (tid + j * threads) % pool.shape[0]
            t0 = time.perf_counter()
            try:
                rid = f"{name}-{tid}-{j}"
                d, i = svc.submit(name, pool[qi:qi + 1], k, rid=rid).result(timeout=120)
            except Exception as e:  # every loss is counted and fails the phase
                with lock:
                    failures.append(f"{type(e).__name__}: {str(e)[:120]}")
                    served[0] += 1
                    if served[0] >= threads * per_thread // 2:
                        half.set()
                continue
            mine_l.append(time.perf_counter() - t0)
            if qi < check_rows:
                mine_r[qi] = (d[0], i[0], rid)
            with lock:
                served[0] += 1
                if served[0] >= threads * per_thread // 2:
                    half.set()
        with lock:
            lats.extend(mine_l)
            results.update(mine_r)

    workers = [threading.Thread(target=submitter, args=(t,)) for t in range(threads)]
    t_load = time.perf_counter()
    for w in workers:
        w.start()
    report = None
    if swap is not None:
        assert half.wait(timeout=600), "the load never reached its midpoint"
        report = swap()
    for w in workers:
        w.join(600)
        assert not w.is_alive(), "a submitter thread did not finish"
    return lats, results, failures, time.perf_counter() - t_load, report


def served_rows_equal(results, log, searchers, pool, k):
    """Each served row against its direct search at the shape that served
    it: the request log gives each request's bucket, and the rows served in
    bucket b are searched b at a time, zero-padded as a flush pads them (a
    GEMM's rounding depends on its shape, not on the other rows). A row
    passes if it equals (``row_equiv``) the answer of any of ``searchers``
    (the versions that may have served it). Returns the rows, the pass mask
    and the served ids."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rows = sorted(results)
    got_d = torch.from_numpy(np.stack([results[r][0] for r in rows])).to(dev)
    got_i = torch.from_numpy(np.stack([results[r][1] for r in rows])).to(dev)
    by_bucket = {}
    for n, r in enumerate(rows):
        by_bucket.setdefault(log.get(results[r][2])["bucket"], []).append(n)
    ok = torch.zeros(len(rows), dtype=torch.bool, device=dev)
    for searcher in searchers:
        pos, ref_d, ref_i = [], [], []
        for b, ns in sorted(by_bucket.items()):
            for s in range(0, len(ns), b):
                grp = ns[s:s + b]
                batch = np.zeros((b, pool.shape[1]), pool.dtype)
                batch[:len(grp)] = pool[[rows[n] for n in grp]]
                d, i = searcher(batch, k)
                pos += grp
                ref_d.append(d[:len(grp)])
                ref_i.append(i[:len(grp)])
        order = torch.argsort(torch.tensor(pos, device=dev))
        ok |= row_equiv(got_d, got_i, torch.cat(ref_d)[order], torch.cat(ref_i)[order])
    return rows, ok, got_i


def serve_window(before, after, stream):
    """Flushes, buckets and mean occupancy of one stream between two
    ``obs.to_json()`` snapshots."""
    from raft_tpu_torch.obs import metrics

    dl = metrics.delta(before, after)
    pre = "raft_tpu_serve_flush_total{bucket=\""
    buckets = {int(key[len(pre):].split("\"")[0]): int(v) for key, v in dl.items()
               if key.startswith(pre) and f'stream="{stream}"' in key}
    occ_sum = dl.get('raft_tpu_serve_batch_occupancy_sum{stream="%s"}' % stream, 0.0)
    occ_cnt = dl.get('raft_tpu_serve_batch_occupancy_count{stream="%s"}' % stream, 0)
    return sum(buckets.values()), dict(sorted(buckets.items())), occ_sum / max(occ_cnt, 1)


def flush_profile(st, kind, searcher, qhost, k):
    """One flush of ``searcher`` as the pipelined service runs it, at buckets
    1 and 64 on device-resident queries: the dispatch (search and the start
    of the copy to pinned host memory) under ``torch.cuda.
    set_sync_debug_mode("warn")``, whose warnings count the host syncs the
    dispatch makes; the milliseconds between CUDA events recorded before
    and after it (``event_ms``: the card's busy and idle time of the
    flush); the kernel launches it made; and, at bucket 64, the device's
    busy time and idle share over one flush (torch.profiler, table in
    ``serve_<kind>_flush_profile.txt``)."""
    import warnings

    import torch

    from raft_tpu_torch.serve.service import _start_copy_to_host

    dev = torch.device("cuda")
    out = {}
    for b in (1, SERVE_MAX_BATCH):
        qd = torch.as_tensor(qhost[:b]).to(dev)
        searcher(qd, k)                      # first calls of this shape
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_all_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                e0.record()
                _, done = _start_copy_to_host(searcher(qd, k))
                e1.record()
                dispatch_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode(0)
        done.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
        out[b] = dict(host_syncs=len(syncs), event_ms=e0.elapsed_time(e1),
                      dispatch_ms=dispatch_ms, wall_ms=wall_ms,
                      launches={kk: v for kk, v in all_counts().items() if v})
    prof = profile_batch(st, f"{kind} serve flush", f"serve_{kind}_flush_profile.txt",
                         lambda: _start_copy_to_host(searcher(qd, k))[1].synchronize(),
                         what=f"{SERVE_MAX_BATCH}-row flush")
    # the idle share of an unprofiled flush: the profiler slows the host
    out[SERVE_MAX_BATCH].update(
        device_busy_ms=prof["device_busy_ms"],
        idle_share=1.0 - prof["device_busy_ms"] / out[SERVE_MAX_BATCH]["wall_ms"])
    return out


def phase_serve(st):
    """Phase 4: ``raft_tpu_torch.serve`` on the card. The serve path's
    kernels at its small shapes (:func:`serve_kernel_checks`); then the JAX
    package's serving row (bench.py:733-869, ``serve_ivf_pq_100k``) at the
    IVF-PQ index of phase 2: the IVF-PQ + refine hook (search 4k candidates,
    refine to k; bench.py:785-800) behind ``SearchService(max_batch=64,
    max_wait_us=2000)``, 8 threads x 400 one-row requests at k=10, a second
    IVF-PQ build (outside the timed window) published at mid-load, once
    with ``pipeline_depth=2`` and once with 0; then brute force, IVF-Flat
    and CAGRA (itopk 32) published on the same service and served 400
    requests each. Every request must be answered, the swap must fail none,
    the loaded window must build no kernel (``obs.compile.attribution``),
    served rows must equal the serving index's direct search of the row
    (CAGRA: recall@10 >= 0.95) and IVF-PQ + refine's recall@10 must reach
    0.85. Prints QPS, the sequential batch-1 QPS, p50 / p99, occupancy,
    host syncs, device ms and launches per flush, and the memory ledger
    beside the second build's allocation delta."""
    import numpy as np
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.obs import RequestLog
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.serve import SearchService

    serve_kernel_checks(st)
    res = Resources(device="cuda")
    dev = torch.device("cuda")
    index, q = st["ivf"]
    serve_cold_publish(st, index)
    x, truth = st["ivf_x"], st["ivf_truth"]
    sp = ivf_pq.SearchParams(n_probes=8, lut_dtype="bfloat16")
    params = ivf_pq.IndexParams(n_lists=1024, pq_bits=4, pq_dim=64, seed=0)
    k = K_MAIN

    def pq_refine_hook(ix):
        def fn(queries, k_):
            qd = torch.as_tensor(queries, device=dev)
            _, cand = ivf_pq.search(sp, ix, qd, 4 * k_, res=res)
            return refine(x, qd, cand, k_, res=res)

        fn.kind, fn.dim, fn.query_dtype, fn.device = "ivf_pq+refine", D_MAIN, "float32", dev
        return fn

    pool = q.cpu().numpy()
    serving = pq_refine_hook(index)
    serving(pool[:1], k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(SERVE_SEQ):                       # no batcher: one row a call
        serving(pool[j:j + 1], k)[1].cpu()
    seq_qps = SERVE_SEQ / (time.perf_counter() - t0)

    # the swap target, built outside the timed window; its allocation delta
    # against the ledger's bytes for it
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    index2 = ivf_pq.build(params, x, res=res)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    ledger_bytes = obs.mem.unaccounted_index_bytes(index2)
    tok = obs.mem.account_index(index2, name="serve_v2")
    emit(phase="serve_ledger", index="ivf_pq (swap target)", ledger_bytes=ledger_bytes,
         allocation_delta_bytes=delta, ratio=ledger_bytes / max(delta, 1), tolerance=LEDGER_TOL,
         hbm=obs.mem.hbm_stats(), card=st["card"])
    assert abs(ledger_bytes - delta) <= LEDGER_TOL * delta, (ledger_bytes, delta)
    obs.mem.release(tok)
    swap_target = pq_refine_hook(index2)

    stream = f"serve.k{k}"
    other = None
    for depth in (2, 0):
        log = RequestLog(capacity=8192)
        svc = SearchService(max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                            max_queue_rows=4 * SERVE_MAX_BATCH * SERVE_THREADS,
                            pipeline_depth=depth, request_log=log)
        first = svc.publish("serve", serving, k=k)
        m_before = obs.to_json()
        reset_all_counts()
        with obs_compile.attribution() as rec:
            lats, results, failures, load_s, swap_rep = serve_load(
                svc, "serve", pool, SERVE_THREADS, SERVE_PER_THREAD, k, SERVE_CHECK,
                swap=lambda: svc.publish("serve", swap_target, k=k))
        torch.cuda.synchronize()
        launches = all_counts()
        flushes, buckets, occupancy = serve_window(m_before, obs.to_json(), stream)
        # the window's searcher calls: its flushes and the swap's warm ladder
        calls = flushes + len(swap_rep["warm"][k])
        n_req = SERVE_THREADS * SERVE_PER_THREAD
        rows, ok, got_i = served_rows_equal(results, log, (serving, swap_target), pool, k)
        rec10 = recall(got_i, truth[rows])
        lat_ms = np.sort(np.array(lats)) * 1e3
        emit(phase="serve", path="ivf_pq + refine (serve_ivf_pq_100k's protocol)",
             n=N_MAIN, d=D_MAIN, n_probes=8, k0=4 * k, k=k, pipeline_depth=depth,
             threads=SERVE_THREADS, requests=n_req, max_batch=SERVE_MAX_BATCH,
             max_wait_us=SERVE_WAIT_US, qps=(n_req - len(failures)) / load_s,
             seq_qps=seq_qps, serve_over_seq=(n_req - len(failures)) / load_s / seq_qps,
             p50_ms=float(lat_ms[len(lat_ms) // 2]),
             p99_ms=float(lat_ms[int(len(lat_ms) * 0.99) - 1]),
             mean_batch_occupancy=occupancy, flushes=flushes, flushes_by_bucket=buckets,
             launches=launches, search_calls=calls,
             launches_per_search_call={kk: v / calls for kk, v in launches.items() if v},
             swap={"failed": len(failures), "version": swap_rep["version"],
                   "warm": swap_rep["warm"][k]},
             builds_in_window=rec.summary(), first_publish_warm=first["warm"][k],
             staging=svc.staging_stats(), checked_rows=len(rows),
             rows_equal_direct_search=int(ok.sum()), recall_at_10=rec10,
             recall_floor=IVF_RECALL_FLOOR, card=st["card"])
        assert not failures, failures[:5]
        assert len(lats) == n_req
        assert rec.programs == 0 and rec.cache_misses == 0 and rec.cache_hits == 0, (
            rec.summary())
        assert bool(ok.all()), (f"{int((~ok).sum())} served rows differ from the direct "
                                f"search: rows {[rows[r] for r in torch.nonzero(~ok)[:5, 0]]}")
        assert rec10 >= IVF_RECALL_FLOOR, f"recall@10 {rec10} below {IVF_RECALL_FLOOR}"
        assert launches["pq_scan_topk"] > 0, "the served path did not launch pq_scan_topk"
        add_serve_launches(st, launches)
        if depth == 2:
            other = serve_other_kinds(st, svc, log)
        svc.shutdown()
        assert svc.registry.live_versions("serve") == (2,)

    profiles = {"ivf_pq+refine": flush_profile(st, "ivf_pq_refine", serving, pool, k),
                **other}
    emit(phase="serve_flush", per_kind=profiles, card=st["card"])
    emit(phase="serve_launches", launches=st["launches_serve"], card=st["card"])


def serve_other_kinds(st, svc, log):
    """Brute force, IVF-Flat and CAGRA on the running service: publish each,
    serve ``SERVE_OTHER_THREADS x SERVE_OTHER_PER_THREAD`` one-row requests,
    hold the answers against the index's direct search of each row at the
    shape that served it (CAGRA, whose entry pool is drawn per batch, by
    recall@10). Returns each kind's flush profile."""
    import numpy as np
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.core import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra
    from raft_tpu_torch.obs import compile as obs_compile

    res = Resources(device="cuda")
    x, qm = st["main"]
    cindex, qc = st["cagra"]
    findex, fsp = st["ivf_flat"]
    csp = cagra.SearchParams(itopk_size=CAGRA_ITOPK)
    kinds = {
        "brute_force": (brute_force.BruteForce("sqeuclidean").build(x, res=res), None, qm,
                        None),
        "ivf_flat": (findex, fsp, qc, None),
        "cagra": (cindex, csp, qc, st["cagra_truth"]),
    }
    n_req = SERVE_OTHER_THREADS * SERVE_OTHER_PER_THREAD
    profiles = {}
    for name, (ix, params, queries, truth) in kinds.items():
        pool = queries[:n_req].cpu().numpy()
        first = svc.publish(name, ix, search_params=params, k=K_MAIN)
        with svc.registry.lease(name) as v:
            searcher = v.searcher
        m_before = obs.to_json()
        reset_all_counts()
        with obs_compile.attribution() as rec:
            lats, results, failures, load_s, _ = serve_load(
                svc, name, pool, SERVE_OTHER_THREADS, SERVE_OTHER_PER_THREAD, K_MAIN, n_req)
        torch.cuda.synchronize()
        launches = {kk: v for kk, v in all_counts().items() if v}
        add_serve_launches(st, launches)
        flushes, buckets, occupancy = serve_window(m_before, obs.to_json(), f"{name}.k{K_MAIN}")
        rows, ok, got_i = served_rows_equal(results, log, (searcher,), pool, K_MAIN)
        lat_ms = np.sort(np.array(lats)) * 1e3
        out = dict(phase="serve", path=name, requests=n_req, threads=SERVE_OTHER_THREADS,
                   qps=(n_req - len(failures)) / load_s,
                   p50_ms=float(lat_ms[len(lat_ms) // 2]),
                   p99_ms=float(lat_ms[int(len(lat_ms) * 0.99) - 1]), flushes=flushes,
                   flushes_by_bucket=buckets, mean_batch_occupancy=occupancy,
                   launches=launches,
                   launches_per_flush={kk: v / flushes for kk, v in launches.items()},
                   builds_in_window=rec.summary(), first_publish_warm=first["warm"][K_MAIN],
                   failed=len(failures), checked_rows=len(rows),
                   rows_equal_direct_search=int(ok.sum()), card=st["card"])
        if truth is not None:
            out.update(recall_at_10=recall(got_i, truth[rows]),
                       recall_floor=CAGRA_RECALL_FLOOR)
        emit(**out)
        assert not failures, failures[:5]
        assert rec.programs == 0 and rec.cache_misses == 0 and rec.cache_hits == 0, (
            rec.summary())
        if truth is None:
            assert bool(ok.all()), f"{name}: {int((~ok).sum())} served rows differ"
        else:
            assert out["recall_at_10"] >= CAGRA_RECALL_FLOOR, out["recall_at_10"]
        if name == "brute_force":
            back_to_back(svc, searcher, qm)
        profiles[name] = flush_profile(st, name, searcher, pool, K_MAIN)
    return profiles


def back_to_back(svc, searcher, queries, blocks=20):
    """Full 64-row buckets submitted back to back, faster than they flush:
    the pipelined path rewrites each bucket's pinned staging buffers
    several times over, and every answer must equal the direct search of
    its block (a buffer rewritten before its upload landed would not)."""
    import torch

    dev = torch.device("cuda")
    pool = queries[:blocks * SERVE_MAX_BATCH].cpu().numpy()
    futs = [svc.submit("brute_force", pool[b * SERVE_MAX_BATCH:(b + 1) * SERVE_MAX_BATCH],
                       K_MAIN) for b in range(blocks)]
    got = [f.result(timeout=120) for f in futs]
    got_d = torch.cat([torch.from_numpy(d) for d, _ in got]).to(dev)
    got_i = torch.cat([torch.from_numpy(i) for _, i in got]).to(dev)
    ref = [searcher(pool[b * SERVE_MAX_BATCH:(b + 1) * SERVE_MAX_BATCH], K_MAIN)
           for b in range(blocks)]
    ok = row_equiv(got_d, got_i, torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref]))
    emit(phase="serve_back_to_back", blocks=blocks, rows_per_block=SERVE_MAX_BATCH,
         rows_equal_direct_search=int(ok.sum()), rows=int(ok.numel()),
         staging=svc.staging_stats().get(f"brute_force.k{K_MAIN}"))
    assert bool(ok.all()), f"{int((~ok).sum())} rows of back-to-back buckets differ"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="01234",
                    help="phases to run, e.g. 01 (default: all); 4 needs 2")
    ap.add_argument("--out", default=os.path.join("build", "profiles"),
                    help="directory for the IVF-PQ, CAGRA and IVF-Flat profile tables")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import raft_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = {"card": "not read", "out": args.out}
    phase_build(st)
    if "1" in args.phases:
        phase_kernels(st)
    if "4" in args.phases and "2" not in args.phases:
        print("chip_smoke: phase 4 serves phase 2's indexes; run it with 2",
              file=sys.stderr)
        return 2
    if "2" in args.phases:
        phase_main(st)
        phase_tc_path(st)
        phase_ivf(st)
        phase_cagra(st)
        phase_cagra_bytes(st)
        phase_ivf_flat(st)
        phase_slice(st)
        phase_ball_cover(st)
        phase_matrix_ops(st)
    if "4" in args.phases:
        phase_serve(st)
    if "3" in args.phases and "2" in args.phases:
        time_fused_modes(st)
        phase_times(st)
        time_pq_scan(st)
        time_cagra_hop(st)
    if all(p in args.phases for p in "123"):
        launches = st["launches"]
        serve = st.get("launches_serve", {})
        emit(kernels=[
            dict(name="fused_knn", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn.cu",
                 replaces="raft_tpu/ops/fused_knn.py:150", mode="f32",
                 launches=launches["fused_knn"], launches_serve=serve.get("fused_knn"),
                 max_abs_err=st["fused_err"], **st["fused_t"]),
            dict(name="fused_knn_tc", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn_tc.cu",
                 replaces="raft_tpu/ops/fused_knn.py:150", mode="bf16",
                 launches=sum(st["tc_launches"].values()),
                 launches_by_mode=st["tc_launches"], max_abs_err=st["tc_err"],
                 **{key: st["fused_modes_t"]["bf16"][key]
                    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                 modes=st["fused_modes_t"]),
            dict(name="bf16_split", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn_tc.cu",
                 replaces="raft_tpu/ops/fused_knn.py:139", launches=st["split_launches"],
                 launches_on="knn(compute='float32x3')", max_abs_err=0.0, **st["split_t"]),
            dict(name="topk", route="cuda", source="raft_tpu_torch/ops/csrc/topk.cu",
                 replaces="raft_tpu/ops/topk.py:91", launches=launches["topk"],
                 launches_ivf_flat=launches["topk_ivf_flat"],
                 launches_serve=serve.get("topk"),
                 launches_ball_cover={m: launches[f"topk_ball_cover_{m}"]
                                      for m in ("sqeuclidean", "haversine")},
                 max_abs_err=st["topk_err"], **st["topk_t"]),
            dict(name="pq_scan", route="cuda", source="raft_tpu_torch/ops/csrc/pq_scan.cu",
                 replaces="raft_tpu/ops/pq_scan.py:61", launches=launches["pq_scan"],
                 launches_on="ivf_pq.search, select_impl='xla'",
                 launches_funnel=launches["pq_scan_opq_anisotropic_4bit"],
                 max_abs_err=st["pq_err"], **st["pq_t"]),
            dict(name="pq_scan_topk", route="cuda", source="raft_tpu_torch/ops/csrc/pq_scan.cu",
                 replaces="raft_tpu/ops/pq_scan.py:61", launches=launches["pq_scan_topk"],
                 launches_serve=serve.get("pq_scan_topk"),
                 launches_filtered={str(f): launches[f"pq_scan_topk_filtered_{f}"]
                                    for f in FILTER_KEEP},
                 launches_codecs={n: launches[f"pq_scan_topk_{n}"]
                                  for n in ("per_cluster", "residual_scale_norm")},
                 max_abs_err=st["pq_topk_err"], **st["pq_topk_t"]),
            dict(name="cagra_hop", route="cuda",
                 source="raft_tpu_torch/ops/csrc/cagra_hop.cu",
                 replaces="raft_tpu/ops/cagra_hop.py:88", launches=launches["cagra_hop"],
                 launches_serve=serve.get("cagra_hop"),
                 launches_int8_rows=launches["cagra_hop_int8"],
                 max_abs_err=st["hop_err"], **st["hop_t"]),
        ])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
