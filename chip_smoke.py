#!/usr/bin/env python3
"""Run raft_tpu_torch on one NVIDIA GPU and check it, kernel by kernel and
end to end.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases 01  # build and kernel checks only

Phases, each printing JSON lines:
  0. the card (name, power limit, count) and the kernels' build with nvcc;
  1. each kernel against its plain PyTorch version on the card, at the main
     path's widths: ``fused_knn`` over 1,000,000 x 128 rows (2,048 queries;
     modes f32 / f32x3 / bf16 / s8, l2 with and without sqrt, ip, k in
     {1, 10, 64}, a keep-mask that keeps fewer than k rows, a ragged n), and
     ``topk`` on a 10,000 x 100,003 float32 matrix (k in {10, 64, 128, 256},
     min and max, planted ties and infinities);
  2. the main path: ``BruteForce("sqeuclidean").build(x).search(q, k=10)``
     at 1M x 128 float32 (uniform data from seed 0, 10,000 queries from
     seed 1), checked against the plain version; then ``select_k`` on a
     10,000 x 100,003 matrix. Each path runs with the launch counts set to 0
     just before it and read just after;
  3. kernel times (CUDA events) beside their bound, their plain version's
     time and one library call's time.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

H100_F32_FLOPS = 67e12   # float32 on CUDA cores, H100 SXM data sheet
H100_BYTES_S = 3.35e12   # HBM3, H100 SXM data sheet

N_MAIN, D_MAIN, M_MAIN, K_MAIN = 1_000_000, 128, 10_000, 10
TOPK_SHAPE = (10_000, 100_003)


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
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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


def phase_kernels(st):
    import torch

    from raft_tpu_torch.ops.fused_knn import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.topk import topk, topk_plain

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
    ]
    err = 0.0
    for c in cases:
        c = dict(c)
        ragged, narrow = c.pop("ragged", False), c.pop("narrow", False)
        k = c.pop("k")
        if c["mode"] == "s8":
            ds, qq = xs8, qs8
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
        err = max(err, e)
        if "keep_mask" in c:
            assert bool((di[:, 5:] == -1).all()), "underfill ids are not -1"
        emit(phase="check", kernel="fused_knn", n=ds.shape[0], d=ds.shape[1],
             m=qq.shape[0], k=k, mode=c["mode"], metric=c["metric"], sqrt=c.get("sqrt", False),
             keep_mask="keep_mask" in c, max_abs_err=e, ok=True)
    st["fused_err"] = err
    del x, q, xs8, qs8

    m, n = TOPK_SHAPE
    v = torch.rand(TOPK_SHAPE, generator=g, device=dev)
    rows = torch.arange(m, device=dev)[:, None]
    cols = torch.randint(0, n, (m, 300), generator=g, device=dev)
    v[rows[:1000], cols[:1000]] = 0.0                # ties among the smallest
    v[rows[1000:2000], cols[1000:2000]] = 1.0        # ties among the largest
    v[rows[2000:3000], cols[2000:3000, :40]] = float("inf")
    v[rows[2000:3000], cols[2000:3000, 40:80]] = float("-inf")
    v[rows[3000:4000], cols[3000:4000, :40]] = 3.1e38   # clamps to 2.9e38
    v[rows[3000:4000], cols[3000:4000, 40:80]] = -3.3e38
    err = 0.0
    for k in (10, 64, 128, 256):
        for smin in (True, False):
            ov, oi = topk(v, k, select_min=smin)
            torch.cuda.synchronize()
            pv, pi = topk_plain(v, k, select_min=smin)
            assert torch.equal(oi, pi), f"topk ids differ k={k} min={smin}"
            assert torch.equal(ov, pv), f"topk values differ k={k} min={smin}"
            emit(phase="check", kernel="topk", shape=list(TOPK_SHAPE), k=k,
                 select_min=smin, max_abs_err=0.0, ok=True)
            del pv, pi
    st["topk_err"] = err


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
    fused_knn.launches, topk.launches = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0123",
                    help="phases to run, e.g. 01 (default: all)")
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
    st = {"card": "not read"}
    phase_build(st)
    if "1" in args.phases:
        phase_kernels(st)
    if "2" in args.phases:
        phase_main(st)
    if "3" in args.phases and "2" in args.phases:
        phase_times(st)
    if all(p in args.phases for p in "123"):
        launches = st["launches"]
        emit(kernels=[
            dict(name="fused_knn", route="cuda",
                 source="raft_tpu_torch/ops/csrc/fused_knn.cu",
                 replaces="raft_tpu/ops/fused_knn.py:150",
                 launches=launches["fused_knn"], max_abs_err=st["fused_err"],
                 **st["fused_t"]),
            dict(name="topk", route="cuda", source="raft_tpu_torch/ops/csrc/topk.cu",
                 replaces="raft_tpu/ops/topk.py:91", launches=launches["topk"],
                 max_abs_err=st["topk_err"], **st["topk_t"]),
        ])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
