#!/usr/bin/env python3
"""One run of one cell of the raft_tpu_torch benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix and metrics are files under ``portbench/``
found by name (``cells.py``). In order, a run:

1. sets up: pins the kernel-build caches inside the checkout, loads the
   kernel libraries, makes the rows and the query pool on the card from
   the seed, builds the index (``build_s``), warms the cell's own shapes;
2. measures for ``--seconds`` (``setup_s`` ends where this starts); with
   ``--trace 1`` the profiler covers the first part of the window
   (``trace.py``) and the per-layer metrics are read;
3. frees the program's state and judges every answer of the window against
   the plain reference (``check.py``);
4. prints the checks on standard error and one JSON line on standard
   output, and exits 0.

It exits with another code and prints no result where the card is missing
(or fewer cards than the cell asks for), and where JAX or the JAX package
was loaded into the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "raft_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_caches(root: Path) -> Path:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    return build / "kernels"


def banned_modules() -> list:
    """Loaded modules whose top-level name (whole) is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def card_power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class Run:
    """What one run holds; the loops fill it and the metric readers read it."""

    def __init__(self, cell, args, device, adapter, tracer):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds = args.seed, args.seconds
        self.device = device
        self.k = int(cell.config["k"])
        self.adapter = adapter
        self.tracer = tracer
        self.state = self.search = None
        self.pool = None
        self.win = {}
        self.trace = None
        self.verdict = None
        self.build_s = self.setup_s = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def read_metrics(entries, root, run) -> dict:
    from portbench import cells

    out = {}
    for m in entries:
        value = cells.load_module(root, "metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def open_cell(workload: str, root: Path, device=None):
    """(cell, device) after the look for the card, or (cell, None) where
    the cell's cards are missing. ``device`` given skips the look."""
    import torch

    from portbench import cells

    cell = cells.load_cell(root, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            return cell, None
        device = "cuda:0"
    return cell, torch.device(device)


def set_up(cell, args, root: Path, device, fault=None):
    """Everything before the window: the kernel libraries, the rows and the
    pool from the seed, the build (``build_s``), the loop's warm-up.
    Returns (run, loop, rows)."""
    from raft_tpu_torch import config as program_config

    from portbench import cells, faults, trace

    cuda = device.type == "cuda"
    program_config.enable_compilation_cache(str(pin_caches(root)))
    if cuda:
        from raft_tpu_torch.ops import _build

        _build.build_all()
    cfg, traffic = cell.config, cell.traffic
    gen = cells.load_module(root, "gen", cfg["generator"])
    adapter = cells.load_module(root, "indexes", cfg["index"]["kind"])
    loop = cells.load_module(root, "loops", traffic["loop"])
    tracer = trace.Tracer(bool(args.trace), args.seconds, cuda)
    run = Run(cell, args, device, adapter, tracer)
    x, run.pool = gen.make(cfg["data"], args.seed, device, int(traffic["pool"]))
    run.sync()
    t0 = time.perf_counter()
    run.state = adapter.build(cfg, x, device)
    run.sync()
    run.build_s = time.perf_counter() - t0
    run.search = faults.wrap(adapter.searcher(run.state), fault, x)
    tracer.warm(run.sync)
    loop.prepare(run)
    return run, loop, x


def main(argv=None, *, root: Path = ROOT, device=None, fault=None, out=None, err=None) -> int:
    """Run the cell; ``device`` and ``fault`` are for the tests only (a CPU
    run skips the look for a card; a fault is planted under the timed path)."""
    out, err = out or sys.stdout, err or sys.stderr
    args = parse_args(argv)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    pin_caches(root)

    import torch

    from portbench import check

    cell, device = open_cell(args.workload, root, device)
    if device is None:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
        return 2
    cuda = device.type == "cuda"
    run, loop, x = set_up(cell, args, root, device, fault)
    traffic, cfg = cell.traffic, cell.config

    run.win = loop.measure(run)
    run.setup_s = run.win["t_open"] - T_START
    run.trace = run.tracer.result
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    layer = read_metrics(cell.per_layer, root, run) if args.trace else {}

    # the program's state goes before the reference runs beside the rows
    answers = run.win.pop("answers")
    run.state = run.search = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = None
    if "recall_sample" in traffic:
        sample = check.recall_sample(run.pool.shape[0], int(traffic["recall_sample"]),
                                     args.seed, device)
    run.verdict = check.judge(x, run.pool, answers, run.k, cfg["limits"], sample)
    metrics = layer if args.trace else read_metrics(cell.end_to_end, root, run)

    found = banned_modules()
    if found:
        print("portbench: JAX or the JAX package was loaded: " + ", ".join(found), file=err)
        return 3

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": run.verdict.correct, "attempted": int(run.win["attempted"]),
              "failed": int(answers.unanswered), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in run.verdict.numbers.items()}

    card = card_power_limit() if cuda else None
    print(f"portbench: cell {cell.name} seed {args.seed} card {card or dev['kind']} "
          f"build_s {run.build_s} setup_s {run.setup_s} window_s "
          f"{run.win['t_close'] - run.win['t_open']} answers checked "
          f"{run.verdict.checked_rows} recall {run.verdict.recall}", file=err)
    ends = run.win.get("batch_ends")
    if ends and len(ends) >= 4:
        gaps = [b - a for a, b in zip([run.win["t_open"]] + ends[:-1], ends)]
        half = len(gaps) // 2
        print(f"portbench: {len(gaps)} batches, host seconds a batch: first half "
              f"{sum(gaps[:half]) / half} second half {sum(gaps[half:]) / (len(gaps) - half)} "
              f"max {max(gaps)}", file=err)
    for name, (v, lim) in run.verdict.numbers.items():
        print(f"check {name} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
