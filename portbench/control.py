#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the program's
place, computed in bfloat16, the precision below the configuration's
float32 distances, and judged as a run's answers are.

    python3 portbench/control.py --config <name> --traffic <name> --seeds 1,2,3

For each seed it makes the configuration's rows and the traffic's query
pool as a run does, answers every pool query with ``reference.knn_lower``
and prints the checks of those answers (``check.judge``, with the run's
recall sample) as one JSON line a seed. The control has to come out not
correct: the smallest of a number over the seeds is the upper reading that
the configuration's limit of that number is set below. The benchmark's own
runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(cell, seed: int, root: Path, device) -> dict:
    import torch

    from portbench import cells, check, reference

    cfg, traffic = cell.config, cell.traffic
    gen = cells.load_module(root, "gen", cfg["generator"])
    x, pool = gen.make(cfg["data"], seed, device, int(traffic["pool"]))
    k = int(cfg["k"])
    d, ids = reference.knn_lower(x, pool, k)
    answers = check.Answers(torch.arange(pool.shape[0], device=device), d, ids)
    sample = check.recall_sample(pool.shape[0], int(traffic["recall_sample"]), seed, device)
    verdict = check.judge(x, pool, answers, k, cfg["limits"], sample)
    return {"cell": cell.name, "seed": seed, "correct": verdict.correct,
            "checked": verdict.checked_rows,
            "checks": {n: {"value": v, "limit": lim} for n, (v, lim) in verdict.numbers.items()}}


def main(argv=None, *, root: Path = ROOT, device=None, out=None) -> int:
    out = out or sys.stdout
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, help="a file of portbench/configs/")
    p.add_argument("--traffic", required=True, help="a file of portbench/traffic/")
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import torch

    from portbench import cells

    cell = cells.bare_cell(root, args.config, args.traffic)
    if device is None:
        if not torch.cuda.is_available():
            print("portbench: the control needs a CUDA device", file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(cell, seed, root, device)), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
