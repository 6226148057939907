"""A copy of the benchmark at a size the CPU runs in seconds, for the tests.

``tiny_root(dst)`` copies ``portbench/`` and ``BENCHMARK.json`` under
``dst`` and shrinks every configuration and traffic mix in the copy; the
cells, metrics and code stay as they are. ``run_cell`` runs one cell there
on the CPU (the look for a card skipped) and returns the result line.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SHRINK = {
    "configs/cagra-sift1m.json": {
        "data": {"n": 4000, "clusters": 20, "clumps": 4},
        "index": {"build": {"graph_degree": 16, "intermediate_graph_degree": 32},
                  "search": {"itopk_size": 32}},
    },
    "traffic/batch10k.json": {"batch": 250, "pool": 1000, "recall_sample": 300},
}


def _merge(dst: dict, src: dict) -> None:
    for key, val in src.items():
        if isinstance(val, dict):
            _merge(dst[key], val)
        else:
            dst[key] = val


def tiny_root(dst: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for rel, change in SHRINK.items():
        path = dst / "portbench" / rel
        doc = json.loads(path.read_text())
        _merge(doc, change)
        path.write_text(json.dumps(doc, indent=1))
    return dst


def run_cell(root: Path, workload: str, seed: int = 1, seconds: float = 0.6, trace: int = 0,
             fault=None):
    """(exit code, result dict or None, standard error) of one CPU run in a
    process of its own, so that what the run loads is what it imports."""
    code = ("import sys, torch; torch.set_num_threads(2); "
            f"sys.path.insert(0, {str(ROOT)!r}); from portbench import run; "
            f"sys.exit(run.main({['--workload', workload, '--seed', str(seed), '--seconds', str(seconds), '--trace', str(trace)]!r}, "
            f"root=__import__('pathlib').Path({str(root)!r}), device='cpu', fault={fault!r}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(root))
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (json.loads(lines[-1]) if lines else None), proc.stderr
