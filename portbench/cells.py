"""Find a cell's pieces by name.

``BENCHMARK.json`` names a cell's configuration and traffic mix. A
configuration is ``portbench/configs/<name>.json``; a traffic mix is
``portbench/traffic/<name>.json``; each metric is a reader module
``portbench/metrics/<name>.py``; a configuration's ``generator`` is
``portbench/gen/<name>.py``, its ``index.kind`` is
``portbench/indexes/<kind>.py``, and a traffic mix's ``loop`` is
``portbench/loops/<name>.py``. A later cell, mix or metric is therefore a
file of its own, and no existing file needs an edit to reach it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

PACKAGE = "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration and traffic files read. Raises ``KeyError`` for a name
    the file does not hold."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(one of {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(root / PACKAGE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without "workloads" goes wherever the end-to-end
    # metric it moves is reported
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def bare_cell(root: Path, config: str, traffic: str) -> Cell:
    """A cell of ``configs/<config>.json`` under ``traffic/<traffic>.json``
    that reports no metric, whether or not ``BENCHMARK.json`` names it: the
    control (``control.py``) runs configurations before they are cells."""
    return Cell(f"{config}+{traffic}", 1, read_json(root / PACKAGE / "configs" / f"{config}.json"),
                read_json(root / PACKAGE / "traffic" / f"{traffic}.json"), [], [])


def load_module(root: Path, kind: str, name: str):
    """The module ``root/portbench/<kind>/<name>.py``, loaded from its file
    (names may hold dots and dashes, so no import statement reaches it)."""
    path = root / PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    mod_name = f"{PACKAGE}_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
