"""Whole runs of the benchmark on the CPU at a tiny size (``tiny.py``): each
cell is correct as the program runs it, comes out not correct with a fault
planted under its timed path and with the control in the program's place,
prints the contract's keys, and takes a new configuration, traffic mix and
metric as files of their own. The last test runs on the card only.

    python -m pytest portbench/tests -q
"""

import hashlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

ROOT = tiny.ROOT
WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
CONFIGS = sorted({(w["config"], w["traffic"]) for w in WORKLOADS})
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def _cell(root, name):
    sys.path.insert(0, str(ROOT))
    from portbench import cells

    return cells.load_cell(root, name)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, cell, trace):
    rc, res, err = tiny.run_cell(root, cell, seed=2**31 + 11, trace=trace)
    assert rc == 0, err[-3000:]
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    c = _cell(root, cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[:2] for line in tail] == [["check", n] for n in res["checks"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["alter_answer", "half_batch", "far_neighbours"])
def test_fault_under_the_timed_path_is_not_correct(root, cell, fault):
    rc, res, err = tiny.run_cell(root, cell, seed=7, fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, (fault, res["checks"])
    if fault == "far_neighbours":
        # valid ids with their own exact distances: only the neighbours are wrong
        failed = [n for n, c in res["checks"].items() if c["value"] > c["limit"]]
        assert failed == ["recall_miss"], res["checks"]


@pytest.mark.parametrize("config,traffic", CONFIGS)
def test_control_is_not_correct(root, config, traffic):
    from portbench import control

    out = io.StringIO()
    assert control.main(["--config", config, "--traffic", traffic, "--seeds", "3,4,5"],
                        root=root, device="cpu", out=out) == 0
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert len(lines) == 3 and not any(r["correct"] for r in lines)


def test_without_the_program_exits_and_prints_nothing(tmp_path):
    bare = tiny.tiny_root(tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=bare, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _digests(base: Path) -> dict:
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((base / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_are_files_of_their_own(tmp_path):
    base = tiny.tiny_root(tmp_path)
    before = _digests(base)
    pb = base / "portbench"
    cfg = json.loads((pb / "configs" / "cagra-sift1m.json").read_text())
    cfg.update(name="dummy-cfg")
    cfg["data"]["n"] = 3000
    (pb / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"loop": "batch_loop", "batch": 100, "pool": 300, "recall_sample": 100}))
    (pb / "metrics" / "dummy.queries.py").write_text(
        "def read(run):\n    return run.win['attempted']\n")
    bench = json.loads((base / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-cfg", "source": "a test", "reduced": ["n"],
                             "file": "portbench/configs/dummy-cfg.json", "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy.queries", "unit": "queries", "better": "higher",
                               "source": "host_clock", "layer": "a test", "moves": "qps",
                               "workloads": ["dummy-cell"]})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = tiny.run_cell(base, "dummy-cell", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and res["metrics"]["dummy.queries"]["value"] > 0
    after = _digests(base)
    assert all(after[p] == d for p, d in before.items())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("config,traffic", CONFIGS)
def test_control_on_the_card(root, card, config, traffic):
    from portbench import control

    out = io.StringIO()
    assert control.main(["--config", config, "--traffic", traffic, "--seeds", "3,4,5"],
                        root=root, device=card, out=out) == 0
    assert not any(json.loads(s)["correct"] for s in out.getvalue().splitlines())
