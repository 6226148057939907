"""CPU tests of the benchmark's parts: the generators, the byte counters, the
reference, the names in BENCHMARK.json and the loader by name.

    python -m pytest portbench/tests -q
"""

import ast
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import cells, check, reference, roofline, run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_generator_same_seed_same_rows():
    params = {"n": 3000, "dim": 128, "clusters": 7, "clumps": 4, "intrinsic_dim": 16,
              "cluster_std": 0.5, "fine_std": 0.15}
    mod = cells.load_module(ROOT, "gen", "sift_lid")
    x1, q1 = mod.make(params, 2**31 + 7, "cpu", 100)
    x2, q2 = mod.make(params, 2**31 + 7, "cpu", 100)
    x3, _ = mod.make(params, 2**31 + 8, "cpu", 100)
    assert x1.shape == (3000, 128) and q1.shape == (100, 128)
    assert torch.equal(x1, x2) and torch.equal(q1, q2)
    assert not torch.equal(x1, x3)


def test_cagra_hop_bytes_by_hand():
    # the kernel table's row 4 at 10,000 queries, cw = 32, d = 128, ~200k
    # rows, a beam of 64 live lanes
    nbytes = roofline.cagra_hop_bytes(200_000, 10_000, 32, 1, 128, 4, 64)
    assert nbytes == 200_000 * 512 + 10_000 * 512 + 3 * 10_000 * 64 * 8 + 2 * 10_000 * 32 * 4 \
        + 2 * 10_000 * 4
    assert roofline.least_seconds(nbytes, roofline.cagra_hop_ops(320_000, 128),
                                  roofline.FFMA_FLOPS) == pytest.approx(nbytes / 3.35e12)


def test_share_is_silent_without_kernel_time():
    assert roofline.share_pct(1e-3, 0.0) is None
    assert roofline.share_pct(1e-3, 2e-3) == pytest.approx(50.0)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_exact_knn_matches_numpy(dtype):
    g = torch.Generator().manual_seed(5)
    x = (torch.rand((3000, 16), generator=g) * 200).to(dtype)
    q = (torch.rand((40, 16), generator=g) * 200).to(dtype)
    d, ids = reference.exact_knn(x, q, 7, screen=16)
    xn, qn = x.numpy().astype(np.float64), q.numpy().astype(np.float64)
    full = ((qn[:, None, :] - xn[None, :, :]) ** 2).sum(-1)
    want = np.sort(full, axis=1)[:, :7]
    # float64 sums in another order than numpy's: equal to its last bits
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(np.take_along_axis(full, ids.numpy(), 1), want, rtol=1e-12)


def test_judge_reads_each_fault():
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (500, 8), generator=g).to(torch.uint8)
    pool = torch.randint(0, 256, (50, 8), generator=g).to(torch.uint8)
    d, ids = reference.exact_knn(x, pool, 5)
    qidx = torch.arange(50)
    limits = {"dist_gap": 1e-6, "recall_miss": 0.05}

    def verdict(dd, ii, unanswered=0):
        return check.judge(x, pool, check.Answers(qidx, dd.float(), ii, unanswered), 5, limits,
                           torch.arange(50))

    good = verdict(d, ids)
    assert good.correct and good.recall == 1.0
    moved = ids.clone()
    moved[:, 0] = (moved[:, 0] + 1) % 500
    assert verdict(d, moved).numbers["dist_gap"][0] > 1e-3
    twice = ids.clone()
    twice[:, 1] = twice[:, 0]
    assert verdict(d, twice).numbers["invalid"][0] == 50
    assert not verdict(d, ids, unanswered=1).correct
    # the next query's neighbours with their exact distances to this one
    far = ids.roll(-1, dims=0)
    fd, pos = torch.sort(reference.distances(x, pool, far), dim=1)
    wrong = verdict(fd, torch.gather(far, 1, pos))
    assert wrong.numbers["dist_gap"][0] == 0 and wrong.numbers["invalid"][0] == 0
    assert wrong.numbers["recall_miss"][0] > 0.5 and not wrong.correct
    none = check.judge(x, pool, check.Answers(qidx[:0], d[:0].float(), ids[:0]), 5, limits,
                       torch.arange(50))
    assert none.numbers["recall_miss"][0] == 1.0 and not none.correct


def test_benchmark_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"] for m in b["end_to_end"]}
    cells_of = {m["name"]: set(m.get("workloads", [w["name"] for w in b["workloads"]]))
                for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells_of[m["moves"]], m["name"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert "setup_s" in {m for m in e2e if w["name"] in cells_of[m]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for name in metric_names:
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").is_file(), name


def test_banned_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["raft_tpu_torch_like"] = sys
        sys.modules["jaxtyping"] = sys
        assert run.banned_modules() == [m for m in sorted(saved)
                                        if m.split(".")[0] in run.BANNED]
        sys.modules["raft_tpu.neighbors"] = sys
        assert "raft_tpu.neighbors" in run.banned_modules()
    finally:
        for m in ("raft_tpu_torch_like", "jaxtyping", "raft_tpu.neighbors"):
            sys.modules.pop(m, None)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name", ["reference.py", "check.py", "roofline.py"])
def test_reference_imports_nothing_of_the_program(name):
    assert _imports(ROOT / "portbench" / name) <= {"__future__", "contextlib", "dataclasses",
                                                   "torch", "numpy", "portbench"}


def test_nothing_imports_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "raft_tpu"}, path
