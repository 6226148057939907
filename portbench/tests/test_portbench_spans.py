"""CPU tests of the per-layer metrics that read the program's own spans and
build phases: the interval arithmetic by hand, each reader on planted spans,
each reader silent where the program records nothing, and a whole traced run
of the tiny cell that prints them all.

    python -m pytest portbench/tests -q
"""

import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

ROOT = tiny.ROOT
sys.path.insert(0, str(ROOT))

from portbench import cells  # noqa: E402

SPAN_READERS = ["cagra.hops_per_batch", "cagra.hop_host_us", "device_idle.cagra_hops",
                "device_idle.outside_search"]


def _fake_run(kernels, t0, t1):
    from portbench.trace import Trace

    class R:
        pass

    r = R()
    r.trace = Trace(kernels, [], t0, t1)
    return r


def test_idle_interval_arithmetic_by_hand():
    hops = cells.load_module(ROOT, "metrics", "device_idle.cagra_hops")
    Span = __import__("raft_tpu_torch.core.tracing", fromlist=["Span"]).Span
    spans = [Span("x", s, e, 1, 0, 1, 0, None) for s, e in ((5, 20), (0, 8), (30, 40), (90, 120))]
    inside = hops.union(spans, 0, 100)
    assert inside == [[0, 20], [30, 40], [90, 100]]
    busy = [[2, 4], [10, 35], [95, 99]]
    # [0, 20] less [2, 4] and [10, 20]: 8; [30, 40] less [30, 35]: 5; [90, 100] less 4: 6
    assert hops.idle_ns(inside, busy) == 19
    assert hops.idle_ns([[0, 100]], busy) == 100 - 2 - 25 - 4


def test_span_readers_by_hand(monkeypatch):
    """Spans planted in the recorder: two searches of 3 and 5 hops in a
    window of 1,000 ns, each hop 100 ns holding a 60 ns flag read."""
    from raft_tpu_torch.core import tracing

    Span = tracing.Span
    planted = [Span("cagra.search", 0, 400, 1, 0, 1, 7, {"hops": 3, "stop": "max_iter"}),
               Span("cagra.search.hops", 100, 400, 2, 1, 1, 7, None),
               Span("cagra.search", 500, 900, 3, 0, 3, 7, {"hops": 5, "stop": "converged"}),
               Span("cagra.search.hops", 600, 900, 4, 3, 3, 7, None),
               Span("cagra.search", 5000, 6000, 9, 0, 9, 7, {"hops": 99})]   # outside
    for i, h0 in enumerate((100, 200, 300, 600, 700)):
        planted += [Span("cagra.hop", h0, h0 + 100, 10 + i, 2 if h0 < 400 else 4, 1, 7, None),
                    Span("cagra.hop.flag_read", h0 + 40, h0 + 100, 20 + i, 10 + i, 1, 7, None)]
    monkeypatch.setattr(tracing, "spans", lambda: planted)
    run = _fake_run([("k", 0, 50), ("k", 100, 150), ("k", 600, 700)], 0, 1000)
    got = {n: cells.load_module(ROOT, "metrics", n).read(run) for n in SPAN_READERS}
    assert got["cagra.hops_per_batch"] == 4.0
    assert got["cagra.hop_host_us"] == pytest.approx(0.04)
    # idle in the hop loops: [100, 400] less 50 busy, [600, 900] less 100
    assert got["device_idle.cagra_hops"] == pytest.approx(45.0)
    # idle outside both searches: [400, 500] and [900, 1000]
    assert got["device_idle.outside_search"] == pytest.approx(20.0)


@pytest.mark.parametrize("name", SPAN_READERS + ["cagra.build.knn_graph_s",
                                                 "cagra.build.optimize_s"])
def test_new_readers_are_silent_without_the_programs_spans(monkeypatch, name):
    """A program without the recorder or the build phases leaves these
    metrics out and raises nothing."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.obs import metrics

    monkeypatch.delattr(tracing, "spans")
    monkeypatch.setattr(metrics, "snapshot", lambda: {})
    run = _fake_run([("k", 0, 50)], 0, 1000)
    assert cells.load_module(ROOT, "metrics", name).read(run) is None
    run.trace = None
    assert cells.load_module(ROOT, "metrics", name).read(run) is None


def test_traced_run_reads_the_programs_spans_and_build_phases(tmp_path):
    """A CPU run's profiler records CPU activity, so the program's spans
    record in the traced window: every metric read from them, and the build
    phases, are in the line, and agree with the run's own numbers."""
    root = tiny.tiny_root(tmp_path)
    rc, res, err = tiny.run_cell(root, "cagra-sift1m-batch10k", seed=2**31 + 23, trace=1)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"cagra.hops_per_batch", "cagra.hop_host_us", "device_idle.cagra_hops",
            "device_idle.outside_search", "cagra.build.knn_graph_s",
            "cagra.build.optimize_s"} <= set(got)
    cfg = json.loads((root / "portbench" / "configs" / "cagra-sift1m.json").read_text())
    itopk = cfg["index"]["search"]["itopk_size"]
    assert 1 <= got["cagra.hops_per_batch"] <= itopk + 10       # the default hop budget
    assert got["cagra.hop_host_us"] > 0
    assert 0 < got["device_idle.cagra_hops"] + got["device_idle.outside_search"] <= 100.0
    build_s = float(re.search(r"build_s (\S+)", err).group(1))
    assert 0 < got["cagra.build.knn_graph_s"] + got["cagra.build.optimize_s"] <= build_s
