"""CPU tests of ``cagra.graph_hop_share``: the reader on planted chunk spans,
silent where the program records none, and in a traced run of the tiny cell
(where the CPU runs every chunk hop by hop).

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

ROOT = tiny.ROOT
sys.path.insert(0, str(ROOT))

from portbench import cells  # noqa: E402
from portbench.trace import Trace  # noqa: E402

NAME = "cagra.graph_hop_share"


class _Run:
    def __init__(self, t0, t1):
        self.trace = Trace([("k", t0, t1)], [], t0, t1)


def test_graph_hop_share_by_hand(monkeypatch):
    """Chunks of 8, 8 and 2 hops replayed and one of 8 run hop by hop in the
    window, one replayed chunk outside it: 18 of 26 hops."""
    from raft_tpu_torch.core import tracing

    Span = tracing.Span
    planted = [Span("cagra.hop.chunk", t, t + 50, i + 1, 0, 1, 7, {"hops": h, "graph": g})
               for i, (t, h, g) in enumerate(((0, 8, True), (100, 8, True), (200, 2, True),
                                              (300, 8, False), (5000, 8, True)))]
    monkeypatch.setattr(tracing, "spans", lambda: planted)
    assert cells.load_module(ROOT, "metrics", NAME).read(_Run(0, 1000)) == pytest.approx(
        100.0 * 18 / 26)


def test_graph_hop_share_is_silent_without_chunk_spans(monkeypatch):
    """A program that records no chunk spans (or no spans at all) leaves the
    metric out and raises nothing."""
    from raft_tpu_torch.core import tracing

    Span = tracing.Span
    monkeypatch.setattr(tracing, "spans", lambda: [
        Span("cagra.search", 0, 100, 1, 0, 1, 7, {"hops": 74, "stop": "max_iter"}),
        Span("cagra.hop", 10, 20, 2, 1, 1, 7, None)])
    reader = cells.load_module(ROOT, "metrics", NAME)
    assert reader.read(_Run(0, 1000)) is None
    monkeypatch.delattr(tracing, "spans")
    assert reader.read(_Run(0, 1000)) is None
    run = _Run(0, 1000)
    run.trace = None
    assert reader.read(run) is None


def test_traced_run_reads_the_graph_hop_share(tmp_path):
    """On the CPU no chunk replays a graph: the line reads 0%."""
    root = tiny.tiny_root(tmp_path)
    rc, res, err = tiny.run_cell(root, "cagra-sift1m-batch10k", seed=2**31 + 29, trace=1)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    assert res["metrics"][NAME]["value"] == 0.0
