"""cagra.build.optimize_s: the seconds of the build's optimize phase (prune
and reverse merge), from ``raft_tpu_build_phase_seconds{phase=
"cagra/optimize"}`` as ``cagra.build.knn_graph_s`` reads its phase."""

from pathlib import Path

from portbench import cells

_phase = cells.load_module(Path(__file__).resolve().parents[2], "metrics",
                           "cagra.build.knn_graph_s").phase_seconds


def read(run):
    return _phase("cagra/optimize")
