"""cagra.build.knn_graph_s: the seconds of the build's knn-graph phase (the
IVF-PQ self-search and refine), as the program observes them in
``raft_tpu_build_phase_seconds{phase="cagra/knn_graph"}`` of its default
metrics registry, after a device synchronise; the mean where the process
built more than once, None where it observed none."""

PHASE = "cagra/knn_graph"


def phase_seconds(phase):
    from raft_tpu_torch.obs import metrics

    meta = metrics.snapshot().get("raft_tpu_build_phase_seconds")
    for s in (meta or {}).get("series", []):
        if s["labels"] == {"phase": phase} and s["count"]:
            return s["sum"] / s["count"]
    return None


def read(run):
    return phase_seconds(PHASE)
