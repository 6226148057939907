"""cagra.hops_per_batch: the mean ``hops`` (loop iterations that launched a
``cagra_hop``) of the ``cagra.search`` spans the program recorded in the
traced window; one search a batch. Spans come from
``raft_tpu_torch.core.tracing.spans()``, which records while the profiler
runs; None where the program records none (it has no recorder, or no such
site)."""


def traced_spans(run, *names):
    """The program's spans of ``names`` that overlap the traced window."""
    if run.trace is None:
        return []
    from raft_tpu_torch.core import tracing

    spans = getattr(tracing, "spans", None)
    if spans is None:
        return []
    t0, t1 = run.trace.t0_ns, run.trace.t1_ns
    return [s for s in spans() if s.name in names and s.end_ns > t0 and s.start_ns < t1]


def read(run):
    hops = [s.attrs["hops"] for s in traced_spans(run, "cagra.search")
            if s.attrs and "hops" in s.attrs]
    return sum(hops) / len(hops) if hops else None
