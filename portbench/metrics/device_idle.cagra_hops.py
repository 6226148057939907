"""device_idle.cagra_hops: the share of the traced window, in percent, in
which no device activity ran while the host was inside a
``cagra.search.hops`` span (the hop loop): the spans' union intersected
with the window, less the trace's busy intervals
(``trace.Trace.busy_intervals``)."""

from pathlib import Path

from portbench import cells

_spans = cells.load_module(Path(__file__).resolve().parents[2], "metrics",
                           "cagra.hops_per_batch").traced_spans


def union(spans, t0, t1):
    """The union of the spans clipped to [t0, t1], as sorted disjoint
    [start, end] pairs."""
    out = []
    for s, e in sorted((max(s.start_ns, t0), min(s.end_ns, t1)) for s in spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle_ns(inside, busy):
    """Nanoseconds of ``inside`` that no interval of ``busy`` covers (both
    sorted and disjoint)."""
    idle, j = 0, 0
    for s, e in inside:
        covered = 0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += e - s - covered
    return idle


def read(run):
    spans = _spans(run, "cagra.search.hops")
    tr = run.trace
    if not spans or tr.window_s <= 0:
        return None
    inside = union(spans, tr.t0_ns, tr.t1_ns)
    return 100.0 * idle_ns(inside, tr.busy_intervals()) / (tr.t1_ns - tr.t0_ns)
