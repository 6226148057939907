"""device_idle.outside_search: the share of the traced window, in percent,
in which no device activity ran while the host was inside no
``cagra.search`` span (the caller's loop and the entry point's wrappers
between searches): the window's idle time less the idle time inside those
spans (``device_idle.cagra_hops`` holds the interval arithmetic)."""

from pathlib import Path

from portbench import cells

_root = Path(__file__).resolve().parents[2]
_spans = cells.load_module(_root, "metrics", "cagra.hops_per_batch").traced_spans
_hops = cells.load_module(_root, "metrics", "device_idle.cagra_hops")


def read(run):
    spans = _spans(run, "cagra.search")
    tr = run.trace
    if not spans or tr.window_s <= 0:
        return None
    busy = tr.busy_intervals()
    window = [[tr.t0_ns, tr.t1_ns]]
    inside = _hops.union(spans, tr.t0_ns, tr.t1_ns)
    idle = _hops.idle_ns(window, busy) - _hops.idle_ns(inside, busy)
    return 100.0 * idle / (tr.t1_ns - tr.t0_ns)
