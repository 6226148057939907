"""cagra.hop_host_us: the median, over the traced ``cagra.hop`` spans, of a
hop's span less its ``cagra.hop.flag_read`` child, in microseconds: the host
time a hop costs outside the flag's device read (``cagra.hops_per_batch``
reads the spans)."""

import statistics
from pathlib import Path

from portbench import cells

_spans = cells.load_module(Path(__file__).resolve().parents[2], "metrics",
                           "cagra.hops_per_batch").traced_spans


def read(run):
    spans = _spans(run, "cagra.hop", "cagra.hop.flag_read")
    reads = {}
    for s in spans:
        if s.name == "cagra.hop.flag_read":
            reads[s.parent] = reads.get(s.parent, 0) + s.end_ns - s.start_ns
    host = [(s.end_ns - s.start_ns - reads.get(s.id, 0)) / 1e3
            for s in spans if s.name == "cagra.hop"]
    return statistics.median(host) if host else None
