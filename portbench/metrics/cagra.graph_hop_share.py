"""cagra.graph_hop_share: the share, in percent, of the traced searches' hops
that ran in ``cagra.hop.chunk`` spans whose ``graph`` is true (a chunk of the
hop loop replayed from a captured CUDA graph) over the hops of every traced
chunk (``cagra.hops_per_batch`` reads the spans). None where the program
records no chunk spans."""

from pathlib import Path

from portbench import cells

_spans = cells.load_module(Path(__file__).resolve().parents[2], "metrics",
                           "cagra.hops_per_batch").traced_spans


def read(run):
    chunks = [s.attrs for s in _spans(run, "cagra.hop.chunk") if s.attrs and "hops" in s.attrs]
    hops = sum(a["hops"] for a in chunks)
    if not hops:
        return None
    return 100.0 * sum(a["hops"] for a in chunks if a.get("graph")) / hops
