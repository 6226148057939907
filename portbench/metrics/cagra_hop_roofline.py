"""cagra_hop_roofline: the least time the card could take for the traced
window's ``cagra_hop`` launches over their device time. Bytes a launch
(``roofline.cagra_hop_bytes``: the distinct candidate rows once, the query
rows, the beam in and out, the candidate ids and flags, the picks) are read
by searching each traced slice once more after the window with each
launch's inputs looked at; the launches (hops) are counted in the trace."""

from portbench import roofline

KERNEL = "cagra_hop_kernel"


def read(run):
    tr, slices = run.trace, run.win.get("traced_slices")
    work = getattr(run.adapter, "cagra_hop_work", None)
    if tr is None or not slices or work is None:
        return None
    kernel_s, launches = tr.kernel_seconds(KERNEL)
    if not launches:
        return None
    b = run.win["batch"]
    seen = [work(run.state, run.pool[off:off + b]) for off in sorted(set(slices))]
    seen = [s for s in seen if s is not None]
    if not seen:
        return None
    n = sum(s[2] for s in seen)
    nbytes = sum(s[0] for s in seen) / n * launches
    ops = sum(s[1] for s in seen) / n * launches
    return roofline.share_pct(roofline.least_seconds(nbytes, ops, roofline.FFMA_FLOPS), kernel_s)
