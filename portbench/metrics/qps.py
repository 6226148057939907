"""qps: every query the window answered over the window's seconds (host clock)."""


def read(run):
    w = run.win
    if w.get("batches") is None:
        return None
    return w["attempted"] / (w["t_close"] - w["t_open"])
