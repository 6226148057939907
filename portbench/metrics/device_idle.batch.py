"""device_idle: the share of the traced window in which no device activity
ran, in percent (``trace.Trace.idle_pct``)."""


def read(run):
    return run.trace.idle_pct() if run.trace is not None else None
