"""cagra.launches_per_batch: CUDA kernel launches in the traced window (copies
and fills left out) over the batches traced."""

_NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    tr, batches = run.trace, run.win.get("traced_slices")
    if tr is None or not batches:
        return None
    n = sum(1 for name, _, _ in tr.kernels if not name.startswith(_NOT_KERNELS))
    return n / len(batches)
