"""setup_s: host seconds from the start of the process to the window's first
request: imports, the CUDA context, the kernel libraries, data made on the
card, the build and the warm-up."""


def read(run):
    return run.setup_s
