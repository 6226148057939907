"""Profiler range annotations.

Counterpart of raft_tpu/core/tracing.py (the reference's NVTX RAII ranges,
cpp/include/raft/core/nvtx.hpp:95 push_range / common::nvtx::range). A range
opens ``torch.profiler.record_function`` (the host timeline of a
``torch.profiler`` trace) and, when a CUDA device is present, an NVTX range
(what Nsight shows). Ranges are off until :func:`enable` is called: a
disabled range costs one module-flag check.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# ``range`` (the reference's name) is intentionally NOT in __all__ so that a
# star-import cannot shadow the builtin; use ``tracing.range`` or ``push_range``.
__all__ = ["push_range", "annotate", "enable", "disable"]

_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextlib.contextmanager
def range(name: str, *args):
    """RAII-style profiler range (reference: common::nvtx::range, nvtx.hpp:139).

    printf-style ``args`` are interpolated into ``name`` lazily, mirroring the
    reference's format-string labels.
    """
    if not _enabled:
        yield
        return
    label = name % args if args else name
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(label))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(label))
        yield


push_range = range  # non-shadowing alias


def annotate(name: str | None = None):
    """Decorator form: annotate a whole function as a profiler range."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with range(label):
                return fn(*a, **kw)

        return wrapper

    return deco
