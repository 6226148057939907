"""Spans: named host intervals, recorded in memory and shown to profilers.

Counterpart of raft_tpu/core/tracing.py (the reference's NVTX RAII ranges,
cpp/include/raft/core/nvtx.hpp:139 common::nvtx::range). ``range(name)``
opens a span. A span is recorded while :func:`enable` is in force or while a
``torch.profiler`` session is open in the process, so any profiler capture
gets the program's spans. A record holds the name, the start and end on
``time.time_ns()`` (the clock the profiler's events carry: CPU and CUDA
runtime events of torch 2.11 on the H100 and of torch 2.13 on the CPU), the
span's id, its parent (the span open around it on the same thread, 0 for
none), its call (the id of the outermost span of that thread's stack, shared
by every span of one top-level call), the thread and the attributes its site
set (``span.set(key, value)``: ints or short strings). The buffer holds
:data:`MAX_SPANS` records; spans past it are dropped and counted
(:func:`dropped`). :func:`spans` returns the records, :func:`clear` empties
the buffer.

A recording span also opens a host annotation (the fast form of
``torch.profiler.record_function``, which a session that records CPU
activity shows on its host timeline) where a profiler session is open and
either :func:`enable` is in force or the machine has no CUDA device (where
every session records CPU activity). torch has no cheap test of a session's
activities, and in a CUDA-only session, such as the benchmark's, the
annotation would record nothing for ~1 µs a span on the H100's host. Under
:func:`enable` on a machine with a CUDA device a span also opens an NVTX
range (what Nsight shows). While nothing records, a site costs a flag check
and returns one shared no-op object.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# ``range`` (the reference's name) is intentionally NOT in __all__ so that a
# star-import cannot shadow the builtin; use ``tracing.range``.
__all__ = ["Span", "MAX_SPANS", "annotate", "enable", "disable", "spans", "clear", "dropped"]

# records kept; a 3 s profiler window of the CAGRA batch records ~14,000
MAX_SPANS = 1 << 17

_enabled = False
_nvtx = False
_annotate_sessions = None   # no CUDA device: every session records CPU activity
_records: list = []
_dropped = 0
_lock = threading.Lock()    # the buffer's bound and the dropped count
_ids = itertools.count(1)
_tls = threading.local()    # .stack: the thread's open spans; .tid: its id
_now = time.time_ns
_Annotation = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
               or torch.profiler.record_function)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int        # the enclosing span's id on the same thread; 0 for none
    call: int          # the id of the outermost span of the thread's stack
    thread: int
    attrs: dict | None


def enable() -> None:
    """Record spans (and open NVTX ranges where a CUDA device is present)."""
    global _enabled, _nvtx
    _nvtx = torch.cuda.is_available()
    _enabled = True


def disable() -> None:
    global _enabled, _nvtx
    _enabled = _nvtx = False


def spans() -> list:
    """The recorded spans (:class:`Span`), in the order they closed."""
    return [Span(*r) for r in list(_records)]


def clear() -> None:
    """Empty the buffer and zero the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def dropped() -> int:
    """Spans closed while the buffer was full since the last :func:`clear`."""
    return _dropped


def _annotates_sessions() -> bool:
    global _annotate_sessions
    if _annotate_sessions is None:
        _annotate_sessions = not torch.cuda.is_available()
    return _annotate_sessions


class _Off:
    """The object a site gets while nothing records. ``__enter__`` and
    ``__exit__`` are static, so a ``with`` binds no method object: half the
    cost of the off site."""

    __slots__ = ()

    @staticmethod
    def __enter__():
        return _OFF

    @staticmethod
    def __exit__(exc_type, exc, tb):
        return False

    def set(self, key, value) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "start", "id", "parent", "call", "_stack", "_ann", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self.attrs = None

    def set(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self):
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _tls.stack = []
            _tls.tid = threading.get_ident()
        self._stack = stack
        self.id = sid = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.call = top.id, top.call
        else:
            self.parent, self.call = 0, sid
        stack.append(self)
        self._ann = None
        if _profiler._is_profiler_enabled and (_enabled or _annotates_sessions()):
            self._ann = _Annotation(self.name)
            self._ann.__enter__()
        self._nvtx = _nvtx
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        end = _now()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        stack = self._stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        rec = (self.name, self.start, end, self.id, self.parent, self.call, _tls.tid, self.attrs)
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def range(name: str, *args):
    """A span (reference: common::nvtx::range, nvtx.hpp:139): a context
    manager whose ``set(key, value)`` attaches an attribute. printf-style
    ``args`` are interpolated into ``name`` only where the span records."""
    if _enabled or _profiler._is_profiler_enabled:
        return _On(name % args if args else name)
    return _OFF


def annotate(name: str | None = None):
    """Decorator form: the whole function as one span."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with range(label):
                return fn(*a, **kw)

        return wrapper

    return deco
