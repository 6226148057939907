"""Cooperative cancellation — the reference's raft::interruptible.

Counterpart of raft_tpu/core/interruptible.py (the reference's
cpp/include/raft/core/interruptible.hpp:71: a per-thread token whose
``synchronize`` turns stream waits into cancellation points, with ``cancel``
callable from any thread; and pylibraft's ``cuda_interruptible`` context
manager with its SIGINT hook). On the card the cancellation points are the
host's waits on the CUDA streams: :func:`synchronize` checks the token,
waits on the current stream of each CUDA device its tensors live on, and
checks again, so a loop that calls it between searches stops within one
search of another thread calling :func:`cancel`.
"""

from __future__ import annotations

import contextlib
import signal
import threading

import torch

__all__ = ["InterruptedException", "Token", "get_token", "synchronize", "yield_no_throw",
           "cancel", "interruptible"]


class InterruptedException(RuntimeError):
    """Raised at a cancellation point (ref: raft::interruptible::interrupted_exception)."""


class Token:
    """Per-thread cancellation token (ref: interruptible.hpp:71 — shared
    between the worker, which polls, and any controller, which cancels)."""

    def __init__(self) -> None:
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        """Flip the flag (ref: interruptible::cancel — safe from any thread)."""
        self._cancelled.set()

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def check(self) -> None:
        """Cancellation point: raise and clear if cancelled (ref:
        interruptible::yield — the flag resets on throw, so the thread can
        go on afterwards)."""
        if self._cancelled.is_set():
            self._cancelled.clear()
            raise InterruptedException("raft_tpu task cancelled")


_tokens: dict[int, Token] = {}
_tokens_lock = threading.Lock()


def get_token(thread_id: int | None = None) -> Token:
    """The token of the given (default: current) thread — ref:
    interruptible::get_token(). Entries of dead threads are purged on access
    (the reference frees its store through weak pointers), so a recycled
    thread ident never sees a stale cancelled token."""
    tid = threading.get_ident() if thread_id is None else thread_id
    with _tokens_lock:
        live = {t.ident for t in threading.enumerate()}
        live.add(tid)  # a controller may register a thread not seen yet
        for dead in [t for t in _tokens if t not in live]:
            del _tokens[dead]
        tok = _tokens.get(tid)
        if tok is None:
            tok = _tokens[tid] = Token()
        return tok


def cancel(thread_id: int | None = None) -> None:
    """Cancel the given (default: current) thread's token."""
    get_token(thread_id).cancel()


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)


def synchronize(*tensors) -> None:
    """Cancellable device wait (ref: interruptible::synchronize:83 — the
    stream sync that doubles as a cancellation point). Waits on the current
    stream of each distinct CUDA device among ``tensors`` (nested tuples,
    lists and dicts of tensors too); CPU tensors need no wait."""
    tok = get_token()
    tok.check()
    devices = {t.device for t in _leaves(tensors) if t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    tok.check()


def yield_no_throw() -> bool:
    """Non-throwing poll (ref: interruptible::yield_no_throw). Returns True
    if the token was cancelled (and clears it)."""
    tok = get_token()
    if tok.cancelled():
        tok._cancelled.clear()
        return True
    return False


@contextlib.contextmanager
def interruptible():
    """Context manager hooking SIGINT to this thread's token — the analogue
    of pylibraft's ``cuda_interruptible`` + ``synchronize`` pairing: Ctrl-C
    inside the block cancels at the next :func:`synchronize` instead of
    tearing the process down mid-search. The hook needs the main thread
    (signal semantics); elsewhere the block is a plain token scope."""
    tok = get_token()
    is_main = threading.current_thread() is threading.main_thread()
    prev = None
    if is_main:
        def handler(signum, frame):
            tok.cancel()

        prev = signal.signal(signal.SIGINT, handler)
    try:
        yield tok
    finally:
        if is_main and prev is not None:
            signal.signal(signal.SIGINT, prev)
