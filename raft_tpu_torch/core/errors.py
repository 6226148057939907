"""Error handling for raft_tpu_torch.

The port's own copy of raft_tpu/core/errors.py (the reference's
RAFT_EXPECTS / RAFT_FAIL, cpp/include/raft/core/error.hpp:168, :184).
Host-side validation raises :class:`RaftError`.
"""

from __future__ import annotations

__all__ = ["RaftError", "expects", "fail"]


class RaftError(RuntimeError):
    """Base exception for raft_tpu_torch (reference: raft::exception)."""


def expects(cond: bool, fmt: str, *args) -> None:
    """Host-side precondition check: raises :class:`RaftError` if ``cond``
    is falsy. ``fmt`` is a printf-style format consumed with ``*args``."""
    if not cond:
        raise RaftError(fmt % args if args else fmt)


def fail(fmt: str, *args) -> None:
    """Unconditional failure (reference: RAFT_FAIL)."""
    raise RaftError(fmt % args if args else fmt)
