"""Logging for raft_tpu_torch.

The port's own copy of raft_tpu/core/logger.py (the reference's spdlog
wrapper, cpp/include/raft/core/logger-ext.hpp:34, logger-macros.hpp:44-95).
The standard :mod:`logging` module gives runtime level, pattern and sink
control; this module pins down the logger name, the level vocabulary
(including the TRACE level spdlog has and stdlib lacks) and small helpers.
"""

from __future__ import annotations

import logging
import sys

__all__ = [
    "logger",
    "set_level",
    "basic_config",
    "OFF",
    "CRITICAL",
    "ERROR",
    "WARN",
    "INFO",
    "DEBUG",
    "TRACE",
]

# Level vocabulary mirrors the reference's RAFT_LEVEL_* (logger-macros.hpp).
OFF = logging.CRITICAL + 10
CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARN = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
TRACE = logging.DEBUG - 5

logging.addLevelName(TRACE, "TRACE")

logger = logging.getLogger("raft_tpu_torch")
logger.addHandler(logging.NullHandler())


def set_level(level: int) -> None:
    """Set the global raft_tpu_torch log level (reference: logger::set_level)."""
    logger.setLevel(level)


# the handler basic_config installed, so repeat calls replace instead of stack
_handler: logging.Handler | None = None

DEFAULT_PATTERN = "[%(levelname)s] [%(asctime)s] [raft_tpu_torch] %(message)s"


def basic_config(level: int = INFO, pattern: str = DEFAULT_PATTERN,
                 stream=None) -> logging.Logger:
    """One-call formatted stderr logging (reference: logger::set_pattern +
    the callback sink, logger-ext.hpp:34).

    Installs (or replaces, on repeat calls) a single StreamHandler on the
    ``raft_tpu_torch`` logger with ``pattern`` as a stdlib logging format
    string, sets ``level``, and stops propagation so records are not
    double-printed through the root logger. Returns the logger. Pass a
    ``stream`` to redirect (any write()-able object works).
    """
    global _handler
    if _handler is not None:
        logger.removeHandler(_handler)
    _handler = logging.StreamHandler(stream or sys.stderr)
    _handler.setFormatter(logging.Formatter(pattern))
    logger.addHandler(_handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


def trace(msg: str, *args) -> None:
    logger.log(TRACE, msg, *args)
