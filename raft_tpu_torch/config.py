"""Global configuration: output types and the persistent kernel-build cache.

Counterpart of raft_tpu/config.py (pylibraft.config,
python/pylibraft/pylibraft/config.py:15-46): :func:`set_output_as` installs
a global conversion that :func:`auto_convert_output` applies to the
array-returning entry points (``pairwise_distance``, ``select_k``, ``knn``
and the IVF-Flat, IVF-PQ and CAGRA ``search``). Index objects stay tensors
on their device.

The port's native output is a ``torch.Tensor``, so its default, ``"torch"``,
converts nothing; ``"numpy"`` copies each tensor to a host ndarray, and a
callable gets each tensor. ``"jax"`` is refused: the port never imports JAX.

Only the outermost call converts. The decorator counts its depth per
thread, so an entry point that calls another converts once, at the end;
the port's own callers (the serve hooks, the mutable and sharded indexes,
the tuner, k-means, the CAGRA build) call ``fn.native`` or run inside
:func:`keep_tensors` and get tensors on the card under any setting.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable

__all__ = ["set_output_as", "get_output_as", "auto_convert_output",
           "enable_compilation_cache", "keep_tensors"]

_output_as: str | Callable = "torch"
_state = threading.local()


def enable_compilation_cache(path: str | None = None) -> str:
    """Keep the kernels' builds in ``path`` across processes (the
    warm-build story).

    The port's only compile is the nvcc build of a kernel source
    (:mod:`raft_tpu_torch.ops._build`); each built library is cached by the
    hash of its source, headers and flags. This points that cache at
    ``path`` (default: the repository's ``build/kernels/``), so a second
    process building or searching the same kernels loads them instead of
    running nvcc. Libraries this process already loaded stay loaded.

    Returns the cache directory in effect.
    """
    from .core.logger import logger
    from .ops import _build

    out = str(_build.set_build_dir(path or _build.DEFAULT_BUILD_DIR))
    logger.info("persistent kernel-build cache enabled at %s", out)
    return out


def set_output_as(output: str | Callable) -> None:
    """Set the global output conversion (ref: pylibraft config.set_output_as,
    config.py:20-46 — there 'cupy' / 'torch' / callable; here 'torch' (no
    conversion), 'numpy' or a callable)."""
    global _output_as
    if isinstance(output, str) and output == "jax":
        raise ValueError("output_as='jax' is not available: raft_tpu_torch never "
                         "imports JAX; use 'torch', 'numpy' or a callable")
    if not (output in ("numpy", "torch") or callable(output)):
        raise ValueError("output_as must be 'torch', 'numpy', or a callable")
    _output_as = output


def get_output_as() -> str | Callable:
    return _output_as


def _to_numpy(t):
    import torch

    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _convert(value: Any) -> Any:
    import torch

    if isinstance(_output_as, str) and _output_as == "torch":
        return value
    if isinstance(value, torch.Tensor):
        if callable(_output_as):
            return _output_as(value)
        return _to_numpy(value)
    if isinstance(value, tuple):
        return tuple(_convert(v) for v in value)
    # lists and dicts of tensors (multi-output returns) convert element-wise
    if isinstance(value, list):
        return [_convert(v) for v in value]
    if isinstance(value, dict):
        return {k: _convert(v) for k, v in value.items()}
    return value


@contextlib.contextmanager
def keep_tensors():
    """Run the block as one call deep: decorated entry points called inside
    it return tensors whatever the output setting."""
    depth = getattr(_state, "depth", 0)
    _state.depth = depth + 1
    try:
        yield
    finally:
        _state.depth = depth


def auto_convert_output(fn: Callable) -> Callable:
    """Decorator applying the global conversion to the return value of the
    outermost decorated call on a thread (ref: pylibraft config
    auto_convert_output). ``wrapper.native`` calls ``fn`` and returns
    tensors."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        depth = getattr(_state, "depth", 0)
        _state.depth = depth + 1
        try:
            out = fn(*args, **kwargs)
        finally:
            _state.depth = depth
        return out if depth else _convert(out)

    @functools.wraps(fn)
    def native(*args, **kwargs):
        with keep_tensors():
            return fn(*args, **kwargs)

    wrapper.native = native
    return wrapper
