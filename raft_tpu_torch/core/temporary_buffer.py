"""Host-to-device staging helper.

Counterpart of raft_tpu/core/temporary_buffer.py (the reference's
raft::make_temporary_device_buffer,
cpp/include/raft/core/temporary_device_buffer.hpp): a scoped view that
stages host data on the device and, for a writable buffer, copies the
result back on release.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["temporary_device_buffer"]


class _Buf:
    def __init__(self, arr):
        self.array = arr


@contextlib.contextmanager
def temporary_device_buffer(host_array, writeback: bool = False, device=None):
    """Yield a buffer whose ``.array`` is ``host_array`` as a tensor on
    ``device`` (default: the default :class:`Resources`' device). With
    ``writeback`` the buffer's final ``.array`` (the caller may replace it)
    is copied back into ``host_array``, which must be a writable numpy
    array."""
    from .resources import Resources, default_resources

    res = default_resources() if device is None else Resources(device=device)
    buf = _Buf(res.put(host_array))
    try:
        yield buf
    finally:
        if writeback:
            out = buf.array
            if isinstance(out, torch.Tensor):
                out = out.detach().cpu().numpy()
            np.copyto(host_array, np.asarray(out))
