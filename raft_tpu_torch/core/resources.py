"""The raft_tpu_torch resource handle.

Counterpart of raft_tpu/core/resources.py (the reference's
raft::device_resources, core/device_resources.hpp:60). Under PyTorch the
handle names the ``torch.device`` every entry point places its tensors on,
the workspace budget the tiled GEMM paths size their tiles from, and the
hard budget for long-lived allocations. ``sync()`` is
``torch.cuda.synchronize`` (the reference's ``handle.sync_stream()``).

The device defaults to ``"cuda"``. A handle that asks for CUDA where there
is none raises :class:`RaftError` at its first use: an entry point never
runs on the CPU unless the caller asked for the CPU. ``mesh`` holds a
``torch.distributed`` ``DeviceMesh`` (the JAX handle's ``jax.sharding.Mesh``)
and ``set_comms`` / ``get_comms`` the communicator over it
(:mod:`raft_tpu_torch.comms`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .errors import expects

__all__ = ["Resources", "default_resources", "set_default_resources"]


@dataclasses.dataclass
class Resources:
    """Resource handle.

    Attributes:
      device: where entry points place and compute, ``"cuda"`` (default),
        ``"cuda:<i>"`` or ``"cpu"``, or a ``torch.device``.
      workspace_bytes: soft budget for temporary score matrices, read by
        ``distance.pairwise._choose_tile`` on the GEMM + top-k path. The
        fused kernel does not read it.
      memory_budget_bytes: hard budget for long-lived device allocations
        (``None`` = unenforced), read through ``obs.mem.gate`` at ``serve``
        publish and at every build before it spends anything: brute force
        prices its upload (n·d·min(itemsize, 4) bytes), IVF-Flat, IVF-PQ and
        CAGRA their index by ``obs.mem.plan()``, and a streamed build (a
        ``core.chunked.ChunkedReader`` dataset) its planned build peak at
        ``site="build_stream"``; a refusal raises ``MemoryBudgetError``.
      host_budget_bytes: hard budget for host memory (``None`` =
        unenforced): the streamed build's host peak (the stager's buffers
        plus the trainset gathered off the reader, priced by
        ``obs.mem.plan(streamed=True)``) is refused at
        ``site="build_stream/host"`` before the coarse trainer spends
        anything. An ``np.memmap`` corpus itself prices nothing here: its
        pages are disk-backed.
      mesh: the ``torch.distributed.device_mesh.DeviceMesh`` of a
        multi-device run (``None``: one device); ``device_count`` is its
        size.
    """

    device: Any = "cuda"
    mesh: Optional[Any] = None
    workspace_bytes: int = 2 << 30
    memory_budget_bytes: Optional[int] = None
    host_budget_bytes: Optional[int] = None
    _comms: Any = dataclasses.field(default=None, repr=False)

    # -- comms (reference: device_resources::get_comms / set_comms) -----------
    def set_comms(self, comms: Any) -> None:
        self._comms = comms

    def get_comms(self) -> Any:
        expects(self._comms is not None, "communicator was not initialized on this handle")
        return self._comms

    @property
    def comms_initialized(self) -> bool:
        return self._comms is not None

    @property
    def device_count(self) -> int:
        """Devices of the handle's mesh (1 without one)."""
        return self.mesh.size() if self.mesh is not None else 1

    @property
    def torch_device(self) -> torch.device:
        """The handle's device; raises if it is CUDA and there is none."""
        dev = torch.device(self.device)
        if dev.type == "cuda":
            expects(torch.cuda.is_available(),
                    "Resources(device=%r) asks for CUDA but no CUDA device is "
                    "available; pass Resources(device='cpu') to run on the CPU",
                    str(self.device))
        return dev

    def put(self, x, dtype=None) -> torch.Tensor:
        """Place an array (numpy, tensor or nested list) on the handle's
        device, optionally cast to ``dtype``."""
        dev = self.torch_device
        if not isinstance(x, torch.Tensor):
            a = np.ascontiguousarray(np.asarray(x))
            x = torch.from_numpy(a if a.flags.writeable else a.copy())
        return x.to(device=dev, dtype=dtype)

    def check_holds(self, device, what: str) -> None:
        """Raise unless ``device`` is the handle's device (a device with no
        index, such as ``"cuda"``, matches any of its type)."""
        mine, theirs = torch.device(self.device), torch.device(device)
        same = mine.type == theirs.type and (
            mine.index is None or theirs.index is None or mine.index == theirs.index)
        expects(same, "%s lives on %s but the handle names %s; move it or pass "
                "Resources(device=%r)", what, theirs, mine, str(theirs))

    def sync(self) -> None:
        """Wait for all work queued on the handle's device."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)


_default: Optional[Resources] = None


def default_resources() -> Resources:
    """Process-global default handle (device ``"cuda"``), created lazily."""
    global _default
    if _default is None:
        _default = Resources()
    return _default


def set_default_resources(res: Resources) -> None:
    global _default
    _default = res
