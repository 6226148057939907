"""Cluster bootstrap.

Counterpart of raft_tpu/comms/bootstrap.py (reference: raft-dask's
NCCL-unique-id + UCX endpoint exchange, raft_dask/common/comms.py:85-230,
and mpi_comms' MPI-driven id broadcast). Under PyTorch each device is one
process of a ``torch.distributed`` world: :func:`initialize` joins this
process to the world over ``tcp://`` (the coordinator's address, the world
size and this process's rank, all named by the caller: nothing on a machine
announces a cluster), :func:`global_mesh` lays a ``DeviceMesh`` over it and
:func:`local_mesh` returns the communicator over the world.

A rank's device is ``cuda:(local_rank % torch.cuda.device_count())``
unless the caller names one (several ranks may name ``cuda:0``), or
``"cpu"``. The backend is named, never guessed from a failure: ``nccl`` on
CUDA and ``gloo`` on the CPU by default. NCCL refuses two ranks on one
card, so a world whose ranks share a card passes ``backend="gloo"``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..core.errors import expects
from .comms import Comms

__all__ = ["initialize", "local_mesh", "global_mesh", "shutdown", "rank_device",
           "device_of"]

# this process's world: its device, backend and every rank's device (by
# global rank), and the meshes laid over it
_WORLD: dict = {}


def _address(coordinator_address: str) -> str:
    return (coordinator_address if coordinator_address.startswith("tcp://")
            else f"tcp://{coordinator_address}")


def _resolve_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        expects(torch.cuda.is_available(),
                "initialize(device=%r) asks for CUDA but no CUDA device is available; "
                "pass device='cpu' to run on the CPU", str(device))
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda", timeout_s: float = 600.0) -> None:
    """Join this process to the world (reference analogue: Comms.init,
    raft_dask/common/comms.py:172). ``coordinator_address`` is
    ``"host:port"`` (rank 0 listens there); ``None`` reads ``MASTER_ADDR``
    / ``MASTER_PORT``, and ``num_processes`` / ``process_id`` default to
    ``WORLD_SIZE`` / ``RANK``. ``device``: ``"cuda"`` (the rank's card by
    its local rank), ``"cuda:<i>"`` or ``"cpu"``. ``backend``: ``"nccl"``
    or ``"gloo"``, by default ``nccl`` on CUDA and ``gloo`` on the CPU.
    ``timeout_s`` bounds every collective, so a dead rank fails its peers'
    calls instead of hanging them."""
    expects(not dist.is_initialized(), "this process already belongs to a world")
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _resolve_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    expects(backend in ("nccl", "gloo"), "backend must be 'nccl' or 'gloo', got %r", backend)
    expects(backend == "gloo" or dev.type == "cuda", "nccl runs on CUDA devices only")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=_address(coordinator_address),
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    devices = [None] * world
    dist.all_gather_object(devices, str(dev))
    _WORLD.update(device=dev, backend=backend, devices=[torch.device(d) for d in devices],
                  meshes={})


def shutdown() -> None:
    """Leave the world (``destroy_process_group``) and forget its meshes."""
    _WORLD.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device() -> torch.device | None:
    """This process's device, once :func:`initialize` has run."""
    return _WORLD.get("device")


def device_of(global_rank: int, device_type: str) -> torch.device:
    """The device of a rank of this world (the CUDA device by its rank where
    the world was not joined through :func:`initialize`)."""
    devices = _WORLD.get("devices")
    if devices is not None:
        return devices[global_rank]
    if device_type == "cuda":
        return torch.device("cuda", global_rank % torch.cuda.device_count())
    return torch.device(device_type)


def global_mesh(axis_names: tuple[str, ...] = ("data",), shape: tuple[int, ...] | None = None):
    """A ``DeviceMesh`` over every rank of the world (after
    :func:`initialize`); ``shape`` defaults to all ranks on the first
    axis. Every rank calls it (it may create process groups); the same
    arguments return the same mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    expects(dist.is_initialized(), "global_mesh needs initialize() first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    key = (tuple(axis_names), tuple(shape))
    meshes = _WORLD.setdefault("meshes", {})
    if key not in meshes:
        dev_type = _WORLD["device"].type if "device" in _WORLD else "cuda"
        meshes[key] = init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axis_names))
    return meshes[key]


def local_mesh(axis: str = "data", n_devices: int | None = None, device="cuda") -> Comms | None:
    """The communicator over the world this process belongs to, as a 1-D
    mesh named ``axis`` (the single-host analogue of a raft-dask session).
    ``n_devices`` takes the first ``n_devices`` ranks: every rank of the
    world calls, and ranks outside get ``None``. A process in no world
    starts a world of one on ``device`` first."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        initialize(f"127.0.0.1:{port}", 1, 0, device=device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    expects(0 < n <= world, "n_devices=%d must be in (0, %d] (the world's ranks)", n, world)
    if n == world:
        return Comms(global_mesh((axis,)), axis)
    key = ("local", axis, n)
    meshes = _WORLD.setdefault("meshes", {})
    if key not in meshes:
        dev_type = _WORLD["device"].type if "device" in _WORLD else "cuda"
        meshes[key] = DeviceMesh(dev_type, list(range(n)), mesh_dim_names=(axis,))
    return Comms(meshes[key], axis) if dist.get_rank() < n else None
