"""The communicator: the reference's comms_t surface over torch.distributed.

Counterpart of raft_tpu/comms/comms.py. The JAX ``Comms`` is a (Mesh, axis)
pair whose collectives run inside ``shard_map``; PyTorch runs one process
per device, and its counterpart of ``jax.sharding.Mesh`` is
:class:`torch.distributed.device_mesh.DeviceMesh`. So here every rank is a
process, a collective runs eagerly on that rank's tensors, and
:meth:`Comms.shard_map` is the JAX drivers' calling convention: each rank
calls the returned function with the *global* inputs.

| reference comms_t          | here (every rank calls)                     |
|----------------------------|---------------------------------------------|
| allreduce(SUM/MIN/MAX/PROD)| allreduce (``all_reduce``; PROD by JAX's    |
|                            | sign / zero rule over a sum of logs)        |
| bcast(root)                | bcast (``broadcast`` from the axis's root)  |
| reduce(root)               | reduce: the value lands on every rank       |
| allgather / allgatherv     | allgather (stacked, or ``tiled``)           |
| gather(v)(root)            | gather: a full copy on every rank           |
| reducescatter              | reducescatter (sum, the leading dim split)  |
| device_send/recv, sendrecv | ppermute / shift (batched send and recv)    |
| device_multicast_sendrecv  | alltoall (the leading dim split)            |
| comm_split                 | the Comms over another dimension of the mesh|
| barrier                    | barrier: an all-reduce of 1 (returns size)  |
| sync_stream                | ``torch.cuda.synchronize`` of the rank's    |
|                            | device                                      |
| get_rank / get_size        | rank() (an int) / size()                    |

The backend is the process group's (``bootstrap.initialize`` names it:
``nccl`` on CUDA, ``gloo`` on the CPU). Several ranks that share one card
must run on ``gloo``, which NCCL's refusal of a duplicate device forces. In
torch 2.11 gloo takes CUDA tensors in every collective used here but its
point-to-point sends and receives (a CUDA operand crashes the rank), so
``ppermute`` and ``shift`` move their operand to the host and back
explicitly (:data:`GLOO_HOST_ONLY`), each move counted in
:meth:`Comms.stats` as a host hop.

Each executed collective counts in ``raft_tpu_collective_calls_total`` and
``raft_tpu_collective_bytes_total`` (labels ``op``, ``axis``, ``size``; the
bytes are this rank's operand). The JAX package counts a collective once
per traced program; eager torch has no trace, so here a collective counts
each time it runs. With metrics disabled the count is one flag check.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import expects, fail

__all__ = ["Comms", "PartitionSpec", "P", "shard_along", "replicated", "GLOO_HOST_ONLY"]

# the collectives that torch 2.11's gloo cannot run on CUDA tensors (its
# send / recv write from the operand's address as if it were host memory):
# their operands go to the host and back (a host hop) on a gloo group
GLOO_HOST_ONLY = frozenset({"ppermute"})

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


class PartitionSpec(tuple):
    """How an input or output of :meth:`Comms.shard_map` lies over the
    mesh, one entry per tensor dimension: a mesh dimension's name (the
    tensor is split into that dimension's blocks along it) or ``None``
    (whole). ``P()`` is replicated. The JAX class's spelling; an entry
    naming several mesh dimensions at once is not taken."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


def _payload_bytes(x) -> int:
    """This rank's operand bytes (a scalar counts its tensor's size)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(math.prod(getattr(x, "shape", ()))) * 4


def _rank_device(mesh) -> torch.device:
    """The calling rank's device in ``mesh``: the one ``bootstrap.initialize``
    gave it, else the mesh type's current device."""
    from . import bootstrap

    dev = bootstrap.rank_device()
    if dev is not None and dev.type == mesh.device_type:
        return dev
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


_X32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device``. Arrays and Python values take 32-bit types
    where they come as 64-bit ones, as ``jnp.asarray`` makes them; tensors
    keep theirs."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        a = a.astype(_X32.get(a.dtype, a.dtype), copy=False)
        x = torch.from_numpy(np.ascontiguousarray(a) if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype)


def _block(x, mesh, name: str, dim: int):
    """The calling rank's block of ``x`` along ``dim`` over the mesh
    dimension ``name``."""
    count = mesh.size(mesh.mesh_dim_names.index(name))
    rows = x.shape[dim]
    expects(rows % count == 0, "dimension %d (%d) must divide the mesh dimension %r (%d)",
            dim, rows, name, count)
    b = rows // count
    return x.narrow(dim, mesh.get_local_rank(name) * b, b)


def shard_along(mesh, axis: str, x, dim: int = 0):
    """The calling rank's block of ``x`` along ``dim`` over the mesh
    dimension ``axis``, on the rank's device (the JAX function places the
    whole array sharded; here each rank holds its own block)."""
    return _block(_as_tensor(x, _rank_device(mesh)), mesh, axis, dim).contiguous()


def replicated(mesh, x):
    """``x`` whole on the calling rank's device."""
    return _as_tensor(x, _rank_device(mesh))


@dataclasses.dataclass(frozen=True)
class Comms:
    """Communicator bound to one dimension of a device mesh (reference:
    comms_t, core/comms.hpp:242): the process group
    ``mesh.get_group(axis)``. Every rank of the group calls each collective
    with its own operand."""

    mesh: object                 # torch.distributed.device_mesh.DeviceMesh
    axis: str = "data"
    # this communicator's executed collectives: calls, bytes, host hops
    _stats: dict = dataclasses.field(default_factory=lambda: dict(calls=0, bytes=0,
                                                                  host_hops=0),
                                     compare=False, hash=False, repr=False)

    def __post_init__(self):
        names = self.mesh.mesh_dim_names or ()
        expects(self.axis in names, "axis %r not in mesh %s", self.axis, self.mesh)

    # -- observability ------------------------------------------------------
    def _record(self, op: str, x) -> None:
        """One executed collective (docs/observability.md's counters)."""
        from ..obs import metrics as _m

        if not _m._enabled:
            return
        nbytes = _payload_bytes(x)
        self._stats["calls"] += 1
        self._stats["bytes"] += nbytes
        lbl = dict(op=op, axis=self.axis, size=self.size())
        _m.counter("raft_tpu_collective_calls_total",
                   "collectives staged per traced program").inc(1, **lbl)
        _m.counter("raft_tpu_collective_bytes_total",
                   "per-shard payload bytes of staged collectives",
                   unit="bytes").inc(nbytes, **lbl)

    def stats(self) -> dict:
        """Executed collectives, their bytes (both counted while metrics are
        enabled) and host hops (always counted)."""
        return dict(self._stats)

    # -- topology ----------------------------------------------------------
    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def size(self) -> int:
        """Clique size (reference: get_size)."""
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))

    def rank(self) -> int:
        """The calling rank's position on the axis (reference: get_rank)."""
        return self.mesh.get_local_rank(self.axis)

    @property
    def device(self) -> torch.device:
        """The calling rank's device."""
        return _rank_device(self.mesh)

    @property
    def devices(self) -> list:
        """The device of each rank of the axis, in rank order."""
        from . import bootstrap

        return [bootstrap.device_of(r, self.mesh.device_type)
                for r in dist.get_process_group_ranks(self.group)]

    def comm_split(self, axis: str) -> "Comms":
        """The communicator over another dimension of the same mesh
        (reference: comm_split :329)."""
        return Comms(self.mesh, axis)

    def put(self, x, dtype=None) -> torch.Tensor:
        """``x`` (numpy, tensor or nested list) on the calling rank's device."""
        return _as_tensor(x, self.device, dtype)

    # -- the operand's route ------------------------------------------------
    def _out(self, op: str, t: torch.Tensor):
        """The tensor a collective ``op`` runs on: ``t`` itself, or its host
        copy where the group's gloo cannot take CUDA tensors (a host hop)."""
        if t.is_cuda and op in GLOO_HOST_ONLY and self.backend == "gloo":
            self._stats["host_hops"] += 1
            return t.cpu()
        return t

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def _gather(self, t: torch.Tensor, tiled: bool) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size())]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts) if tiled else torch.stack(parts)

    # -- collectives ---------------------------------------------------------
    def allreduce(self, x, op: str = "sum"):
        """Reference: allreduce :371 with op_t{SUM,PROD,MIN,MAX} :34."""
        t = self.put(x)
        self._record("allreduce", t)
        return self._allreduce(t, op)

    def _allreduce(self, t: torch.Tensor, op: str):
        if op in _REDUCE_OPS:
            return self._all_reduce(t, _REDUCE_OPS[op])
        if op == "prod":
            # exp(sum(log|x|)) with the sign and zeros handled explicitly, so
            # arbitrary reals reduce (the JAX package's rule)
            has_zero = self._all_reduce((t == 0).to(torch.int32), dist.ReduceOp.SUM) > 0
            neg = self._all_reduce((t < 0).to(torch.int32), dist.ReduceOp.SUM)
            sign = torch.where(neg % 2 == 1, -1.0, 1.0)
            mag = torch.where(t == 0, 1.0, t.abs().to(torch.float32))
            mag = torch.exp(self._all_reduce(torch.log(mag), dist.ReduceOp.SUM))
            return torch.where(has_zero, 0.0, sign * mag).to(t.dtype)
        fail("unknown reduction op %s", op)

    def bcast(self, x, root: int = 0):
        """Reference: bcast :391: every rank gets the root's value."""
        t = self.put(x).clone()
        self._record("bcast", t)
        dist.broadcast(t, src=dist.get_global_rank(self.group, root), group=self.group)
        return t

    def reduce(self, x, root: int = 0, op: str = "sum"):
        """Reference: reduce :411. As in the JAX package, the reduced value
        lands on every rank; non-root ranks may ignore it."""
        t = self.put(x)
        self._record("reduce", t)
        return self._allreduce(t, op)

    def allgather(self, x, tiled: bool = False):
        """Reference: allgather :431: every rank's operand, stacked on a new
        leading dimension in rank order, or concatenated along the first
        with ``tiled`` (allgatherv: pad to the largest part first)."""
        t = self.put(x)
        self._record("allgather", t)
        return self._gather(t, tiled)

    def gather(self, x, root: int = 0, tiled: bool = False):
        """Reference: gather :451, as an allgather: every rank gets the full
        copy, the root among them."""
        t = self.put(x)
        self._record("gather", t)
        return self._gather(t, tiled)

    def reducescatter(self, x, op: str = "sum"):
        """Reference: reducescatter :511: the sum over ranks of ``x``, split
        along its leading dimension; rank r keeps block r."""
        expects(op == "sum", "reducescatter supports sum")
        t = self.put(x)
        self._record("reducescatter", t)
        s = self.size()
        expects(t.shape[0] % s == 0, "reducescatter: leading dimension %d must divide "
                "the axis size %d", t.shape[0], s)
        parts = [p.contiguous() for p in t.chunk(s)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def ppermute(self, x, perm: Sequence[tuple[int, int]]):
        """Point-to-point pattern (reference: device_send / device_recv
        :530-570, device_sendrecv): rank ``src`` sends to ``dst`` for each
        pair; a rank that receives nothing gets zeros."""
        t = self.put(x)
        self._record("ppermute", t)
        return self._ppermute(t, perm)

    def _ppermute(self, t: torch.Tensor, perm):
        me = self.rank()
        h = self._out("ppermute", t.contiguous())
        out = torch.zeros_like(h)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(h)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, h, dist.get_global_rank(self.group, dst),
                                      self.group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(self.group, src),
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(t.device)

    def shift(self, x, offset: int = 1):
        """Ring shift (send to rank + offset), the common sendrecv use."""
        t = self.put(x)
        self._record("shift", t)
        n = self.size()
        return self._ppermute(t, [(i, (i + offset) % n) for i in range(n)])

    def alltoall(self, x):
        """Reference: device_multicast_sendrecv :590: block r of the leading
        dimension goes to rank r; the received blocks concatenate in rank
        order (the leading dimension must divide by size())."""
        t = self.put(x)
        self._record("alltoall", t)
        expects(t.shape[0] % self.size() == 0, "alltoall: leading dimension %d must "
                "divide the axis size %d", t.shape[0], self.size())
        h = t.contiguous()
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=self.group)
        return out

    def barrier(self):
        """Reference: barrier :620: a collective no rank passes alone; returns
        the axis size, as the JAX psum of 1."""
        one = torch.ones((), dtype=torch.int32, device=self.device)
        self._record("barrier", one)
        return self._all_reduce(one, dist.ReduceOp.SUM)

    # -- host-side helpers --------------------------------------------------
    def shard_map(self, fn, in_specs, out_specs, check_vma: bool = False):
        """The JAX drivers' calling convention: every rank calls the returned
        function with the global inputs. An input under ``P(axis)`` reaches
        ``fn`` as this rank's block (on its device), one under ``P()`` whole.
        An output under ``P()`` is returned as it is (it must be equal on
        every rank); one under ``P(axis)`` is all-gathered into the global
        tensor. ``check_vma`` is accepted for the JAX signature."""
        in_specs = (in_specs,) if isinstance(in_specs, PartitionSpec) else tuple(in_specs)

        def call(*args):
            expects(len(args) == len(in_specs), "shard_map: %d inputs for %d in_specs",
                    len(args), len(in_specs))
            local = [self._scatter(a, s) for a, s in zip(args, in_specs)]
            out = fn(*local)
            if isinstance(out_specs, PartitionSpec):
                return self._assemble(out, out_specs)
            return type(out)(self._assemble(o, s) for o, s in zip(out, out_specs))

        return call

    def _scatter(self, a, spec: PartitionSpec):
        t = self.put(a)
        for dim, name in enumerate(spec):
            if name is not None:
                t = _block(t, self.mesh, name, dim)
        return t.contiguous()

    def _assemble(self, o, spec: PartitionSpec):
        if not isinstance(o, torch.Tensor):
            return o
        for dim, name in enumerate(spec):
            if name is not None:
                sub = self if name == self.axis else self.comm_split(name)
                sub._record("allgather", o)
                o = torch.cat(list(sub._gather(o, tiled=False)), dim=dim)
        return o

    def sync_stream(self, *arrays):
        """Reference: sync_stream (core/comms.hpp:290): wait for the rank's
        device; a failed collective raises at its call or here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
