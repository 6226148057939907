"""raft_tpu_torch.comms — the communicator over torch.distributed.

Counterpart of raft_tpu/comms (reference: raft::comms, core/comms.hpp:
comms_iface :125-230 / comms_t :242; NCCL+UCX std_comms comms/std_comms.hpp:69;
the Dask bootstrap raft_dask/common/comms.py:39). One process per device:

- construction = a ``DeviceMesh`` over the world's ranks and the name of
  one of its dimensions (:func:`bootstrap.initialize` joins a process to
  the world over ``tcp://``; :func:`local_mesh` gives the 1-D communicator);
- the collective methods (allreduce / allgather / reducescatter / ppermute
  / ...) run eagerly on every rank of that dimension's process group: NCCL
  on CUDA, gloo on the CPU or for several ranks sharing one card;
- ``comm_split`` = the communicator over another dimension of the mesh;
- a failed or timed-out collective raises at its call (every world has a
  collective timeout), or at ``sync_stream``.

``Comms`` carries (mesh, axis), so the distributed drivers
(:mod:`raft_tpu_torch.parallel`) read as the JAX package's.
"""

from . import test_utils
from .bootstrap import initialize, local_mesh
from .comms import Comms, replicated, shard_along

__all__ = ["Comms", "shard_along", "replicated", "initialize", "local_mesh", "test_utils"]
