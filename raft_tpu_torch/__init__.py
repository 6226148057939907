"""raft_tpu_torch — the PyTorch / CUDA port of raft_tpu for NVIDIA Hopper.

A second package beside ``raft_tpu`` (the JAX reference, which it never
imports). It mirrors raft_tpu's paths and names so each counterpart sits at
the same place; inside it is plain PyTorch on an explicit ``torch.device``,
and every Pallas kernel of raft_tpu becomes a hand-written CUDA kernel for
``sm_90a`` beside a plain PyTorch version of the same function.

Entry points run on ``cuda`` unless the caller passes
``Resources(device="cpu")``; a CPU tensor takes each kernel's plain version.

Ported so far:
  core       errors, resource handle
  distance   metric vocabulary, pairwise distances (L2, inner product, cosine)
  matrix     select_k (row-wise top-k; wide rows run the ``topk`` kernel)
  neighbors  brute-force kNN (the ``fused_knn`` kernel), sample filters
  ops        the kernels and their build
"""

import importlib

from .core import RaftError, Resources, default_resources, set_default_resources
from .version import __version__

_SUBMODULES = {"core", "distance", "matrix", "neighbors", "ops"}


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'raft_tpu_torch' has no attribute {name!r}")
