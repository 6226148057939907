"""raft_tpu_torch — the PyTorch / CUDA port of raft_tpu for NVIDIA Hopper.

A second package beside ``raft_tpu`` (the JAX reference, which it never
imports). It mirrors raft_tpu's paths and names so each counterpart sits at
the same place; inside it is plain PyTorch on an explicit ``torch.device``,
and every Pallas kernel of raft_tpu becomes a hand-written CUDA kernel for
``sm_90a`` beside a plain PyTorch version of the same function.

Entry points run on ``cuda`` unless the caller passes
``Resources(device="cpu")``; a CPU tensor takes each kernel's plain version.

Ported so far:
  config     the output type of the array-returning entry points, the
             persistent kernel-build cache
  core       errors, resource handle (with its mesh and communicator),
             index-file serialization (raft_tpu/13), logging, profiler
             ranges, cooperative cancellation, the operator vocabulary, the
             staging buffer, the spawned ranks that stand in for a
             multi-device mesh (platform)
  cluster    k-means, balanced k-means, single-linkage clustering
  comms      the communicator over torch.distributed (a DeviceMesh and one
             of its dimensions; NCCL on CUDA, gloo on the CPU), the world's
             bootstrap, the collective self-tests
  control    the closed-loop controller: drift → retune, watermark →
             reshard, SLO burn → degrade / restore, compaction pacing
  distance   metric vocabulary, pairwise distances (every metric), fused and
             masked L2 nearest neighbour, Gram matrices (dense or CSR)
  matrix     select_k (row-wise top-k; wide rows run the ``topk`` kernel)
  net        the network front door: wire schemas, NetServer / NetClient
             over SearchService, the multi-process mesh (ProcessMesh)
  neighbors  brute-force kNN (the ``fused_knn`` kernel), IVF-Flat, IVF-PQ
             (the ``pq_scan`` kernel), CAGRA (the ``cagra_hop`` kernel),
             exact refine, the epsilon neighbourhood, sample filters
  obs        metrics, kernel-build attribution, the event journal and its
             flight recorder, request traces, the memory ledger and its
             budget gate, the recall canary and drift detector, SLO tracking,
             the HTTP exporter (/metrics, /healthz, /debug/*)
  ops        the kernels and their build
  parallel   the distributed drivers over comms: sharded exact kNN,
             k-means, IVF-Flat / IVF-PQ build and search, per-shard CAGRA
  serve      micro-batched serving with warm hot-swap (SearchService,
             IndexRegistry, MicroBatcher, StagingBuffers)
  solver     minimum spanning forest (Borůvka), thick-restart Lanczos,
             the batched auction for linear assignment
  sparse     padded COO / CSR matrices, conversions, SpMV / SpMM and the
             graph ops, sparse pairwise distances and kNN (the ``topk``
             kernel for wide rows), the kNN graph, the component repair
  spatial    the legacy spatial::knn entry points
  spectral   spectral partitioning and modularity clustering
  stats      dispersion
  stream     the mutable index: delta memtable, tombstones, write-ahead log,
             compaction with a warm hot-swap (serve's write path), tiered
             (beyond-HBM) row storage
  testing    the fault-injection registry
  tune       the autotuner: sweeps, the decision log, pinned operating
             points applied at serve.publish
  warmup     the deploy-time build-and-search warm-up (``warmup``) and the
             serving-bucket warm-up (``warm_buckets``)
"""

import importlib

from .core import RaftError, Resources, default_resources, set_default_resources
from .version import __version__

_SUBMODULES = {"cluster", "comms", "config", "control", "core", "distance", "matrix", "net",
               "neighbors", "obs", "ops", "parallel", "serve", "solver", "sparse", "spatial",
               "spectral", "stats", "stream", "testing", "tune"}


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in ("warmup", "warm_buckets"):  # the deploy-time and serving warm-ups
        fn = getattr(importlib.import_module("._warmup", __name__), name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'raft_tpu_torch' has no attribute {name!r}")
