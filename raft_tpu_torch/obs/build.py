"""Shared build-cost metrics, the ``raft_tpu_build_*`` catalogue.

Counterpart of raft_tpu/obs/build.py, under the same names, help strings
and labels (docs/observability.md). The port emits the out-of-core family:
the chunk counter and staged-bytes counter of the streamed builds
(:mod:`raft_tpu_torch.core.chunked`) and their chunk-rows gauge. The trainer
and CAGRA phase metrics are declared for the catalogue's sake; nothing in
the port emits them yet.
"""

from __future__ import annotations

import functools

from . import metrics

__all__ = ["assignment_passes", "sampled_rows", "build_phase",
           "ooc_chunks", "ooc_staged_bytes", "ooc_chunk_rows"]


@functools.lru_cache(maxsize=None)
def assignment_passes():
    return metrics.counter(
        "raft_tpu_build_assignment_passes_total",
        "coarse-trainer assignment passes by phase (em = one per EM "
        "iteration, final = the closing sharpening pass, fill = the "
        "list-fill assignment) and rows walked per pass (mode=full walks "
        "the trainset, minibatch one batch)")


@functools.lru_cache(maxsize=None)
def sampled_rows():
    return metrics.gauge(
        "raft_tpu_build_sampled_rows",
        "rows the coarse trainer assigns per EM iteration (batch_rows in "
        "minibatch mode, the whole trainset in full mode)", unit="rows")


@functools.lru_cache(maxsize=None)
def build_phase():
    return metrics.histogram(
        "raft_tpu_build_phase_seconds",
        "per-phase build walls (coarse trainer EM/final pass, CAGRA knn "
        "chunk loop / optimize)", unit="seconds")


@functools.lru_cache(maxsize=None)
def ooc_chunks():
    return metrics.counter(
        "raft_tpu_build_ooc_chunks_total",
        "corpus chunks processed by the out-of-core streamed build, by "
        "index kind and pipeline stage (assign = the label pass, fill = "
        "the scatter/encode pass, materialize = chunked device upload "
        "for dataset-resident kinds)")


@functools.lru_cache(maxsize=None)
def ooc_staged_bytes():
    return metrics.counter(
        "raft_tpu_build_ooc_staged_bytes_total",
        "host bytes staged through the out-of-core build's "
        "double-buffered chunk stager (core.chunked.ChunkStager); "
        "resident staging bytes stay constant — this counts traffic",
        unit="bytes")


@functools.lru_cache(maxsize=None)
def ooc_chunk_rows():
    return metrics.gauge(
        "raft_tpu_build_ooc_chunk_rows",
        "rows per streamed-build chunk (the reader's chunk_rows after "
        "clamping to the corpus)", unit="rows")
