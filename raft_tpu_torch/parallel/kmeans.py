"""Multi-device k-means: the cuML-over-raft::comms pattern.

Counterpart of raft_tpu/parallel/kmeans.py. The reference keeps MNMG k-means
in cuML, built on raft::comms collectives: each worker assigns its shard
and all-reduces per-center sums and counts. Here every rank runs the same
Lloyd loop over its block of rows: assignment is the per-shard fused 1-NN
(:func:`~raft_tpu_torch.distance.fused_nn._fused_l2_nn`), the update is an
all-reduce of the one-hot sums (a plain product, as the JAX package leaves
it to XLA) and counts, and the stopping test reads a value every rank holds
alike.

Randomness: the JAX fit folds the rank into its key; here each rank draws
its subsample (and its mini-batch shuffle) from a generator seeded by
``(seed, rank)``, and the replicated k-means++ seeding from one seeded by
``seed`` alone, so every rank computes the same centers. The two packages'
streams differ, so fits compare by quality, not bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cluster.kmeans import KMeansOutput, KMeansParams, _kmeans_plus_plus
from ..comms.comms import Comms
from ..core.errors import expects
from ..distance.fused_nn import _fused_l2_nn
from ..distance.pairwise import full_f32

__all__ = ["fit", "predict"]

# rows of a one-hot sum's product at a time: its (k, rows) operand stays
# within 256 MB
_ONEHOT_BYTES = 256 << 20


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of one rank's own draws, seeded by ``(seed, rank)``."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def onehot_sums(labels, xf, k: int):
    """Per-label sums (k, d) of the rows of ``xf`` as the one-hot product
    ``onehot(labels)ᵀ @ xf`` in full float32, over row blocks whose one-hot
    operand stays within 256 MB."""
    out = torch.zeros((k, xf.shape[1]), dtype=torch.float32, device=xf.device)
    rows = max(1, _ONEHOT_BYTES // (4 * k))
    cls = torch.arange(k, device=xf.device)[:, None]
    for i in range(0, xf.shape[0], rows):
        onehot = (labels[i:i + rows].to(torch.int64)[None, :] == cls).to(torch.float32)
        with full_f32():
            out += onehot @ xf[i:i + rows]
    return out


def _counts(labels, k: int):
    return torch.bincount(labels.to(torch.int64), minlength=k).to(torch.float32)


def _shard(comms: Comms, x):
    """This rank's block of the rows of ``x`` on its device."""
    n = int(x.shape[0])
    size = comms.size()
    expects(n % size == 0, "dataset rows must divide the mesh axis; pad first")
    rows = n // size
    lo = comms.rank() * rows
    return comms.put(x[lo:lo + rows])


def fit(comms: Comms, params: KMeansParams, x, tile: int = 4096) -> KMeansOutput:
    """Distributed Lloyd (the contract of cluster.kmeans.fit, the rows split
    over ``comms.axis``; every rank calls with the global ``x``). Init is
    k-means++ on a pooled subsample: each rank contributes distinct random
    rows of its block, the pool is all-gathered (equal on every rank) and ++
    runs on it replicated.

    ``params.train_mode`` selects mini-batch EM: each iteration assigns one
    rotating per-rank mini-batch (``batch_rows`` rows over all ranks) and
    moves the centers by the streaming 1/c mean update, with ``tol`` on the
    per-iteration center shift; labels and inertia always come from one
    closing full pass. Returns the centers, the global labels (all-gathered
    on every rank), the inertia and the iteration count."""
    from ..cluster.kmeans_balanced import resolve_train_mode

    x_shard = _shard(comms, x)
    dev = x_shard.device
    size, rank = comms.size(), comms.rank()
    n = int(x.shape[0])
    k = params.n_clusters
    shard_rows = x_shard.shape[0]
    sub = min(max(8 * k, 64), shard_rows)
    mode = resolve_train_mode(params.train_mode, n, params.batch_rows)
    batch = (min(shard_rows, max(params.batch_rows // size, 1))
             if mode == "minibatch" else 0)
    g_rank = rank_generator(params.seed, rank, dev)
    g_all = torch.Generator(device=dev).manual_seed(int(params.seed))
    xf = x_shard.to(torch.float32)
    idx = torch.randperm(shard_rows, generator=g_rank, device=dev)[:sub]
    pool = comms.allgather(xf[idx], tiled=True)                   # (size*sub, d)
    centers = _kmeans_plus_plus(pool, g_all, k)
    shift2, it = float("inf"), 0
    if batch:
        perm = torch.randperm(shard_rows, generator=g_rank, device=dev)
        offs = torch.arange(batch, device=dev)
        ccounts = torch.zeros((k,), dtype=torch.float32, device=dev)
        while it < params.max_iter and shift2 > params.tol ** 2:
            xb = xf[perm[(it * batch + offs) % shard_rows]]
            _, labels = _fused_l2_nn(xb, centers, False, min(tile, batch))
            sums = comms.allreduce(onehot_sums(labels, xb, k), "sum")
            counts = comms.allreduce(_counts(labels, k), "sum")
            ccounts = ccounts + counts
            new = centers + (sums - counts[:, None] * centers) / torch.clamp_min(
                ccounts, 1.0)[:, None]
            shift2 = float(torch.square(new - centers).sum())
            centers, it = new, it + 1
    else:
        while it < params.max_iter and shift2 > params.tol ** 2:
            _, labels = _fused_l2_nn(x_shard, centers, False, min(tile, shard_rows))
            sums = comms.allreduce(onehot_sums(labels, xf, k), "sum")
            counts = comms.allreduce(_counts(labels, k), "sum")
            new = torch.where(counts[:, None] > 0,
                              sums / torch.clamp_min(counts, 1.0)[:, None], centers)
            shift2 = float(torch.square(new - centers).sum())
            centers, it = new, it + 1
    d2, labels = _fused_l2_nn(x_shard, centers, False, min(tile, shard_rows))
    inertia = comms.allreduce(d2.sum(), "sum")
    return KMeansOutput(centers, comms.allgather(labels, tiled=True), inertia, int(it))


def predict(comms: Comms, x, centroids, tile: int = 4096):
    """Distributed assignment: (the global labels, all-gathered on every
    rank; the inertia)."""
    x_shard = _shard(comms, x)
    c = comms.put(centroids)
    d2, labels = _fused_l2_nn(x_shard, c, False, min(tile, x_shard.shape[0]))
    return comms.allgather(labels, tiled=True), comms.allreduce(d2.sum(), "sum")
