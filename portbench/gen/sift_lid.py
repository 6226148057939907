"""SIFT-class rows: low intrinsic dimension and clumps within clusters.

The repo's SIFT-class generator (bench.py ``_make_lid_1m``; bench/ann/run.py,
the ``intrinsic_dim`` branch): ``clusters`` centres uniform in [0, 10)^dim;
each cluster a random basis of ``intrinsic_dim`` unit rows and ``clumps``
offsets of standard deviation ``cluster_std`` in that subspace; a row is its
centre plus (its clump's offset plus Gaussian noise of ``fine_std``) mapped
through the basis, in float32 with TF32 off. Drawn on the device from the
seed with a ``torch.Generator``, in chunks of ``_CHUNK`` rows; the dataset
first, then the query pool.
"""

from __future__ import annotations

import torch

from portbench.reference import full_f32

_CHUNK = 1 << 16


def make(params: dict, seed: int, device, pool: int):
    """(rows (n, dim) float32, queries (pool, dim) float32) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    d, ncl = int(params["dim"]), int(params["clusters"])
    idim, nclump = int(params["intrinsic_dim"]), int(params["clumps"])
    centers = torch.rand((ncl, d), generator=g, device=device) * 10.0
    bases = torch.randn((ncl, idim, d), generator=g, device=device)
    bases /= torch.linalg.vector_norm(bases, dim=-1, keepdim=True)
    offsets = float(params["cluster_std"]) * torch.randn((ncl, nclump, idim), generator=g,
                                                         device=device)
    fine = float(params["fine_std"])

    def draw(count: int) -> torch.Tensor:
        out = torch.empty((count, d), dtype=torch.float32, device=device)
        with full_f32():
            for s in range(0, count, _CHUNK):
                c = min(_CHUNK, count - s)
                labels = torch.randint(0, ncl, (c,), generator=g, device=device)
                clump = torch.randint(0, nclump, (c,), generator=g, device=device)
                z = offsets[labels, clump] + fine * torch.randn((c, idim), generator=g,
                                                                device=device)
                out[s:s + c] = centers[labels] + torch.bmm(z[:, None, :], bases[labels])[:, 0]
        return out

    return draw(int(params["n"])), draw(int(pool))
