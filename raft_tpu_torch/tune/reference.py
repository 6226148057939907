"""The reference sweep: deterministic families, reproducible pins.

Counterpart of raft_tpu/tune/reference.py, with its family names and
scales (``_SCALE``, the same numbers). :func:`build_family` builds one
family on a handle's device, :func:`run_family` sweeps it through
:func:`~.sweep.sweep`, and :func:`cpu_mesh_decisions` runs every family
and returns the artifact-ready :class:`~.decisions.DecisionLog`, labelled
with the port's own :data:`ROUND`. The port commits no artifact of its
own; the JAX package's ``TUNE_r08.json`` stays the JAX package's.

The data come from the port's own copy of the clustered generator, seeded
with numpy (``numpy.random.default_rng``), so a family is the same rows on
every device and run; they are not the JAX package's rows (its generator is
``jax.random``). Families:

- ``ivf_flat_bal`` / ``ivf_pq_bal`` — isotropic clustered rows (gaussian
  blobs, full-dimensional residuals).
- ``ivf_pq_skew`` — per-cluster residual scales drawn from a lognormal
  (the heavytail signature whose operating points did not transfer),
  keyed to a different family by the scale-skew classifier.
- ``cagra_bal`` — the graph index on the isotropic set.
- ``select_k`` — the wide-select column-threshold sweep (on CPU tensors
  the kernel arm records "ineligible").
"""

from __future__ import annotations

import functools

import numpy as np

from ..core.errors import expects
from .decisions import DecisionLog
from .sweep import default_grid, sweep, sweep_select_k

__all__ = ["FAMILY_NAMES", "build_family", "run_family",
           "cpu_mesh_decisions", "ROUND"]

ROUND = "torch-r01"

FAMILY_NAMES = ("ivf_flat_bal", "ivf_pq_bal", "ivf_pq_skew", "cagra_bal",
                "select_k")

# one shared small-scale config (the JAX package's numbers) so a drift
# check and the artifact generator cannot diverge
_SCALE = {
    "ivf": dict(n=12_000, d=64, ncl=256, n_lists=64, m=512, k=10),
    "cagra": dict(n=4_096, d=48, ncl=64, m=256, k=10),
}


def _clustered(n, d, m, ncl, seed, heavytail=False):
    """Gaussian-blob rows and queries as float32 numpy arrays: centers
    uniform in [0, 10), residual scale 0.5 (``heavytail``: 0.5 x a
    lognormal(0, 1) draw per cluster)."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((ncl, d), dtype=np.float32) * 10.0)
    scales = (0.5 * np.exp(rng.standard_normal(ncl)).astype(np.float32)
              if heavytail else np.full((ncl,), 0.5, np.float32))
    labels = rng.integers(0, ncl, n)
    qlabels = rng.integers(0, ncl, m)
    x = centers[labels] + scales[labels, None] * rng.standard_normal(
        (n, d), dtype=np.float32)
    q = centers[qlabels] + scales[qlabels, None] * rng.standard_normal(
        (m, d), dtype=np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ivf_dataset(skew: bool):
    c = _SCALE["ivf"]
    return _clustered(c["n"], c["d"], c["m"], c["ncl"],
                      seed=29 if skew else 23, heavytail=skew)


def build_family(name: str, res=None) -> dict:
    """Build one reference family on ``res``'s device (default: the default
    handle's): returns ``{index, queries, dataset, grid, k}`` — the exact
    inputs :func:`run_family` sweeps, so a drift check can re-measure single
    operating points without a full sweep. ``select_k`` returns its
    ``sweep_kwargs``."""
    expects(name in FAMILY_NAMES, "unknown reference family %r (one of %s)",
            name, ", ".join(FAMILY_NAMES))
    if name == "select_k":
        return {"sweep_kwargs": dict(rows=64, cols=(32768, 65536),
                                     ks=(10, 128))}
    if name == "cagra_bal":
        from ..neighbors import cagra

        c = _SCALE["cagra"]
        x, q = _clustered(c["n"], c["d"], c["m"], c["ncl"], seed=31)
        idx = cagra.build(cagra.IndexParams(seed=0), x, res=res)
        grid = [{"itopk_size": 32}, {"itopk_size": 16}, {"itopk_size": 64}]
        return {"index": idx, "queries": q, "dataset": x, "grid": grid,
                "k": c["k"]}
    c = _SCALE["ivf"]
    skew = name.endswith("_skew")
    x, q = _ivf_dataset(skew)
    if name.startswith("ivf_flat"):
        from ..neighbors import ivf_flat

        idx = ivf_flat.build(
            ivf_flat.IndexParams(n_lists=c["n_lists"], seed=0), x, res=res)
        grid = default_grid("ivf_flat")
    else:
        from ..neighbors import ivf_pq

        idx = ivf_pq.build(
            ivf_pq.IndexParams(n_lists=c["n_lists"], pq_bits=4,
                               pq_dim=c["d"] // 2, seed=0), x, res=res)
        grid = default_grid("ivf_pq")
    return {"index": idx, "queries": q, "dataset": x, "grid": grid,
            "k": c["k"]}


def run_family(name: str, log: DecisionLog | None = None,
               repeats: int = 2, res=None):
    """Sweep one reference family into ``log`` on ``res``'s device;
    returns the Decision."""
    fam = build_family(name, res=res)
    if name == "select_k":
        return sweep_select_k(log=log, repeats=repeats, res=res,
                              **fam["sweep_kwargs"])
    return sweep(fam["index"], fam["queries"], k=fam["k"],
                 dataset=fam["dataset"], grid=fam["grid"],
                 recall_target="default", repeats=repeats, log=log)


def cpu_mesh_decisions(names=FAMILY_NAMES, repeats: int = 2,
                       res=None) -> DecisionLog:
    """Run every reference family on ``res``'s device (the name is the JAX
    package's, whose run is on its CPU mesh); returns the artifact-ready
    log."""
    import torch

    from ..core.resources import default_resources

    dev = (res or default_resources()).torch_device
    log = DecisionLog(meta={
        "round": ROUND,
        "backend": dev.type,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "scale": {k: dict(v) for k, v in _SCALE.items()},
        "note": "raft_tpu_torch reference sweep (tune.reference."
                "cpu_mesh_decisions); recall values are reproducible on one "
                "device type, QPS is environment-local.",
    })
    for name in names:
        run_family(name, log=log, repeats=repeats, res=res)
    return log
