"""The decision log: pinned operating points with their evidence inline.

Counterpart of raft_tpu/tune/decisions.py, with the same keying rule, the
same classifiers and thresholds, and the same JSON artifact byte for byte
(a log the JAX package saved loads here, and the port's saves load there).
The classifiers read tensors through the host (numpy float64), so they give
the JAX module's values for the same rows.

A *decision* is one pinned set of search-time knobs for one ``(index kind,
query dtype, shape family)`` key, carrying the measurement that justified
it. BASELINE round 5's negative result is the design constraint: operating
points do NOT transfer across dataset families (the heavytail set needed a
different probes/refine point than the isotropic set at 0.31 vs 0.82
recall), so decisions are keyed by family, never globally.

**Shape family** is a coarse, deterministic bucketing — decisions must be
reusable across rebuilds of "the same kind of index", so the key uses
magnitudes, not exact shapes:

- row count bucketed to its nearest decade (``10k``/``100k``/``1m``/...),
- dimensionality bucketed to its nearest power of two (``d64``/``d128``),
- a balance class read off the built index itself: ``skew`` when an IVF
  index's list-size coefficient of variation exceeds
  :data:`SKEW_CV_THRESHOLD` (the heavytail signature — population skew is
  exactly what broke transfer), ``clump`` when a CAGRA build measured
  local-mode structure (``seed_pool_hint > 0``), ``bal`` otherwise.

The log serializes to a human-auditable JSON artifact (the JAX package's
``TUNE_rXX.json`` format, ``raft_tpu_tune/1``).
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from ..core.errors import expects

__all__ = [
    "Decision", "DecisionLog", "shape_family", "family_of", "kind_of",
    "local_scale_cv", "list_size_cv",
    "SCALE_CV_THRESHOLD", "SKEW_CV_THRESHOLD",
]

# Skew classifiers, calibrated on the CPU mesh (tune.reference families).
# Per-LIST statistics do NOT work here: the balanced k-means trainer
# actively equalizes both list populations (split cap) and per-list
# variance (centers chase high-variance regions), which was measured to
# wash the heavytail signature out of any list-level stat. So:
#
# - Local-SCALE CV (std/mean of nearest-neighbor radii over a row
#   subsample, index-independent): the BASELINE-r5 heavytail signature —
#   lognormal per-cluster residual scales (what collapsed IVF-PQ recall
#   0.31 vs 0.82 and made operating points non-transferable) spread local
#   densities over orders of magnitude. Measured 0.43 on the isotropic
#   reference family vs 1.54 on the lognormal one; 0.75 splits with wide
#   margin on both sides.
# - List-SIZE CV (std/mean over non-empty lists): population skew that
#   survived balancing (e.g. extend()-grown indexes); threshold 1.0 (the
#   balanced trainer leaves ~0.5 even on isotropic data at small scale).
SCALE_CV_THRESHOLD = 0.75
SKEW_CV_THRESHOLD = 1.0

_KINDS = ("brute_force", "ivf_flat", "ivf_pq", "cagra", "select_k")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One pinned operating point + its evidence.

    ``params`` is the applied knob set (plain JSON scalars — e.g.
    ``{"n_probes": 8, "refine_ratio": 4}``); ``evidence`` is the
    measurement that chose it (recall target, every trial's params/recall/
    QPS, the chosen-vs-default deltas, backend, shapes). The evidence
    travels WITH the decision — a pinned constant whose provenance is a
    commit message is exactly the debt this module exists to retire.
    """

    kind: str
    dtype: str
    family: str
    params: dict
    evidence: dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.kind}/{self.dtype}/{self.family}"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "dtype": self.dtype,
                "family": self.family, "params": dict(self.params),
                "evidence": dict(self.evidence)}

    @classmethod
    def from_dict(cls, d: dict) -> "Decision":
        expects(isinstance(d, dict) and "kind" in d and "params" in d,
                "not a decision dict (need at least kind+params): %r",
                type(d).__name__)
        return cls(kind=d["kind"], dtype=d.get("dtype", "float32"),
                   family=d.get("family", "any"),
                   params=dict(d["params"]),
                   evidence=dict(d.get("evidence", {})))


def _n_bucket(n: int) -> str:
    """Nearest-decade row-count label: 12_000 → "10k", 800_000 → "1m"."""
    expects(n >= 1, "row count must be positive, got %d", n)
    e = int(round(math.log10(max(n, 1))))
    if e <= 3:
        return "1k"
    for exp, label in ((4, "10k"), (5, "100k"), (6, "1m"), (7, "10m"),
                       (8, "100m")):
        if e == exp:
            return label
    return "1b"


def _d_bucket(d: int) -> str:
    expects(d >= 1, "dim must be positive, got %d", d)
    return f"d{2 ** int(round(math.log2(max(d, 1))))}"


def shape_family(n: int, d: int, balance: str = "bal") -> str:
    """The family key string for (rows, dim, balance class) — e.g.
    ``"10k-d64-bal"``. ``balance`` ∈ bal/skew/clump (see module doc)."""
    expects(balance in ("bal", "skew", "clump"),
            "balance must be 'bal', 'skew' or 'clump', got %r", balance)
    return f"{_n_bucket(int(n))}-{_d_bucket(int(d))}-{balance}"


def kind_of(index) -> str:
    """Index object → decision kind string (duck-typed, so tune never
    imports the neighbors modules at module scope)."""
    name = type(index).__name__
    table = {"BruteForce": "brute_force", "IvfFlatIndex": "ivf_flat",
             "IvfPqIndex": "ivf_pq", "CagraIndex": "cagra"}
    expects(name in table, "no tune support for index type %r "
            "(expected BruteForce, IvfFlatIndex, IvfPqIndex or CagraIndex)",
            name)
    return table[name]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def list_size_cv(list_sizes) -> float:
    """CV (std / mean) of the non-empty lists' sizes."""
    sizes = _host(list_sizes).astype(np.float64)
    sizes = sizes[sizes > 0]
    if sizes.size == 0 or sizes.mean() == 0:
        return 0.0
    return float(sizes.std() / sizes.mean())


def local_scale_cv(dataset, sample: int = 1024) -> float:
    """CV of nearest-neighbor radii over a deterministic row subsample
    (one (sample, sample) GEMM on host — cheap at any scale, and
    independent of how any index balanced its lists). The measured
    heavytail discriminator: lognormal per-cluster residual scales read
    ~1.5, isotropic clustered data ~0.4 (see SCALE_CV_THRESHOLD). Public:
    :class:`raft_tpu_torch.obs.quality.DriftDetector` re-runs this
    classifier online, on canary query samples and compaction-time corpus
    stats, to detect the live distribution leaving a pinned decision's
    family."""
    # the same rows as subsampling on the host, without copying the whole
    # dataset off the card first
    step = max(int(dataset.shape[0]) // int(sample), 1)
    x = _host(dataset[::step][:sample]).astype(np.float64)
    if x.shape[0] < 8:
        return 0.0
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, np.inf)
    nn = np.sqrt(np.maximum(d2.min(1), 0.0))
    if nn.mean() == 0:
        return 0.0
    return float(nn.std() / nn.mean())


def family_of(index, dataset=None) -> str:
    """Measure the family key off a built index: row count and dim from
    the index, the balance class from measured structure — local-scale CV
    over raw rows (the heavytail signature; needs ``dataset`` for PQ
    indexes, whose lists store only codes) plus list-size CV for IVF
    kinds, the measured clump hint (``seed_pool_hint``) for CAGRA. With
    no rows available the scale stat is skipped and only population skew
    can classify — pass ``dataset=`` when keying PQ indexes (the sweep
    engine does; decisions attached at sweep time ride the index, so
    loaded indexes rarely need re-keying)."""
    kind = kind_of(index)
    if kind == "brute_force":
        n, d = index.dataset.shape
        balance = ("skew" if local_scale_cv(index.dataset)
                   > SCALE_CV_THRESHOLD else "bal")
    elif kind == "cagra":
        n, d = index.size, index.dim
        balance = "clump" if int(index.seed_pool_hint) > 0 else "bal"
    else:  # ivf_flat / ivf_pq
        n, d = index.size, index.dim
        balance = "bal"
        if list_size_cv(index.list_sizes) > SKEW_CV_THRESHOLD:
            balance = "skew"
        else:
            if dataset is None and kind == "ivf_flat":
                # raw rows live in the lists: sample a few leading rows
                # from EVERY list on device FIRST (the classifier needs
                # ~1k rows SPREAD ACROSS clusters — whole-list sampling
                # would measure within-cluster scale only and miss the
                # cross-cluster heavytail signature; pulling the full
                # 1M-scale storage to host per resolve would cost a ~GB
                # copy), then fold padding out
                n_lists, cap = index.list_data.shape[:2]
                lstep = max(n_lists // 4096, 1)
                per_list = max(4096 * lstep // n_lists, 1)
                data = _host(index.list_data[::lstep, :per_list].to(
                    torch.float32))
                ids = _host(index.list_ids[::lstep, :per_list])
                dataset = data.reshape(-1, d)[ids.reshape(-1) >= 0]
            if dataset is not None and local_scale_cv(
                    dataset) > SCALE_CV_THRESHOLD:
                balance = "skew"
    return shape_family(n, d, balance)


def _query_dtype_of(index) -> str:
    """The query dtype a decision for ``index`` is keyed by."""
    kind = getattr(index, "data_kind", "float32")
    return kind if kind in ("int8", "uint8") else "float32"


class DecisionLog:
    """Keyed collection of decisions + artifact (de)serialization.

    ``meta`` records the measurement context once (backend, round label,
    generator seeds) so the artifact is self-describing.
    """

    def __init__(self, meta: dict | None = None):
        self.meta: dict = dict(meta or {})
        self._entries: dict[str, Decision] = {}

    # -- collection ----------------------------------------------------------
    def add(self, decision: Decision) -> Decision:
        expects(decision.kind in _KINDS, "unknown decision kind %r",
                decision.kind)
        self._entries[decision.key] = decision
        return decision

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> tuple[Decision, ...]:
        return tuple(self._entries[k] for k in sorted(self._entries))

    def get(self, kind: str, dtype: str, family: str) -> Decision | None:
        return self._entries.get(f"{kind}/{dtype}/{family}")

    def resolve(self, index, dataset=None) -> Decision | None:
        """Look up the decision for a built index: exact family first, then
        the nearest same-kind same-dtype family within the SAME balance
        class (matching dim bucket scores higher than matching row decade
        — probes/itopk track dim far more than absolute scale). Crossing
        the balance class is never a fallback: that transfer is the
        measured recall collapse this keying exists to prevent (BASELINE
        r5, 0.31 vs 0.82), so a log holding only the other class returns
        None and the caller keeps its defaults. ``dataset`` rows let the
        scale-skew classifier run for PQ indexes (see :func:`family_of`).
        Hand-authored entries with an unstructured family (``"any"``)
        resolve as a last resort below any structured match."""
        kind, dtype = kind_of(index), _query_dtype_of(index)
        fam = family_of(index, dataset)
        exact = self.get(kind, dtype, fam)
        if exact is not None:
            return exact
        n_lab, d_lab, bal = fam.split("-")
        best, best_score = None, -1.0
        for dec in self._entries.values():
            if dec.kind != kind or dec.dtype != dtype:
                continue
            parts = dec.family.split("-")
            if len(parts) == 3:
                dn, dd, db = parts
                if db != bal:
                    continue  # never transfer across balance classes
                score = 1.0 + 2.0 * (dd == d_lab) + 1.0 * (dn == n_lab)
            else:
                # hand-authored entries (e.g. from_dict's "any" default)
                # still resolve, below any structured-family match
                score = 0.5
            if score > best_score:
                best, best_score = dec, score
        return best

    # -- artifact ------------------------------------------------------------
    def to_json(self) -> dict:
        return {"format": "raft_tpu_tune/1", "meta": dict(self.meta),
                "decisions": [d.to_dict() for d in self.entries()]}

    @classmethod
    def from_json(cls, obj: dict) -> "DecisionLog":
        expects(isinstance(obj, dict)
                and obj.get("format", "").startswith("raft_tpu_tune/"),
                "not a tune decision-log artifact (format=%r)",
                obj.get("format") if isinstance(obj, dict) else type(obj))
        log = cls(meta=obj.get("meta", {}))
        for d in obj.get("decisions", []):
            log.add(Decision.from_dict(d))
        return log

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "DecisionLog":
        with open(path) as f:
            return cls.from_json(json.load(f))
