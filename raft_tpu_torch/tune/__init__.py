"""raft_tpu_torch.tune — the decision log the quality observers key on.

Counterpart of raft_tpu/tune, with what is ported: :mod:`.decisions`
(:class:`Decision` / :class:`DecisionLog`, the JAX package's JSON artifact
byte for byte; :func:`shape_family` / :func:`family_of` / :func:`kind_of`,
the keying rule; :func:`list_size_cv` / :func:`local_scale_cv`, the
classifiers :class:`raft_tpu_torch.obs.quality.DriftDetector` re-runs).

Not yet ported: ``apply`` (decision -> search params, ``attach``, a tuned
publish), ``sweep`` and ``reference``; a ``tuned=`` publish and the indexes'
tune hooks raise ``RaftError("not yet ported")``.
"""

from . import decisions
from .decisions import (Decision, DecisionLog, family_of, kind_of,
                        list_size_cv, local_scale_cv, shape_family)

__all__ = [
    "decisions", "Decision", "DecisionLog", "shape_family", "family_of",
    "kind_of", "list_size_cv", "local_scale_cv",
]
