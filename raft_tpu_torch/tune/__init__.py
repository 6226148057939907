"""raft_tpu_torch.tune — the obs-driven autotuner: measure, calibrate, pin.

Counterpart of raft_tpu/tune. An operating point is only meaningful as a
measured point on a recall-vs-QPS frontier (the ANN-Benchmarks read), so
every choice here is a recorded measurement: ``sweep`` drives the search
pipeline over a knob grid on the index's device, emitting
``raft_tpu_tune_*`` metrics per trial; the chosen point is the QPS argmax
meeting the recall target, with the full trial evidence inline; the
:class:`DecisionLog` pins it per ``(index kind, dtype, shape family)`` —
in a JSON artifact (the JAX package's format byte for byte), and in the
index file itself through the raft_tpu/9 ``tuned`` section.

Surface:

- :mod:`.decisions` — :class:`Decision` / :class:`DecisionLog`,
  :func:`shape_family` / :func:`family_of` (the keying rule), the
  classifiers :func:`list_size_cv` / :func:`local_scale_cv`.
- :mod:`.sweep` — :func:`sweep` (recall-vs-QPS trials over one index),
  :func:`sweep_select_k` (the plain route against the ``topk`` kernel
  over column widths).
- :mod:`.apply` — :func:`tuned_search_params` / :func:`make_searcher`
  (decision → SearchParams / serving hook), :func:`attach` (pin onto an
  index, persisted by save / load), :func:`apply_global` (the process-wide
  wide-select column threshold, applied only from a measurement of the
  port's kernel).
- :mod:`.reference` — the reference families and the artifact-ready log.

``serve.publish(name, index, tuned=log)`` applies a decision at publish
time; the registry's warm ladder then covers the tuned searcher at every
bucket before the flip, so applying a decision builds no kernel on the hot
path (the publish report's attribution shows it).
"""

from . import decisions, reference
from .apply import (apply_global, attach, make_searcher, resolve,
                    tuned_search_params)
from .decisions import (Decision, DecisionLog, family_of, kind_of,
                        list_size_cv, local_scale_cv, shape_family)
from .sweep import (Trial, default_grid, funnel_grid, smoke_grid, sweep,
                    sweep_select_k)

__all__ = [
    "Decision", "DecisionLog", "shape_family", "family_of", "kind_of",
    "Trial", "sweep", "sweep_select_k", "default_grid", "smoke_grid",
    "funnel_grid",
    "tuned_search_params", "make_searcher", "attach", "resolve",
    "apply_global", "reference", "decisions", "list_size_cv", "local_scale_cv",
]
