"""Closed-loop serving-plane control: sensors → bounded actuation.

Counterpart of raft_tpu/control, with its public names and journal kinds.
The :class:`Controller` subscribes to the operations event journal
(:mod:`raft_tpu_torch.obs.events`) and closes the loops the stack previously
left to an operator:

- ``retune_advised`` family drift → a bounded background sweep
  (:func:`raft_tpu_torch.tune.sweep`) over canary/corpus samples, republished
  ``tuned=`` through the registry's warm-before-flip seam — recall
  recovers with zero cold compiles and no operator;
- ``reshard_advised`` topology watermarks →
  :meth:`raft_tpu_torch.stream.ShardedMutableIndex.reshard` under a
  headroom/SLO-burn admission check, aborted cleanly when either says no;
- SLO latency burn → degrade to a cheaper pinned operating point instead
  of shedding (and pace compaction off the worst moment), restored with
  hysteresis once the burn clears.

Every decision is a ``control/*`` journal event carrying its triggering
evidence inline; the BASELINE-r5 non-transfer rule (an operating point
never crosses balance classes) is a hard guard in the controller, not a
convention. The JAX package's docs/control.md describes the loops.
"""

from .controller import ControlPolicy, Controller, NonTransferError

__all__ = ["Controller", "ControlPolicy", "NonTransferError"]
