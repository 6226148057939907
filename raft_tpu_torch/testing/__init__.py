"""raft_tpu_torch.testing — deterministic test harnesses.

Counterpart of raft_tpu/testing. :mod:`.faults` is the fault-injection
registry the durability paths (WAL appends, crash recovery, atomic
snapshots) are proven with: named fault points fire injected failures
deterministically, with no sleeps and no real process kills.
"""

from . import faults

__all__ = ["faults"]
