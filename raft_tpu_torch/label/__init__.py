"""Label utilities (counterpart of raft_tpu/label; reference: raft/label)."""

from .classlabels import (
    get_ovr_labels,
    make_monotonic,
    unique_labels,
    unique_labels_padded,
)
from .merge_labels import merge_labels

__all__ = [
    "get_ovr_labels",
    "make_monotonic",
    "merge_labels",
    "unique_labels",
    "unique_labels_padded",
]
