"""Matrix primitives: row-wise top-k selection and the dense matrix
utilities of :mod:`.ops`."""

from . import ops
from .select_k import select_k, set_wide_cols_threshold, wide_cols_threshold

__all__ = ["ops", "select_k", "set_wide_cols_threshold", "wide_cols_threshold"]
