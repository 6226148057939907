"""Matrix primitives: row-wise top-k selection."""

from .select_k import select_k, set_wide_cols_threshold, wide_cols_threshold

__all__ = ["select_k", "set_wide_cols_threshold", "wide_cols_threshold"]
