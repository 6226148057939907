"""Peaks of the card and the work of the rooflined kernel, ``cagra_hop``.

The arithmetic of PERF.md's kernel table, frozen here: each input byte read
once, each output byte written once, and the published dense peaks of one
NVIDIA H100 SXM (data sheet, 700 W). A share is the least time the card
could take (the larger of bytes over the bandwidth and operations over the
peak) over the device time of the kernels that did the work.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12      # HBM3
FFMA_FLOPS = 67e12         # float32 outside the tensor cores
BF16_FLOPS = 989e12        # dense bfloat16 tensor cores
TF32_FLOPS = 495e12        # dense TF32 tensor cores
INT8_OPS = 1979e12         # dense int8 tensor cores


def least_seconds(nbytes: float, ops: float, peak_ops: float) -> float:
    """The least time of ``nbytes`` moved and ``ops`` done at ``peak_ops``."""
    return max(nbytes / HBM_BYTES_S, ops / peak_ops)


def share_pct(least_s: float, kernel_s: float) -> float | None:
    """``least_s`` over ``kernel_s`` in percent; None without kernel time."""
    if kernel_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / kernel_s


def cagra_hop_bytes(distinct_rows: int, m: int, cw: int, width: int, d: int,
                    row_bytes: int, itopk: int) -> float:
    """Bytes of one ``cagra_hop`` launch (PERF.md's kernel table, row 4):
    each distinct candidate row read once, the query rows, the beam's
    ``itopk`` live lanes (distances, ids, visited flags) read and written
    (the lanes above hold padding the search needs no byte of), the
    candidate ids and their valid flags read, the picks and no-candidate
    flags written."""
    return float(distinct_rows * d * row_bytes + m * d * 4 + 3 * m * itopk * 4 * 2
                 + 2 * m * cw * 4 + 2 * m * width * 4)


def cagra_hop_ops(valid_pairs: int, d: int) -> float:
    """float32 operations of one hop: a difference, a product and a sum a
    dimension of every valid (query, candidate) pair."""
    return 3.0 * valid_pairs * d
