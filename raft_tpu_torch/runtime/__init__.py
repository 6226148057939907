"""The native host runtime: big-ANN binary file I/O, host refine and the
host merge of per-shard results, in C++ through ctypes (counterpart of
raft_tpu/runtime; see ``csrc/runtime.cpp``). Host code: numpy in, numpy
out."""

from .native import (
    available,
    bin_info,
    load_bin,
    merge_parts_host,
    read_bin_chunk,
    refine_host,
    write_bin,
    BinDataset,
)

__all__ = [
    "available",
    "bin_info",
    "load_bin",
    "read_bin_chunk",
    "write_bin",
    "refine_host",
    "merge_parts_host",
    "BinDataset",
]
