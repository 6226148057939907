"""Version of raft_tpu_torch, the PyTorch / CUDA port of raft_tpu.

Tracks raft_tpu's version: the port answers the same API, slice by slice.
"""

__version__ = "0.1.0"
