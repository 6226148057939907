"""Hand-written Hopper kernels backing the hot paths, each beside its plain
PyTorch version: ``fused_knn`` (fused distance + top-k) and ``topk``
(row-wise selection). Sources live in ``csrc/``; ``_build`` compiles them
with nvcc at first use."""
