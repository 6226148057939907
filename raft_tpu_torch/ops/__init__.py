"""Hand-written Hopper kernels backing the hot paths, each beside its plain
PyTorch version: ``fused_knn`` (fused distance + top-k), ``topk`` (row-wise
selection) and ``pq_scan`` (the IVF-PQ look-up-table scan). Sources live in
``csrc/``; ``_build`` compiles them with nvcc at first use."""
