"""Hand-written Hopper kernels backing the hot paths, each beside its plain
PyTorch version: ``fused_knn`` (fused distance + top-k), ``topk`` (row-wise
selection), ``pq_scan`` (the IVF-PQ look-up-table scan) and ``cagra_hop``
(one CAGRA beam hop). Sources live in ``csrc/``; ``_build`` compiles them
with nvcc at first use."""
