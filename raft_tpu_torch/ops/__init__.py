"""Hand-written Hopper kernels backing the hot paths, each beside its plain
PyTorch version: ``fused_knn`` (fused distance + top-k), ``topk`` (row-wise
selection), ``pq_scan`` (the IVF-PQ look-up-table scan) and ``cagra_hop``
(one CAGRA beam hop). Sources live in ``csrc/``; ``_build`` compiles them
with nvcc at first use."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process: mode f32's
    ``fused_knn`` by route (``fused_knn_rows``, ``fused_knn_tf32x3``), the
    tensor-core modes summed (``fused_knn_tc``), then ``bf16_split``,
    ``tf32_split``, ``topk``, ``pq_scan``, ``pq_scan_topk`` and
    ``cagra_hop``. A process mesh's workers report theirs through
    ``ProcessMesh.stats()``."""
    from .cagra_hop import cagra_hop
    from .fused_knn import bf16_split, fused_knn, tf32_split
    from .pq_scan import pq_scan, pq_scan_topk
    from .topk import topk

    return {**{f"fused_knn_{r}": int(v) for r, v in fused_knn.launches_by_route.items()},
            "fused_knn_tc": int(sum(v for m, v in fused_knn.launches_by_mode.items()
                                    if m != "f32")),
            "bf16_split": int(bf16_split.launches), "tf32_split": int(tf32_split.launches),
            "topk": int(topk.launches), "pq_scan": int(pq_scan.launches),
            "pq_scan_topk": int(pq_scan_topk.launches), "cagra_hop": int(cagra_hop.launches)}
