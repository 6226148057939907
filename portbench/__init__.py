"""portbench: the benchmark of raft_tpu_torch, driven by data.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (see ``README.md``). Nothing here
imports JAX or the JAX package ``raft_tpu``; the plain reference
(``reference.py``) imports nothing of ``raft_tpu_torch`` either.
"""
