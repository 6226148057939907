"""raft_tpu_torch stands alone: no module of the port (nor chip_smoke.py,
which drives it on the card) imports JAX or the JAX package."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "raft_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_raft_tpu():
    files = sorted((ROOT / "raft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_keeps_kernel_sources_beside_wrappers():
    csrc = ROOT / "raft_tpu_torch" / "ops" / "csrc"
    assert {p.stem for p in csrc.glob("*.cu")} == {"fused_knn", "topk"}
