"""raft_tpu_torch stands alone: no module of the port (nor chip_smoke.py,
which drives it on the card) imports JAX or the JAX package."""

import ast
from pathlib import Path

import pytest

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
    """Every kernel source sits in ops/csrc and _build.SOURCES names each one
    (fused_knn.cu holds the float32 FFMA kernel, fused_knn_tc.cu the
    tensor-core modes of the same TPU kernel)."""
    from raft_tpu_torch.ops import _build

    csrc = ROOT / "raft_tpu_torch" / "ops" / "csrc"
    stems = {p.stem for p in csrc.glob("*.cu")}
    assert stems == {"fused_knn", "fused_knn_tc", "topk", "pq_scan", "cagra_hop"}
    assert stems == set(_build.SOURCES)


# the modules of the tiered-storage and quality slice, each named so that a
# move or a rename shows here
SLICE_MODULES = ("stream/tiered.py", "stream/mutable.py", "stream/compactor.py",
                 "obs/quality.py", "obs/slo.py", "obs/events.py", "obs/mem.py",
                 "tune/__init__.py", "tune/decisions.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


# the modules of the sharded and replicated mesh slice, and the names the
# stream package exports for it
MESH_MODULES = ("stream/sharded.py", "stream/replicated.py", "stream/__init__.py",
                "serve/errors.py")


@pytest.mark.parametrize("rel", MESH_MODULES)
def test_mesh_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_stream_exports_the_mesh():
    from raft_tpu_torch import stream

    for name in ("ShardedMutableIndex", "shard_of", "ReplicatedShard", "FencingPolicy",
                 "sharded", "replicated"):
        assert name in stream.__all__ and hasattr(stream, name), name
    assert "not yet ported" not in (stream.__doc__ or "").replace("``comms=`` is not yet ported", "")
