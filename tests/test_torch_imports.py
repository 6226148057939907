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
    assert "not yet ported" not in (stream.__doc__ or "")


# the modules of the autotuner and deploy-time slice, each named so that a
# move or a rename shows here
DEPLOY_MODULES = ("config.py", "_warmup.py", "__init__.py", "core/__init__.py",
                  "core/interruptible.py", "core/operators.py", "core/temporary_buffer.py",
                  "tune/__init__.py", "tune/apply.py", "tune/sweep.py", "tune/reference.py",
                  "serve/registry.py", "serve/service.py", "neighbors/_hooks.py",
                  "neighbors/ivf_flat.py", "neighbors/ivf_pq.py", "neighbors/cagra.py")


@pytest.mark.parametrize("rel", DEPLOY_MODULES)
def test_deploy_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


# the modules of the network front door, exporter and controller slice
NET_MODULES = ("net/__init__.py", "net/_httpd.py", "net/wire.py", "net/server.py",
               "net/client.py", "net/mesh.py", "obs/http.py", "obs/__init__.py",
               "control/__init__.py", "control/controller.py")


@pytest.mark.parametrize("rel", NET_MODULES)
def test_net_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_packages_export_the_front_door_exporter_and_controller():
    from raft_tpu_torch import control, net, obs

    for name in ("Httpd", "Request", "Response", "json_response", "wire", "NetServer",
                 "NetClient", "ProcessMesh", "MeshSpec"):
        assert name in net.__all__ and hasattr(net, name), name
    for name in ("http", "MetricsExporter", "start_http_exporter", "stop_http_exporter"):
        assert name in obs.__all__ and hasattr(obs, name), name
    for name in ("Controller", "ControlPolicy", "NonTransferError"):
        assert name in control.__all__ and hasattr(control, name), name
    assert "not yet ported" not in (obs.__doc__ or "").lower()
    assert "raft_tpu." not in (net.__doc__ or "").replace("raft_tpu_torch.", "")


def test_only_the_named_carve_outs_are_not_yet_ported():
    """Nothing is left: the tuned hooks, ``publish(tuned=)``, ``warmup``,
    ``config``, the mesh's ``comms=``, sparse ``gram_matrix`` and
    ``cagra_hop``'s ``profile=`` carve-outs are all ported, and no module
    of the port refuses a call as not yet ported."""
    hits = sorted({str(f.relative_to(ROOT / "raft_tpu_torch"))
                   for f in (ROOT / "raft_tpu_torch").rglob("*.py")
                   if "not yet ported" in f.read_text()})
    assert hits == [], hits


def test_package_exports_the_deploy_surface():
    import raft_tpu_torch
    from raft_tpu_torch import _warmup, config, core, tune

    assert raft_tpu_torch.warmup is _warmup.warmup
    assert raft_tpu_torch.warm_buckets is _warmup.warm_buckets
    assert raft_tpu_torch.config is config
    for name in ("InterruptedException", "interruptible", "synchronize", "cancel",
                 "temporary_device_buffer", "operators"):
        assert name in core.__all__ and hasattr(core, name), name
    for name in ("sweep", "sweep_select_k", "make_searcher", "attach", "apply_global",
                 "tuned_search_params", "resolve", "reference", "Trial", "default_grid"):
        assert name in tune.__all__ and hasattr(tune, name), name
    assert "not yet ported" not in (tune.__doc__ or "")


# the modules of the communicator and distributed-driver slice
COMMS_MODULES = ("comms/__init__.py", "comms/comms.py", "comms/bootstrap.py",
                 "comms/test_utils.py", "parallel/__init__.py", "parallel/_progcache.py",
                 "parallel/knn.py", "parallel/kmeans.py", "parallel/ivf.py",
                 "parallel/cagra.py", "core/platform.py", "core/resources.py",
                 "stream/sharded.py")


@pytest.mark.parametrize("rel", COMMS_MODULES)
def test_comms_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_package_exports_comms_and_parallel():
    import raft_tpu_torch
    from raft_tpu_torch import comms, parallel

    assert raft_tpu_torch.comms is comms and raft_tpu_torch.parallel is parallel
    for name in ("Comms", "shard_along", "replicated", "initialize", "local_mesh",
                 "test_utils"):
        assert name in comms.__all__ and hasattr(comms, name), name
    for name in ("knn", "kmeans", "ivf", "cagra", "release_programs"):
        assert name in parallel.__all__ and hasattr(parallel, name), name
    from raft_tpu_torch.core import platform

    for name in ("RankPool", "force_virtual_cpu", "virtual_cpu_env"):
        assert name in platform.__all__ and hasattr(platform, name), name


# the modules of the sparse and graph-solver slice
GRAPH_MODULES = ("sparse/__init__.py", "sparse/types.py", "sparse/convert.py", "sparse/op.py",
                 "sparse/linalg.py", "sparse/distance.py", "sparse/neighbors.py",
                 "solver/__init__.py", "solver/mst.py", "solver/lanczos.py", "solver/lap.py",
                 "cluster/__init__.py", "cluster/single_linkage.py", "spectral/__init__.py",
                 "spectral/partition.py", "distance/kernels.py")


@pytest.mark.parametrize("rel", GRAPH_MODULES)
def test_graph_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


@pytest.mark.parametrize("pkg", ["sparse", "solver", "spectral"])
def test_graph_packages_keep_the_jax_names(pkg):
    """Each package exports the JAX package's public names."""
    import importlib

    port = importlib.import_module(f"raft_tpu_torch.{pkg}")
    jax_init = ROOT / "raft_tpu" / pkg / "__init__.py"
    tree = ast.parse(jax_init.read_text())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "__all__")
    assert sorted(port.__all__) == sorted(names)
    for name in names:
        assert hasattr(port, name), name
    import raft_tpu_torch

    assert getattr(raft_tpu_torch, pkg) is port


def test_cluster_exports_single_linkage():
    from raft_tpu_torch import cluster

    for name in ("single_linkage", "SingleLinkageOutput"):
        assert name in cluster.__all__ and hasattr(cluster, name), name


# the modules of the remaining primitives' slice
PRIMITIVE_MODULES = ("linalg/__init__.py", "linalg/blas.py", "linalg/map_reduce.py",
                     "linalg/solvers.py", "random/__init__.py", "random/rng.py",
                     "random/sampling.py", "random/datagen.py", "random/rmat.py",
                     "stats/__init__.py", "stats/moments.py", "stats/metrics.py",
                     "label/__init__.py", "label/classlabels.py", "label/merge_labels.py",
                     "runtime/__init__.py", "runtime/native.py")


@pytest.mark.parametrize("rel", PRIMITIVE_MODULES)
def test_primitive_modules_import_neither_jax_nor_raft_tpu(rel):
    path = ROOT / "raft_tpu_torch" / rel
    assert path.is_file(), rel
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
    assert "cpp" not in path.read_text().replace("runtime.cpp", "")


@pytest.mark.parametrize("pkg", ["linalg", "random", "stats", "label", "runtime"])
def test_primitive_packages_keep_the_jax_names(pkg):
    """Each package exports every name of the JAX package's ``__all__``."""
    import importlib

    port = importlib.import_module(f"raft_tpu_torch.{pkg}")
    tree = ast.parse((ROOT / "raft_tpu" / pkg / "__init__.py").read_text())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "__all__")
    assert sorted(port.__all__) == sorted(names)
    for name in names:
        assert hasattr(port, name), name
    import raft_tpu_torch

    assert getattr(raft_tpu_torch, pkg) is port
