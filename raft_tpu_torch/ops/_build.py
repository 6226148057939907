"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (listed in
``.gitignore``), for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

The hash covers the source, every ``csrc/*.cuh`` header and the flags, so
an edited source builds anew and an unchanged one loads from the cache.
:func:`build_all` starts one nvcc per source, all at once. The compiler's
register, shared-memory and spill report (``-Xptxas -v``) is printed once
per process. A failed build raises; nothing is downloaded, only the sources
here and the CUDA toolkit are used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from ..core.errors import RaftError

__all__ = ["build_all", "load", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_knn", "topk")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_reports: dict[str, str] = {}   # name -> ptxas report of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RaftError("nvcc not found (PATH, CUDA_HOME): the CUDA toolkit is "
                    "needed to build raft_tpu_torch's kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if cached."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build_all(names=SOURCES) -> dict:
    """Build every named kernel library (one nvcc each, run in parallel)
    and load it. Returns {name: seconds spent building, 0.0 if cached}."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if n not in _libs}
    secs = {n: 0.0 for n in names}
    for name, job in started.items():
        if job is not None:
            proc, tmp, lib = job
            out, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RaftError(f"nvcc failed for {name}.cu "
                                f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, lib)
            _reports[name] = out
            print(f"[raft_tpu_torch] built {lib.name} in {secs[name]:.1f} s; "
                  f"ptxas report:\n{out.strip()}", file=sys.stderr, flush=True)
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def report(name: str) -> str:
    """The ptxas report of ``name`` if this process built it, else ''."""
    return _reports.get(name, "")
