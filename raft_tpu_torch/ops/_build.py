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

Loading is thread-safe: one module lock covers :func:`build_all` and the
first :func:`load` of a kernel, so two threads (a serve flush worker and
the caller, say) never both start nvcc for one source. Each nvcc run and
each cached library loaded is reported to
:func:`raft_tpu_torch.obs.compile.record_build`, so a region's builds show
in its ``obs.compile.attribution()``. The wrappers count their launches
with :func:`count_launch`, under a lock of its own, so launches from
concurrent threads are not lost; :func:`launch_tally` also counts the
launches one thread makes inside a region (a compaction's fold, say, apart
from the reads that other threads serve meanwhile).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from ..core.errors import RaftError
from ..obs import compile as obs_compile

__all__ = ["build_all", "load", "count_launch", "launch_tally", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BUILD_DIR = DEFAULT_BUILD_DIR   # config.enable_compilation_cache moves it
SOURCES = ("fused_knn", "fused_knn_tc", "topk", "pq_scan", "cagra_hop")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_reports: dict[str, str] = {}   # name -> ptxas report of this process's build
_lock = threading.Lock()        # builds and loads
_count_lock = threading.Lock()  # launch counters
_tallies = threading.local()    # this thread's open launch_tally dicts


def count_launch(fn, mode=None, route=None) -> None:
    """Add one to the wrapper ``fn``'s ``launches`` (and to
    ``launches_by_mode[mode]`` and ``launches_by_route[route]``): a
    read-modify-write that concurrent flushes would otherwise lose. Also
    adds one to ``(fn.__name__, mode, route)`` in every :func:`launch_tally`
    open on the calling thread."""
    with _count_lock:
        fn.launches += 1
        if mode is not None:
            fn.launches_by_mode[mode] += 1
        if route is not None:
            fn.launches_by_route[route] += 1
    for tally in getattr(_tallies, "open", ()):
        key = (fn.__name__, mode, route)
        tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def launch_tally():
    """Yield a dict that counts, by ``(wrapper name, mode, route)``, the
    launches made on the calling thread while the block runs; launches of
    other threads are left out of it (they still count in the wrappers'
    totals)."""
    tally: dict = {}
    if not hasattr(_tallies, "open"):
        _tallies.open = []
    _tallies.open.append(tally)
    try:
        yield tally
    finally:
        _tallies.open.pop()             # blocks nest, so the last is this one


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
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> dict:
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
        obs_compile.record_build(name, secs[name], cached=job is None)
    return secs


def set_build_dir(path) -> Path:
    """Point the build cache at ``path`` (created if missing) under the
    build lock, so no build in flight straddles two directories; libraries
    already loaded stay loaded. Returns the directory in effect."""
    global BUILD_DIR
    path = Path(path).expanduser().resolve()
    with _lock:
        path.mkdir(parents=True, exist_ok=True)
        BUILD_DIR = path
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _build_locked((name,))
            lib = _libs[name]
    return lib


def report(name: str) -> str:
    """The ptxas report of ``name`` if this process built it, else ''."""
    return _reports.get(name, "")
