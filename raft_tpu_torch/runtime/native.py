"""ctypes bindings for the native host runtime (``csrc/runtime.cpp``).

Counterpart of raft_tpu/runtime/native.py. The port builds its own copy of
the runtime at first use::

    g++ -O3 -std=c++17 -fPIC -shared -pthread -o <lib> csrc/runtime.cpp

into ``build/runtime/libraft_tpu_torch_rt-<hash>.so`` at the repository root
(``build/`` is in ``.gitignore``), the hash covering the source and the
flags. It compiles to a temporary name of its own process and moves the
result into place with ``os.replace`` under a lock, so concurrent builders
(test workers, threads) never load a half-written library. ``$CXX`` names
another compiler.

As in the JAX module, every function has a numpy route, taken when no
compiler is found or the build fails (:func:`available` says which). The
native route is the same code as the JAX package's, so files written by
either package are byte for byte the same. ``native_calls`` counts the
calls that took the native route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "bin_info",
    "load_bin",
    "read_bin_chunk",
    "write_bin",
    "refine_host",
    "merge_parts_host",
    "BinDataset",
]

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "runtime.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "runtime"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False
native_calls = 0

_SUFFIX_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".ibin": np.int32,
}


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libraft_tpu_torch_rt-{h.hexdigest()[:16]}.so"


def _build(lib: pathlib.Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None

        lib.rt_num_threads.restype = ctypes.c_int64
        lib.rt_bin_info.restype = ctypes.c_int
        lib.rt_bin_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rt_bin_read_chunk.restype = ctypes.c_int
        lib.rt_bin_read_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.rt_bin_write.restype = ctypes.c_int
        lib.rt_bin_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.rt_refine_host_f32.restype = ctypes.c_int
        lib.rt_refine_host_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.rt_knn_merge_parts_f32.restype = ctypes.c_int
        lib.rt_knn_merge_parts_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _native():
    """The loaded library, counted as a native call, or None."""
    global native_calls
    lib = _load()
    if lib is not None:
        native_calls += 1
    return lib


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    return _load() is not None


def _dtype_for(path: str):
    suffix = pathlib.Path(path).suffix
    if suffix not in _SUFFIX_DTYPES:
        raise ValueError(f"unknown big-ANN binary suffix {suffix!r} (expected one of {sorted(_SUFFIX_DTYPES)})")
    return np.dtype(_SUFFIX_DTYPES[suffix])


def bin_info(path: str) -> tuple[int, int]:
    """(n_rows, dim) of a big-ANN binary file (ref: dataset.h BinFile header)."""
    lib = _native()
    if lib is None:
        with open(path, "rb") as f:
            hdr = np.fromfile(f, np.uint32, 2)
        return int(hdr[0]), int(hdr[1])
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    rc = lib.rt_bin_info(str(path).encode(), ctypes.byref(n), ctypes.byref(d))
    if rc != 0:
        raise OSError(f"rt_bin_info({path}) failed: {rc}")
    return n.value, d.value


def read_bin_chunk(path: str, row_start: int, n_rows: int) -> np.ndarray:
    """Read rows [row_start, row_start+n_rows) of a .fbin/.u8bin/.i8bin/.ibin
    file by parallel pread (native) or numpy."""
    dtype = _dtype_for(path)
    total, dim = bin_info(path)
    n_rows = min(n_rows, total - row_start)
    if n_rows <= 0:
        return np.empty((0, dim), dtype)
    lib = _native()
    out = np.empty((n_rows, dim), dtype)
    if lib is None:
        with open(path, "rb") as f:
            f.seek(8 + row_start * dim * dtype.itemsize)
            out = np.fromfile(f, dtype, n_rows * dim).reshape(n_rows, dim)
        return out
    rc = lib.rt_bin_read_chunk(
        str(path).encode(), row_start, n_rows, dim, dtype.itemsize,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OSError(f"rt_bin_read_chunk({path}) failed: {rc}")
    return out


def load_bin(path: str) -> np.ndarray:
    """Load a whole big-ANN binary file."""
    n, _ = bin_info(path)
    return read_bin_chunk(path, 0, n)


def write_bin(path: str, data: np.ndarray) -> None:
    """Write a big-ANN binary file (header + rows) in the suffix's dtype."""
    dtype = _dtype_for(path)
    data = np.ascontiguousarray(data, dtype)
    lib = _native()
    if lib is None:
        with open(path, "wb") as f:
            np.array(data.shape, np.uint32).tofile(f)
            data.tofile(f)
        return
    rc = lib.rt_bin_write(
        str(path).encode(), data.ctypes.data_as(ctypes.c_void_p),
        data.shape[0], data.shape[1], dtype.itemsize,
    )
    if rc != 0:
        raise OSError(f"rt_bin_write({path}) failed: {rc}")


def refine_host(dataset, queries, candidates, k: int, metric: str = "sqeuclidean"):
    """Exact host-side re-rank of ANN candidates (ref: refine_host,
    neighbors/detail/refine.cuh:169). Returns (distances (m,k), ids (m,k));
    invalid candidate ids (-1) sort last with +inf distance."""
    dataset = np.ascontiguousarray(dataset, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    candidates = np.ascontiguousarray(candidates, np.int32)
    m, k_in = candidates.shape
    if k > k_in:
        raise ValueError(f"k={k} > candidate width {k_in}")
    metric_id = {"sqeuclidean": 0, "euclidean": 0, "l2": 0, "inner_product": 1}[metric]
    lib = _native()
    if lib is not None:
        out_i = np.empty((m, k), np.int32)
        out_d = np.empty((m, k), np.float32)
        rc = lib.rt_refine_host_f32(
            dataset.ctypes.data_as(ctypes.c_void_p), dataset.shape[0], dataset.shape[1],
            queries.ctypes.data_as(ctypes.c_void_p), m,
            candidates.ctypes.data_as(ctypes.c_void_p), k_in,
            out_i.ctypes.data_as(ctypes.c_void_p),
            out_d.ctypes.data_as(ctypes.c_void_p), k, metric_id,
        )
        if rc != 0:
            raise RuntimeError(f"rt_refine_host_f32 failed: {rc}")
        return out_d, out_i
    safe = np.clip(candidates, 0, dataset.shape[0] - 1)
    vecs = dataset[safe]  # (m, k_in, d)
    if metric_id == 1:
        scores = -np.einsum("md,mkd->mk", queries, vecs)
    else:
        diff = queries[:, None, :] - vecs
        scores = np.einsum("mkd,mkd->mk", diff, diff)
    scores = np.where(candidates >= 0, scores, np.inf)
    order = np.argsort(scores, axis=1)[:, :k]
    out_i = np.take_along_axis(candidates, order, axis=1)
    out_d = np.take_along_axis(scores, order, axis=1)
    if metric_id == 1:
        out_d = np.where(out_i >= 0, -out_d, out_d)
    return out_d.astype(np.float32), out_i


def merge_parts_host(part_dists, part_ids, k: int | None = None, select_min: bool = True):
    """Merge per-shard top-k candidate lists on the host (ref:
    knn_merge_parts, neighbors/detail/knn_merge_parts.cuh)."""
    part_dists = np.ascontiguousarray(part_dists, np.float32)
    part_ids = np.ascontiguousarray(part_ids, np.int32)
    n_parts, m, k_in = part_dists.shape
    k = k or k_in
    lib = _native()
    if lib is not None:
        out_d = np.empty((m, k), np.float32)
        out_i = np.empty((m, k), np.int32)
        rc = lib.rt_knn_merge_parts_f32(
            part_dists.ctypes.data_as(ctypes.c_void_p),
            part_ids.ctypes.data_as(ctypes.c_void_p),
            n_parts, m, k_in,
            out_d.ctypes.data_as(ctypes.c_void_p),
            out_i.ctypes.data_as(ctypes.c_void_p), k, int(select_min),
        )
        if rc != 0:
            raise RuntimeError(f"rt_knn_merge_parts_f32 failed: {rc}")
        return out_d, out_i
    flat_d = np.moveaxis(part_dists, 0, 1).reshape(m, n_parts * k_in)
    flat_i = np.moveaxis(part_ids, 0, 1).reshape(m, n_parts * k_in)
    order = np.argsort(flat_d if select_min else -flat_d, axis=1)[:, :k]
    return (
        np.take_along_axis(flat_d, order, axis=1),
        np.take_along_axis(flat_i, order, axis=1),
    )


class BinDataset:
    """Streaming reader over a big-ANN binary file (the data-loader role of
    the reference bench harness's BinFile / mmap path, dataset.h): chunked
    parallel pread, so host RAM holds one chunk while the previous one is
    uploaded to the device."""

    def __init__(self, path: str):
        self.path = str(path)
        self.n_rows, self.dim = bin_info(self.path)
        self.dtype = _dtype_for(self.path)

    def __len__(self) -> int:
        return self.n_rows

    def chunks(self, chunk_rows: int):
        """Yield (row_start, ndarray) chunks."""
        for start in range(0, self.n_rows, chunk_rows):
            yield start, read_bin_chunk(self.path, start, chunk_rows)

    def __getitem__(self, sl):
        if isinstance(sl, slice):
            start, stop, step = sl.indices(self.n_rows)
            if step != 1:
                raise ValueError("BinDataset slicing requires step 1")
            return read_bin_chunk(self.path, start, stop - start)
        raise TypeError("BinDataset supports contiguous slice access only")
