"""Array and index-structure serialization.

The port's own copy of raft_tpu/core/serialize.py (reference:
cpp/include/raft/core/serialize.hpp, core/detail/mdspan_numpy_serializer.hpp
and the scalar helpers of neighbors/ivf_pq_serialize.cuh:52-110). The
on-disk vocabulary is the same byte for byte: tagged scalars and marked
NumPy ``.npy`` blocks in one file, so an index written by either package
loads in the other.

Arrays are written from torch tensors or numpy arrays and read back as torch
tensors (on the CPU unless a device is given). bfloat16, which numpy cannot
hold, travels as a uint16 bit-pattern ``.npy`` block behind the ``B``
marker; it is read as int16 and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

from .errors import expects

__all__ = [
    "serialize_mdspan", "deserialize_mdspan", "serialize_scalar",
    "deserialize_scalar", "serialize_json", "deserialize_json",
    "serialize_header", "check_header", "serialize_tuned", "deserialize_tuned",
    "version_number", "atomic_write", "fsync_dir", "SERIALIZATION_VERSION",
]

# The index-file format version of raft_tpu/core/serialize.py:79 (its
# comment there lists what each version added). A string, so that streams
# from before versioning fail the check instead of being misread.
SERIALIZATION_VERSION = "raft_tpu/13"

# Older versions each tag can still read (raft_tpu/core/serialize.py:86).
_READ_COMPATIBLE: dict[str, frozenset[str]] = {
    "ivf_flat": frozenset({"raft_tpu/2", "raft_tpu/3", "raft_tpu/4",
                           "raft_tpu/5", "raft_tpu/6", "raft_tpu/7",
                           "raft_tpu/8", "raft_tpu/9", "raft_tpu/10",
                           "raft_tpu/11", "raft_tpu/12"}),
    "ivf_pq": frozenset({"raft_tpu/3", "raft_tpu/4", "raft_tpu/5",
                         "raft_tpu/6", "raft_tpu/7", "raft_tpu/8",
                         "raft_tpu/9", "raft_tpu/10", "raft_tpu/11",
                         "raft_tpu/12"}),
    "cagra": frozenset({"raft_tpu/2", "raft_tpu/3", "raft_tpu/4",
                        "raft_tpu/5", "raft_tpu/6", "raft_tpu/7",
                        "raft_tpu/8", "raft_tpu/9", "raft_tpu/10",
                        "raft_tpu/11", "raft_tpu/12"}),
    "stream": frozenset({"raft_tpu/8", "raft_tpu/9", "raft_tpu/10",
                         "raft_tpu/11", "raft_tpu/12"}),
    "brute_force": frozenset({"raft_tpu/8", "raft_tpu/9", "raft_tpu/10",
                              "raft_tpu/11", "raft_tpu/12"}),
    "mesh": frozenset({"raft_tpu/11", "raft_tpu/12"}),
}


def version_number(ver: str) -> int:
    """``"raft_tpu/9" -> 9``, for loaders that branch on "present from /N on"."""
    try:
        return int(ver.rsplit("/", 1)[1])
    except (IndexError, ValueError):
        raise ValueError(f"not a raft_tpu format version string: {ver!r}")


def serialize_header(fp: BinaryIO, tag: str) -> None:
    """Write the index-file header: type tag + format version."""
    serialize_scalar(fp, tag)
    serialize_scalar(fp, SERIALIZATION_VERSION)


def check_header(fp: BinaryIO, tag: str) -> str:
    """Read and validate the header; returns the file's version string so
    loaders can branch on old layouts."""
    got = deserialize_scalar(fp)
    article = "an" if tag[:1] in "aeiou" else "a"
    expects(got == tag, "not %s %s index file (tag=%r)", article, tag, got)
    ver = deserialize_scalar(fp)
    ok = ver == SERIALIZATION_VERSION or ver in _READ_COMPATIBLE.get(tag, ())
    expects(
        ok,
        "unsupported %s index file format %r (this build reads %r) — the file "
        "was written by an incompatible raft_tpu version; rebuild and re-save "
        "the index",
        tag, ver, SERIALIZATION_VERSION,
    )
    return ver


def serialize_mdspan(fp: BinaryIO, arr) -> None:
    """Write a tensor or numpy array as a 1-byte marker + ``.npy`` stream:
    ``B`` and uint16 bit patterns for bfloat16, ``N`` and the array as it is
    for everything else."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            fp.write(b"B")
            np.save(fp, t.view(torch.int16).numpy().view(np.uint16), allow_pickle=False)
            return
        host = t.numpy()
    else:
        host = np.asarray(arr)
    fp.write(b"N")
    np.save(fp, host, allow_pickle=False)


def deserialize_mdspan(fp: BinaryIO, device=None) -> torch.Tensor:
    """Read a marked ``.npy`` stream back as a tensor (on ``device``, the CPU
    by default); ``B`` blocks come back as ``torch.bfloat16``."""
    marker = fp.read(1)
    if marker not in (b"N", b"B"):
        raise ValueError(f"bad mdspan marker {marker!r}")
    host = np.load(fp, allow_pickle=False)
    if marker == b"B":
        t = torch.from_numpy(np.ascontiguousarray(host).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(host))
    return t if device is None else t.to(device)


def serialize_scalar(fp: BinaryIO, value) -> None:
    """Write one tagged scalar: bool, int (int64), float (float64) or str."""
    if isinstance(value, (bool, np.bool_)):
        fp.write(b"b" + struct.pack("<?", bool(value)))
    elif isinstance(value, (int, np.integer)):
        fp.write(b"i" + struct.pack("<q", int(value)))
    elif isinstance(value, (float, np.floating)):
        fp.write(b"f" + struct.pack("<d", float(value)))
    elif isinstance(value, str):
        raw = value.encode()
        fp.write(b"s" + struct.pack("<i", len(raw)) + raw)
    else:
        raise TypeError(f"unsupported scalar type {type(value)}")


def deserialize_scalar(fp: BinaryIO):
    tag = fp.read(1)
    if tag == b"b":
        return struct.unpack("<?", fp.read(1))[0]
    if tag == b"i":
        return struct.unpack("<q", fp.read(8))[0]
    if tag == b"f":
        return struct.unpack("<d", fp.read(8))[0]
    if tag == b"s":
        (n,) = struct.unpack("<i", fp.read(4))
        return fp.read(n).decode()
    raise ValueError(f"bad scalar tag {tag!r}")


def serialize_json(fp: BinaryIO, obj: Any) -> None:
    """Write a small length-prefixed JSON record."""
    raw = json.dumps(obj).encode()
    fp.write(struct.pack("<i", len(raw)) + raw)


def deserialize_json(fp: BinaryIO) -> Any:
    (n,) = struct.unpack("<i", fp.read(4))
    return json.loads(fp.read(n).decode())


def serialize_tuned(fp: BinaryIO, tuned: dict | None) -> None:
    """Write the optional trailing tuned record (raft_tpu/9): a presence
    bool, then the decision JSON."""
    if version_number(SERIALIZATION_VERSION) < 9:
        return
    serialize_scalar(fp, tuned is not None)
    if tuned is not None:
        serialize_json(fp, tuned)


def deserialize_tuned(fp: BinaryIO, ver: str) -> dict | None:
    """Read the record :func:`serialize_tuned` wrote; files older than
    raft_tpu/9 have none."""
    if version_number(ver) < 9:
        return None
    if not deserialize_scalar(fp):
        return None
    return deserialize_json(fp)


def fsync_dir(dirname: str) -> None:
    """fsync a directory so a just-renamed entry survives a machine crash
    (a no-op where directories cannot be opened)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str):
    """Crash-safe writes: yields a binary handle onto a temporary file in the
    same directory and, only on a clean exit, fsyncs it and renames it over
    ``path``; a crash or raise mid-write leaves the previous file as it was.
    The ``serialize/atomic-write`` fault point
    (:mod:`raft_tpu_torch.testing.faults`) sits between the complete
    temporary file and the rename, so tests can crash a save there."""
    from ..testing import faults

    tmp = f"{path}.tmp.{os.getpid()}"
    f = open(tmp, "wb")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        # the crash window: the new bytes are complete, the rename is not
        # done, and the previous file must still load
        faults.fire("serialize/atomic-write", path=path, tmp=tmp)
        os.replace(tmp, path)
        # the rename is durable only once the directory entry is on disk: a
        # WAL truncated after it must never meet the old snapshot
        fsync_dir(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        if not f.closed:
            f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
