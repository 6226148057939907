"""raft_tpu_torch.net — the network front door: wire surface + process mesh.

Counterpart of raft_tpu/net, with its public names. Three layers, each
usable alone:

- :mod:`~raft_tpu_torch.net.wire` — explicit schemas for every serve-path
  message (query batch, candidate set, publish/flush control) plus the
  admission-taxonomy ↔ HTTP status mapping. Arrays ride base64-encoded
  raw numpy buffers with dtype/shape, never Python floats and never
  tensors; errors ride structured JSON bodies that reconstruct the exact
  exception type with fields intact on the client. The encoding is the
  JAX package's byte for byte, so either package's client talks to either
  package's server.
- :class:`~raft_tpu_torch.net.server.NetServer` /
  :class:`~raft_tpu_torch.net.client.NetClient` — a zero-dependency
  HTTP/JSON front end over :class:`raft_tpu_torch.serve.SearchService`
  and the client library that wraps
  :func:`raft_tpu_torch.serve.submit_with_retry`'s backoff/deadline
  discipline around the wire calls. Deadline budgets and request ids ride
  headers so one trace spans wire→queue→flush in the request log.
- :class:`~raft_tpu_torch.net.mesh.ProcessMesh` — shard groups owned by
  separate worker *processes* behind a router, the scatter-gather merge
  crossing process boundaries with candidates-only on the wire (k ids +
  distances per part, never raw rows). Replica groups are placed across
  processes, so killing a worker is a strike→fence→failover event, not
  an outage; each worker runs on the device its spec names (``cuda``
  unless asked for the CPU), loads the kernel libraries the router built
  before spawning it, and rehearses the warm-before-flip publish ladder so
  the wire path serves with zero kernel builds.

The shared stdlib server plumbing lives in
:mod:`~raft_tpu_torch.net._httpd` (also backing the obs exporter,
:mod:`raft_tpu_torch.obs.http` — one server pattern, not two). Heavy
submodules are imported lazily so ``obs.http → net._httpd`` never drags
the serve stack (or torch) into an import cycle.
"""

from __future__ import annotations

import importlib

from ._httpd import Httpd, Request, Response, json_response

__all__ = ["Httpd", "Request", "Response", "json_response",
           "wire", "NetServer", "NetClient", "ProcessMesh", "MeshSpec"]

_LAZY = {
    "NetServer": ("server", "NetServer"),
    "NetClient": ("client", "NetClient"),
    "ProcessMesh": ("mesh", "ProcessMesh"),
    "MeshSpec": ("mesh", "MeshSpec"),
    "wire": ("wire", None),
}


def __getattr__(name):
    if name in _LAZY:
        modname, attr = _LAZY[name]
        mod = importlib.import_module(f".{modname}", __name__)
        val = mod if attr is None else getattr(mod, attr)
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'raft_tpu_torch.net' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
