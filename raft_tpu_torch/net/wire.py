"""Wire schemas for every serve-path message + the error/status mapping.

The port's own copy of raft_tpu/net/wire.py: the same envelopes, field
names and byte encoding, so a message one package encodes the other
decodes unchanged. Arrays cross as numpy buffers; a caller holding
tensors hands over host numpy (the serve path's results already are).

The in-process serve path passes Python objects (numpy blocks, exception
instances, keyword control); the wire forces explicit schemas on all of
them. Three message families, all JSON envelopes (version-tagged so a
rolling fleet can skew one version):

- **query batch** — ``{"v", "name", "k", "queries": <array>}`` where
  ``<array>`` is the base64 raw-buffer encoding below (never JSON float
  lists: a float32 row serializes to exactly 4 bytes/dim + base64
  overhead, round-trips bit-exact, and decodes with one ``frombuffer``);
- **candidate set** — ``{"v", "rows", "dists": <array>, "ids": <array>}``
  — the scatter-gather rule made schema: k ids + distances per part,
  NEVER raw vectors (candidates-only on the wire);
- **control** — ``{"v", "op", ...}`` for publish/flush/upsert/delete/
  warm/stop between router and workers.

Errors ride ``{"error": {"type", "message", "fields"}}`` bodies plus the
HTTP status from :data:`STATUS_BY_ERROR`; :func:`decode_error`
reconstructs the EXACT original exception class with structured fields
intact, so a caller's existing ``except OverloadedError`` fences work
unchanged across the wire. A ``retry_after_s`` field (mirrored in the
``Retry-After`` header) carries the server's backoff hint — see
:func:`raft_tpu_torch.serve.submit_with_retry`.

Request ids and deadline budgets ride headers (:data:`H_REQUEST_ID`,
:data:`H_DEADLINE_MS`) so one trace spans wire→queue→flush; the server
returns its span decomposition in :data:`H_SPANS` so clients (and the
bench) can split p99 into wire vs queue vs flush without scraping.
"""

from __future__ import annotations

import base64

import numpy as np

from ..core.errors import RaftError
from ..serve.errors import (DeadlineExceededError, MemoryBudgetError,
                            OverloadedError, ReplicaUnavailableError,
                            ServeError, ServiceClosedError)

__all__ = [
    "WIRE_VERSION", "H_REQUEST_ID", "H_DEADLINE_MS", "H_RETRY_AFTER",
    "H_SPANS", "STATUS_BY_ERROR",
    "encode_array", "decode_array",
    "encode_query_batch", "decode_query_batch",
    "encode_candidates", "decode_candidates",
    "encode_control", "decode_control",
    "status_of", "encode_error", "decode_error",
    "encode_spans", "decode_spans",
]

WIRE_VERSION = 1

H_REQUEST_ID = "X-Raft-Request-Id"    # rid threading: wire→queue→flush
H_DEADLINE_MS = "X-Raft-Deadline-Ms"  # remaining budget, not a wall time
H_RETRY_AFTER = "Retry-After"         # seconds (float accepted)
H_SPANS = "X-Raft-Spans"              # "queue=1.2e-3,flush=3.4e-3"

# Admission taxonomy → HTTP status. ORDER MATTERS: subclasses before
# bases (MemoryBudgetError IS an OverloadedError; 507 Insufficient
# Storage is more specific than 429 Too Many Requests).
STATUS_BY_ERROR: tuple = (
    (MemoryBudgetError, 507),
    (OverloadedError, 429),          # includes stream.DeltaFullError
    (DeadlineExceededError, 504),
    (ReplicaUnavailableError, 503),
    (ServiceClosedError, 503),
)


# -- array codec ------------------------------------------------------------

def encode_array(a) -> dict:
    """``{"dtype", "shape", "b64"}`` — C-order raw buffer, little-endian
    (the only byte order the stack runs on), base64 for JSON transport."""
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]), dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()  # writable, owns its buffer


# -- query batch ------------------------------------------------------------

def encode_query_batch(name: str, queries, k: int) -> dict:
    q = np.asarray(queries)
    return {"v": WIRE_VERSION, "name": str(name), "k": int(k),
            "queries": encode_array(q)}


def decode_query_batch(d: dict):
    """-> ``(name, queries, k)``; raises :class:`RaftError` (→400) on a
    malformed envelope so schema drift fails loudly at the door."""
    try:
        return str(d["name"]), decode_array(d["queries"]), int(d["k"])
    except (KeyError, TypeError, ValueError) as exc:
        raise RaftError(f"malformed query batch: {exc}") from exc


# -- candidate set ----------------------------------------------------------

def encode_candidates(dists, ids) -> dict:
    dists = np.asarray(dists)
    ids = np.asarray(ids)
    return {"v": WIRE_VERSION, "rows": int(dists.shape[0]),
            "dists": encode_array(dists), "ids": encode_array(ids)}


def decode_candidates(d: dict):
    """-> ``(dists, ids)`` host arrays."""
    try:
        return decode_array(d["dists"]), decode_array(d["ids"])
    except (KeyError, TypeError, ValueError) as exc:
        raise RaftError(f"malformed candidate set: {exc}") from exc


# -- control ----------------------------------------------------------------

def encode_control(op: str, **kw) -> dict:
    """Publish/flush/upsert/delete/warm/stop control envelope. Array
    values must already be :func:`encode_array` dicts (the caller knows
    which fields are arrays; this stays schema-agnostic)."""
    env = {"v": WIRE_VERSION, "op": str(op)}
    env.update(kw)
    return env


def decode_control(d: dict):
    """-> ``(op, payload_dict)``."""
    try:
        op = str(d["op"])
    except (KeyError, TypeError) as exc:
        raise RaftError(f"malformed control message: {exc}") from exc
    return op, {k: v for k, v in d.items() if k not in ("v", "op")}


# -- span decomposition header ----------------------------------------------

def encode_spans(spans: dict) -> str:
    return ",".join(f"{k}={float(v):.6g}" for k, v in spans.items())


def decode_spans(s: str | None) -> dict:
    if not s:
        return {}
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            continue  # a skewed peer's unknown span never fails a response
    return out


# -- error mapping ----------------------------------------------------------

# structured fields preserved across the wire, per class
_FIELDS = {
    "MemoryBudgetError": ("site", "budget_bytes", "accounted_bytes",
                          "need_bytes"),
    "ReplicaUnavailableError": ("name", "replicas", "fenced"),
}


def status_of(exc: BaseException) -> int:
    """HTTP status for a serve-path exception: the taxonomy table, then
    400 for any other :class:`RaftError` (validation — the request was
    wrong, not the server), else 500."""
    for cls, code in STATUS_BY_ERROR:
        if isinstance(exc, cls):
            return code
    return 400 if isinstance(exc, RaftError) else 500


def encode_error(exc: BaseException, *,
                 retry_after_s: float | None = None) -> tuple[int, dict]:
    """-> ``(status, body)``. The body's ``type`` is the concrete class
    name (so ``DeltaFullError`` survives as itself, not as its 429
    base); structured fields ride ``fields`` verbatim."""
    fields = {f: getattr(exc, f)
              for f in _FIELDS.get(type(exc).__name__, ()) if hasattr(exc, f)}
    if retry_after_s is not None:
        fields["retry_after_s"] = float(retry_after_s)
    return status_of(exc), {"error": {"type": type(exc).__name__,
                                      "message": str(exc),
                                      "fields": fields}}


def _error_class(name: str):
    table = {
        "RaftError": RaftError,
        "ServeError": ServeError,
        "OverloadedError": OverloadedError,
        "MemoryBudgetError": MemoryBudgetError,
        "ReplicaUnavailableError": ReplicaUnavailableError,
        "DeadlineExceededError": DeadlineExceededError,
        "ServiceClosedError": ServiceClosedError,
    }
    if name in table:
        return table[name]
    if name == "DeltaFullError":
        # lazy: stream is a heavy import the read-path client never needs
        from ..stream.mutable import DeltaFullError
        return DeltaFullError
    return None


def decode_error(body: dict, *, status: int = 0) -> BaseException:
    """Reconstruct the exact exception the server raised. Unknown types
    (a newer server's taxonomy) degrade to the nearest base the status
    implies, so old clients still shed/retry correctly."""
    err = (body or {}).get("error") or {}
    name = err.get("type", "")
    msg = err.get("message", f"server error (HTTP {status})")
    fields = dict(err.get("fields") or {})
    retry_after = fields.pop("retry_after_s", None)
    cls = _error_class(name)
    if cls is None:  # degrade by status family
        cls = {429: OverloadedError, 507: MemoryBudgetError,
               504: DeadlineExceededError, 503: ServiceClosedError,
               400: RaftError}.get(status, ServeError)
    kwargs = {f: fields[f]
              for f in _FIELDS.get(cls.__name__, ()) if f in fields}
    try:
        exc = cls(msg, **kwargs)
    except TypeError:  # constructor drift on a skewed peer
        exc = cls(msg)
    if retry_after is not None:
        exc.retry_after_s = float(retry_after)
    return exc
