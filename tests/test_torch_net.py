"""raft_tpu_torch.net against raft_tpu.net (tier-1 ``net`` marker).

The cases of tests/test_net.py on the port, and the port held against the
JAX package where the two meet:

- wire parity: for float32, int32, int64 and uint8 arrays the port's
  ``encode_*`` dicts equal the JAX package's and each package decodes the
  other's; for every class of ``STATUS_BY_ERROR`` plus ``RaftError``, an
  unknown type and ``DeltaFullError``, both packages give the same status
  and error body, and a body decodes to the same class name and fields in
  each;
- cross-talk over loopback: one corpus (the same numpy rows) served by a
  port ``NetServer`` and a JAX ``NetServer`` and searched with both
  packages' ``NetClient``s, on brute force and on IVF-Flat (a JAX-built
  index saved in the raft_tpu/13 format and loaded into the port): ids
  equal row for row, distances at rtol 1e-5;
- the carried-over classes: the shared httpd, wire schemas, the error
  codec, the taxonomy over a real front door, ``Retry-After`` hints
  through ``submit_with_retry``, rid threading wire→queue→flush, the
  request-log collector's cross-process guard, and the process mesh on
  ``device="cpu"`` (its two tests spawn four workers each); then the
  port's own mesh contracts: a worker asked for ``cuda`` on a machine
  without a card fails its boot, and the workers' launch tallies reach
  ``ProcessMesh.stats``.

Every server, service and mesh is stopped in a ``finally`` or a ``with``;
the last test checks that no front-door thread and no mesh worker is left.
"""

import json
import multiprocessing
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import serve as jserve
from raft_tpu.core.errors import RaftError as JRaftError
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.net import wire as jwire
from raft_tpu.net.client import NetClient as JClient
from raft_tpu.net.server import NetServer as JServer
from raft_tpu.serve import errors as jerr
from raft_tpu.stream.mutable import DeltaFullError as JDeltaFull
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.net import wire
from raft_tpu_torch.net._httpd import Httpd, Response, json_response
from raft_tpu_torch.net.client import NetClient
from raft_tpu_torch.net.mesh import MeshSpec, ProcessMesh
from raft_tpu_torch.net.server import NetServer
from raft_tpu_torch.obs import events as obs_events
from raft_tpu_torch.obs import requestlog
from raft_tpu_torch.serve import errors as terr
from raft_tpu_torch.serve import submit_with_retry
from raft_tpu_torch.serve.errors import (DeadlineExceededError,
                                         MemoryBudgetError, OverloadedError,
                                         ReplicaUnavailableError,
                                         ServiceClosedError)
from raft_tpu_torch.serve.service import SearchService
from raft_tpu_torch.stream.mutable import DeltaFullError

pytestmark = pytest.mark.net

CPU = Resources(device="cpu")
RTOL = 1e-5
CPU_MESH = dict(n_shards=2, n_replicas=2, ks=(10,), max_batch=16, device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post_raw(url, payload, headers=None):
    """POST JSON, return (status, body_dict, headers) without raising."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


def bf_index(ds):
    return brute_force.BruteForce().build(ds, res=CPU)


# ---------------------------------------------------------------------------
# wire parity with raft_tpu.net.wire
# ---------------------------------------------------------------------------


DTYPES = ["float32", "int32", "int64", "uint8"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_array_codec_equals_jax_both_ways(rng, dtype):
    a = (rng.standard_normal((7, 5)) * 100).astype(dtype)
    mine, theirs = wire.encode_array(a), jwire.encode_array(a)
    assert mine == theirs
    for got in (wire.decode_array(theirs), jwire.decode_array(mine)):
        assert got.dtype == a.dtype and np.array_equal(got, a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_message_codecs_equal_jax(rng, dtype):
    q = (rng.standard_normal((3, 8)) * 50).astype(dtype)
    assert wire.encode_query_batch("corpus", q, 10) == \
        jwire.encode_query_batch("corpus", q, 10)
    name, q2, k = jwire.decode_query_batch(wire.encode_query_batch("c", q, 7))
    assert (name, k) == ("c", 7) and np.array_equal(q2, q)
    d = rng.standard_normal((3, 4)).astype(np.float32)
    i = (rng.integers(0, 100, (3, 4))).astype(dtype)
    assert wire.encode_candidates(d, i) == jwire.encode_candidates(d, i)
    d2, i2 = wire.decode_candidates(jwire.encode_candidates(d, i))
    assert np.array_equal(d2, d) and np.array_equal(i2, i) and i2.dtype == i.dtype
    ctl = dict(name="corpus", rows=wire.encode_array(q))
    assert wire.encode_control("upsert", **ctl) == jwire.encode_control("upsert", **ctl)
    spans = {"queue": 0.0012, "flush": 0.034, "wire": 0.05}
    assert wire.encode_spans(spans) == jwire.encode_spans(spans)


def _pair(name, msg="refused"):
    """The same exception in both packages, with its structured fields."""
    if name == "MemoryBudgetError":
        kw = dict(site="upsert", budget_bytes=64, accounted_bytes=60, need_bytes=10)
        return terr.MemoryBudgetError(msg, **kw), jerr.MemoryBudgetError(msg, **kw)
    if name == "ReplicaUnavailableError":
        kw = dict(name="corpus/s0", replicas=2, fenced=2)
        return (terr.ReplicaUnavailableError(msg, **kw),
                jerr.ReplicaUnavailableError(msg, **kw))
    if name == "RaftError":
        return RaftError(msg), JRaftError(msg)
    if name == "DeltaFullError":
        return DeltaFullError(msg), JDeltaFull(msg)
    if name == "ValueError":
        return ValueError(msg), ValueError(msg)
    return getattr(terr, name)(msg), getattr(jerr, name)(msg)


ERROR_NAMES = [cls.__name__ for cls, _ in jwire.STATUS_BY_ERROR] + [
    "RaftError", "ValueError", "DeltaFullError"]


def test_status_table_equals_jax():
    assert [(c.__name__, s) for c, s in wire.STATUS_BY_ERROR] == \
        [(c.__name__, s) for c, s in jwire.STATUS_BY_ERROR]


@pytest.mark.parametrize("name", ERROR_NAMES)
@pytest.mark.parametrize("retry_after", [None, 0.125])
def test_error_codec_equals_jax_both_ways(name, retry_after):
    mine, theirs = _pair(name)
    assert wire.status_of(mine) == jwire.status_of(theirs)
    code, body = wire.encode_error(mine, retry_after_s=retry_after)
    jcode, jbody = jwire.encode_error(theirs, retry_after_s=retry_after)
    assert (code, body) == (jcode, jbody)
    fields = [f for f in wire._FIELDS.get(name, ())]
    for decoded in (wire.decode_error(jbody, status=jcode),
                    jwire.decode_error(body, status=code)):
        # an unknown type (ValueError is not in the taxonomy) degrades by
        # status to the same class in both packages
        want = name if name != "ValueError" else "ServeError"
        assert type(decoded).__name__ == want
        assert str(decoded) == "refused"
        assert [getattr(decoded, f) for f in fields] == [getattr(mine, f) for f in fields]
        assert getattr(decoded, "retry_after_s", None) == retry_after


def test_unknown_type_degrades_like_jax():
    body = {"error": {"type": "FutureFancyError", "message": "x", "fields": {}}}
    for status in (429, 507, 504, 503, 400, 500):
        assert type(wire.decode_error(body, status=status)).__name__ == \
            type(jwire.decode_error(body, status=status)).__name__
    # DeltaFullError resolves to the port's own class, lazily
    assert type(wire.decode_error({"error": {"type": "DeltaFullError"}},
                                  status=429)) is DeltaFullError


# ---------------------------------------------------------------------------
# cross-talk over loopback: port and JAX front doors, both clients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="class")
def crosstalk(tmp_path_factory):
    """One corpus (the same numpy rows) served by both packages: brute force
    built by each, IVF-Flat built by JAX, saved and loaded into the port.
    The JAX side compiles only the buckets the tests flush (warm=False)."""
    rng = np.random.default_rng(7)
    ds = rng.standard_normal((600, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("crosstalk") / "ivf_flat.bin")
    jflat = jfl.build(jfl.IndexParams(n_lists=16, seed=0), jnp.asarray(ds))
    jfl.save(jflat, path)
    tflat = ivf_flat.load(path, res=CPU)
    jsvc = jserve.SearchService(max_batch=8)
    tsvc = SearchService(max_batch=8)
    jsvc.publish("bf", jbf.BruteForce().build(jnp.asarray(ds)), k=5, warm=False)
    tsvc.publish("bf", bf_index(ds), k=5)
    jsvc.publish("flat", jflat, search_params=jfl.SearchParams(n_probes=4), k=5,
                 warm=False)
    tsvc.publish("flat", tflat, search_params=ivf_flat.SearchParams(n_probes=4), k=5)
    jsrv, tsrv = JServer(jsvc), NetServer(tsvc)
    try:
        yield {"q": q, "urls": {"jax": f"http://127.0.0.1:{jsrv.port}",
                                "port": f"http://127.0.0.1:{tsrv.port}"}}
    finally:
        tsrv.stop()
        jsrv.stop()
        tsvc.shutdown()
        jsvc.shutdown()


class TestCrossTalk:
    @pytest.mark.parametrize("name", ["bf", "flat"])
    @pytest.mark.parametrize("rows", [1, 4])
    def test_ids_equal_distances_close(self, crosstalk, name, rows):
        q = crosstalk["q"][:rows]
        answers = {}
        for server, url in crosstalk["urls"].items():
            for client, cls in (("port", NetClient), ("jax", JClient)):
                answers[(server, client)] = cls(url).search(name, q, 5)
        ref_d, ref_i = answers[("jax", "jax")]
        assert ref_i.shape == (rows, 5)
        for key, (d, i) in answers.items():
            assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray), key
            np.testing.assert_array_equal(i, ref_i, err_msg=str(key))
            np.testing.assert_allclose(d, ref_d, rtol=RTOL, atol=1e-5, err_msg=str(key))
        # one server, two clients: the very same bytes
        for server in ("jax", "port"):
            np.testing.assert_array_equal(answers[(server, "port")][0],
                                          answers[(server, "jax")][0])

    def test_refusals_rebuild_as_each_package_class(self, crosstalk):
        for server, url in crosstalk["urls"].items():
            with pytest.raises(RaftError):
                NetClient(url).search("nobody", crosstalk["q"][:1], 5)
            with pytest.raises(JRaftError):
                JClient(url).search("nobody", crosstalk["q"][:1], 5)


# ---------------------------------------------------------------------------
# shared httpd plumbing (one server pattern, not two)
# ---------------------------------------------------------------------------


class TestHttpd:
    def test_routing_get_post_and_404_contract(self):
        def echo(req):
            return json_response(200, {"method": req.method,
                                       "q": req.param("x"),
                                       "body": req.json() if req.body
                                       else None})

        with Httpd({("GET", "/a"): echo, ("POST", "/b"): echo}) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            code, body = _get(base + "/a?x=1&x=2")
            assert code == 200 and json.loads(body)["q"] == "2"
            code, body, _ = _post_raw(base + "/b", {"k": 3})
            assert code == 200 and body["body"] == {"k": 3}
            # unknown path: loud 404 listing endpoints in registration order
            code, body = _get(base + "/nope")
            assert code == 404 and "endpoints: /a, /b" in body
            # registered path, wrong method: also the 404 contract
            code, body = _get(base + "/b")
            assert code == 404

    def test_handler_exception_is_500_not_hang(self):
        def boom(req):
            raise ValueError("kaput")

        with Httpd({("GET", "/x"): boom}) as srv:
            code, body = _get(f"http://127.0.0.1:{srv.port}/x")
            assert code == 500 and "kaput" in body

    def test_ephemeral_port_and_idempotent_stop(self):
        srv = Httpd({("GET", "/"): lambda r: Response(200, b"ok")})
        try:
            assert srv.port > 0
        finally:
            srv.stop()
            srv.stop()  # idempotent
        assert not srv._thread.is_alive()

    def test_obs_exporter_rides_shared_httpd(self):
        from raft_tpu_torch.obs.http import MetricsExporter

        with MetricsExporter(port=0) as exp:
            assert isinstance(exp._server, Httpd)
            code, _ = _get(f"http://127.0.0.1:{exp.port}/metrics")
            assert code == 200


# ---------------------------------------------------------------------------
# wire schemas
# ---------------------------------------------------------------------------


class TestWireSchemas:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_array_roundtrip_bit_exact(self, rng, dtype):
        a = (rng.standard_normal((7, 5)) * 100).astype(dtype)
        b = wire.decode_array(wire.encode_array(a))
        assert b.dtype == a.dtype and np.array_equal(a, b)
        b[0, 0] += 1  # decoded arrays own their buffer (writable)

    def test_query_batch_roundtrip(self, rng):
        q = rng.standard_normal((3, 8)).astype(np.float32)
        name, q2, k = wire.decode_query_batch(
            wire.encode_query_batch("corpus", q, 10))
        assert name == "corpus" and k == 10 and np.array_equal(q, q2)

    def test_candidates_roundtrip(self, rng):
        d = rng.standard_normal((2, 4)).astype(np.float32)
        i = rng.integers(0, 100, (2, 4)).astype(np.int32)
        d2, i2 = wire.decode_candidates(wire.encode_candidates(d, i))
        assert np.array_equal(d, d2) and np.array_equal(i, i2)

    def test_malformed_envelopes_raise_rafterror(self):
        with pytest.raises(RaftError, match="malformed query batch"):
            wire.decode_query_batch({"v": 1, "k": 10})
        with pytest.raises(RaftError, match="malformed candidate set"):
            wire.decode_candidates({"rows": 1})
        with pytest.raises(RaftError, match="malformed control"):
            wire.decode_control({"v": 1})

    def test_control_roundtrip(self):
        op, payload = wire.decode_control(
            wire.encode_control("flush", name="corpus"))
        assert op == "flush" and payload == {"name": "corpus"}

    def test_spans_header_roundtrip(self):
        s = wire.encode_spans({"queue": 0.0012, "flush": 0.034,
                               "wire": 0.05})
        out = wire.decode_spans(s)
        assert out["queue"] == pytest.approx(0.0012, rel=1e-3)
        assert wire.decode_spans(None) == {}
        assert wire.decode_spans("junk=abc,ok=1.0") == {"ok": 1.0}


class TestErrorCodec:
    def test_status_ordering_subclass_before_base(self):
        # MemoryBudgetError IS an OverloadedError: 507 must win over 429
        assert wire.status_of(MemoryBudgetError("m")) == 507
        assert wire.status_of(OverloadedError("o")) == 429
        assert wire.status_of(DeadlineExceededError("d")) == 504
        assert wire.status_of(ReplicaUnavailableError("r")) == 503
        assert wire.status_of(ServiceClosedError("s")) == 503
        assert wire.status_of(RaftError("v")) == 400
        assert wire.status_of(ValueError("x")) == 500

    def test_structured_fields_roundtrip(self):
        exc = MemoryBudgetError("over", site="publish", budget_bytes=100,
                                accounted_bytes=90, need_bytes=20)
        code, body = wire.encode_error(exc)
        assert code == 507
        assert body["error"]["type"] == "MemoryBudgetError"
        back = wire.decode_error(body, status=code)
        assert type(back) is MemoryBudgetError
        assert (back.site, back.budget_bytes, back.accounted_bytes,
                back.need_bytes) == ("publish", 100, 90, 20)

    def test_retry_after_rides_fields(self):
        code, body = wire.encode_error(OverloadedError("full"),
                                       retry_after_s=0.125)
        back = wire.decode_error(body, status=code)
        assert type(back) is OverloadedError
        assert back.retry_after_s == 0.125

    def test_unknown_type_degrades_by_status(self):
        body = {"error": {"type": "FutureFancyError", "message": "x",
                          "fields": {}}}
        assert type(wire.decode_error(body, status=429)) is OverloadedError
        assert type(wire.decode_error(body, status=504)) is \
            DeadlineExceededError
        assert type(wire.decode_error(body, status=400)) is RaftError


# ---------------------------------------------------------------------------
# wire-level error mapping over a real front door (one case per taxonomy
# error: status code, structured body, exact-type re-raise)
# ---------------------------------------------------------------------------


class _RaisingService:
    """Front-door backend that refuses every submit with one exception."""

    def __init__(self, exc, hint=None):
        self.exc = exc
        self.hint = hint

    def submit(self, name, queries, k, timeout_s=None, rid=None):
        raise self.exc

    def queue_depth(self):
        return 3

    def retry_after_hint(self):
        assert self.hint is not None
        return self.hint


def _q(rng, n=1, d=4):
    return rng.standard_normal((n, d)).astype(np.float32)


class TestWireErrorMapping:
    @pytest.mark.parametrize("exc,code", [
        (OverloadedError("queue at 8/8 rows"), 429),
        (MemoryBudgetError("budget", site="upsert", budget_bytes=64,
                           accounted_bytes=60, need_bytes=10), 507),
        (DeadlineExceededError("late"), 504),
        (ReplicaUnavailableError("all dead", name="corpus/s0",
                                 replicas=2, fenced=2), 503),
        (ServiceClosedError("shut down"), 503),
        (RaftError("queries must be (rows, d)"), 400),
    ])
    def test_taxonomy_maps_and_reconstructs(self, rng, exc, code):
        hint = 0.05 if isinstance(exc, OverloadedError) else None
        with NetServer(_RaisingService(exc, hint=hint)) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            payload = wire.encode_query_batch("corpus", _q(rng), 10)
            got_code, body, headers = _post_raw(base + "/v1/search", payload)
            # (a) the status code
            assert got_code == code
            # (b) the structured JSON error body
            assert body["error"]["type"] == type(exc).__name__
            assert str(exc) in body["error"]["message"]
            # (c) the client re-raises the EXACT type, fields intact
            cli = NetClient(base)
            with pytest.raises(type(exc)) as ei:
                cli.search("corpus", _q(rng), 10)
            assert type(ei.value) is type(exc)
            if isinstance(exc, MemoryBudgetError):
                assert body["error"]["fields"]["budget_bytes"] == 64
                assert (ei.value.site, ei.value.need_bytes) == ("upsert", 10)
            if isinstance(exc, ReplicaUnavailableError):
                assert (ei.value.replicas, ei.value.fenced) == (2, 2)
                assert ei.value.name == "corpus/s0"
            if isinstance(exc, OverloadedError):
                # the server's drain estimate rides header AND fields
                assert headers[wire.H_RETRY_AFTER] == "0.050"
                assert ei.value.retry_after_s == pytest.approx(0.05)

    def test_overload_from_real_service_full_queue(self, rng):
        ds = rng.standard_normal((32, 4)).astype(np.float32)
        svc = SearchService(max_batch=2, max_queue_rows=2,
                            start_workers=False)
        svc.publish("corpus", bf_index(ds), k=5, warm=False)
        try:
            svc.submit("corpus", ds[:2], 5)  # fill the queue in-process
            with NetServer(svc) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                with pytest.raises(OverloadedError) as ei:
                    cli.search("corpus", ds[:1], 5)
                # hint derived from live queue depth, never zero
                assert ei.value.retry_after_s > 0
        finally:
            svc.pump(force=True)
            svc.shutdown()

    def test_deadline_header_becomes_timeout(self, rng):
        ds = rng.standard_normal((32, 4)).astype(np.float32)
        svc = SearchService(max_batch=4, start_workers=False)
        svc.publish("corpus", bf_index(ds), k=5, warm=False)
        try:
            with NetServer(svc) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                with pytest.raises(DeadlineExceededError):
                    cli.search("corpus", ds[:1], 5, timeout_s=-1.0)
        finally:
            svc.shutdown()

    def test_control_route_upsert_delete_flush(self, rng):
        """The write path over the wire: a MutableIndex published on the
        service takes upserts and deletes through ``/v1/control``."""
        from raft_tpu_torch.stream import MutableIndex

        ds = rng.standard_normal((64, 8)).astype(np.float32)
        svc = SearchService(max_batch=4, start_workers=False)
        svc.publish("m", MutableIndex(bf_index(ds), delta_capacity=16), k=5,
                    warm=False)
        try:
            with NetServer(svc) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                rows = ds[:2] + 100.0
                ids = cli.upsert("m", rows, np.array([500, 501]))
                assert ids.tolist() == [500, 501]
                fut = svc.submit("m", rows, 5)
                assert cli.flush() == 2
                assert fut.result()[1][:, 0].tolist() == [500, 501]
                assert cli.delete("m", np.array([500, 999])) == 1
                with pytest.raises(RaftError, match="unknown control op"):
                    cli._post("/v1/control", wire.encode_control("nope"), {}, None)
        finally:
            svc.shutdown()


# ---------------------------------------------------------------------------
# Retry-After hint through submit_with_retry
# ---------------------------------------------------------------------------


class _ScriptedService:
    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def submit(self, name, queries, k, timeout_s=None):
        self.calls.append(timeout_s)
        if self.script:
            err = self.script.pop(0)
            if err is not None:
                raise err
        return "future"


def _overload_with_hint(hint):
    exc = OverloadedError("full")
    exc.retry_after_s = hint
    return exc


class TestRetryAfterHint:
    def test_hint_overrides_exponential_backoff(self):
        sleeps = []
        svc = _ScriptedService([_overload_with_hint(0.123), None])
        fut = submit_with_retry(svc, "main", None, 5, base_s=10.0,
                                jitter=0.0, sleep=sleeps.append)
        assert fut == "future"
        # jitter=0: the sleep IS the server's hint, not base_s
        assert sleeps == [pytest.approx(0.123)]

    def test_hint_jitters_upward_only(self):
        sleeps = []
        svc = _ScriptedService([_overload_with_hint(0.1)] * 4 + [None])
        rng = __import__("random").Random(3)
        submit_with_retry(svc, "main", None, 5, jitter=0.5, rng=rng,
                          max_attempts=10, sleep=sleeps.append)
        assert all(0.1 <= s <= 0.15 for s in sleeps)

    def test_refusal_without_hint_falls_back_to_backoff(self):
        sleeps = []
        svc = _ScriptedService([OverloadedError("full"), None])
        submit_with_retry(svc, "main", None, 5, base_s=0.01, jitter=0.0,
                          sleep=sleeps.append)
        assert sleeps == [pytest.approx(0.01)]

    def test_hint_still_respects_deadline(self):
        clock = FakeClock()
        svc = _ScriptedService([_overload_with_hint(5.0)] * 2)
        with pytest.raises(DeadlineExceededError):
            submit_with_retry(svc, "main", None, 5, timeout_s=1.0,
                              jitter=0.0, clock=clock,
                              sleep=lambda dt: clock.advance(dt))
        assert clock.t == 0.0  # refused to sleep into the budget
        assert len(svc.calls) == 1

    def test_deadline_exceeded_never_retries_regression(self):
        # even with a tempting hint attached, a spent deadline is final
        exc = DeadlineExceededError("late")
        exc.retry_after_s = 0.001
        svc = _ScriptedService([exc, None])
        with pytest.raises(DeadlineExceededError):
            submit_with_retry(svc, "main", None, 5, sleep=lambda dt: None)
        assert len(svc.calls) == 1

    def test_client_is_the_retry_discipline_over_the_wire(self, rng):
        """``NetClient`` is submit-shaped: ``submit_with_retry`` drives it
        across a front door and gets the service's answer."""
        ds = rng.standard_normal((64, 8)).astype(np.float32)
        svc = SearchService(max_batch=4)
        svc.publish("corpus", bf_index(ds), k=5, warm=False)
        try:
            with NetServer(svc) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                d, i = submit_with_retry(cli, "corpus", ds[:2], 5,
                                         timeout_s=30.0).result()
                assert i[:, 0].tolist() == [0, 1]
        finally:
            svc.shutdown()


# ---------------------------------------------------------------------------
# rid threading: one trace spans wire→queue→flush
# ---------------------------------------------------------------------------


class TestRidThreading:
    def test_wire_rid_lands_in_request_log_with_spans(self, rng):
        ds = rng.standard_normal((64, 8)).astype(np.float32)
        rl = requestlog.RequestLog()
        svc = SearchService(max_batch=8, request_log=rl)
        svc.publish("corpus", bf_index(ds), k=5, warm=False)
        try:
            with NetServer(svc, request_log=rl) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                _, _, meta = cli.request("corpus", ds[:2], 5,
                                         rid="trace-abc-1")
                # the server echoes the client's rid
                assert meta["rid"] == "trace-abc-1"
                entry = rl.get("trace-abc-1")
                assert entry is not None
                assert "queue" in entry["spans_ms"]
                assert "flush" in entry["spans_ms"]
                # server-minted rids when the client sends none
                _, _, meta2 = cli.request("corpus", ds[:2], 5)
                assert meta2["rid"].startswith("wire-")
                assert rl.get(meta2["rid"]) is not None
        finally:
            svc.shutdown()

    def test_span_header_decomposes_wire_queue_flush(self, rng):
        ds = rng.standard_normal((64, 8)).astype(np.float32)
        rl = requestlog.RequestLog()
        svc = SearchService(max_batch=8, request_log=rl)
        svc.publish("corpus", bf_index(ds), k=5, warm=False)
        try:
            with NetServer(svc, request_log=rl) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                # the attach is best-effort per request; across a few
                # requests the decomposition must be served
                seen = set()
                for _ in range(5):
                    _, _, meta = cli.request("corpus", ds[:2], 5)
                    seen |= set(meta["spans"])
                assert {"wire", "queue", "flush"} <= seen
        finally:
            svc.shutdown()


# ---------------------------------------------------------------------------
# requestlog collect(resume=) cross-process constraint
# ---------------------------------------------------------------------------


class TestCollectorCrossProcess:
    def test_same_process_resume_still_accumulates(self):
        with requestlog.collect() as col:
            requestlog.add_span("a", 0.1)
        with requestlog.collect(resume=col) as col2:
            requestlog.add_span("b", 0.2)
        assert col2 is col
        assert col.spans == {"a": 0.1, "b": 0.2}

    def test_cross_process_resume_degrades_to_fresh_collector(self):
        import os

        with requestlog.collect() as col:
            requestlog.add_span("a", 0.1)
        col.pid = os.getpid() + 1  # simulate a fork/spawn-carried collector
        with requestlog.collect(resume=col) as col2:
            requestlog.add_span("b", 0.2)
        # the foreign trace was NOT mutated; the degrade is marked
        assert col2 is not col
        assert col.spans == {"a": 0.1}
        assert col2.spans == {"b": 0.2}
        assert col2.notes["resume_degraded"] == "cross-process"


# ---------------------------------------------------------------------------
# the multi-process mesh (workers on the CPU)
# ---------------------------------------------------------------------------


class TestProcessMesh:
    def test_scatter_gather_kill_failover_and_outage(self, rng):
        ds = rng.standard_normal((400, 8)).astype(np.float32)
        q = rng.standard_normal((6, 8)).astype(np.float32)
        # exact in-process answer to hold the mesh to
        svc = SearchService(max_batch=8)
        svc.publish("ref", bf_index(ds), k=10, warm=False)
        try:
            _, ref_ids = svc.search("ref", q, 10)
        finally:
            svc.shutdown()
        ref_sorted = np.sort(np.asarray(ref_ids), axis=1)

        seq0 = obs_events.last_seq()
        mesh = ProcessMesh(ds, spec=MeshSpec(**CPU_MESH))
        try:
            # cross-process scatter-gather == the single-index answer
            d, i = mesh.search("corpus", q, 10)
            assert np.array_equal(np.sort(np.asarray(i), axis=1), ref_sorted)
            assert np.all(np.diff(np.asarray(d), axis=1) >= 0)  # sorted

            # warm ladder rehearsed per worker: the fleet served with
            # ZERO kernel builds
            st = mesh.stats()
            assert st["workers"] == 4
            assert st["cache_misses"] == 0 and st["compile_s"] == 0.0
            assert sorted(mesh.boot_s) == ["s0r0", "s0r1", "s1r0", "s1r1"]

            # kill one worker: strike→fence→failover, NOT an outage.
            # Per-shard round-robin alternates the group's primary, so
            # within two searches the dead twin is tried (and struck)
            # deterministically.
            mesh.kill_worker(0, 0)
            for _ in range(2):
                d2, i2 = mesh.search("corpus", q, 10)
                assert np.array_equal(np.sort(np.asarray(i2), axis=1),
                                      ref_sorted)
            evs = obs_events.query(since_seq=seq0)
            kinds = [e["kind"] for e in evs]
            assert "net_worker_fenced" in kinds
            assert "net_worker_failover" in kinds
            health = mesh.health()
            assert health["shards"][0]["healthy"] == 1
            assert health["shards"][1]["healthy"] == 2

            # the front door folds mesh health: degraded, still 200
            with NetServer(mesh, stats=mesh.stats) as srv:
                cli = NetClient(f"http://127.0.0.1:{srv.port}")
                code, body = cli.healthz()
                assert code == 200 and body["status"] == "degraded"
                d3, i3 = cli.search("corpus", q, 10)
                assert np.array_equal(np.sort(np.asarray(i3), axis=1),
                                      ref_sorted)
                assert cli.stats()["unreachable"] == ["s0r0"]

                # kill the surviving twin: a whole group down IS an
                # outage — ReplicaUnavailableError, exact type + fields
                # across the wire
                mesh.kill_worker(0, 1)
                with pytest.raises(ReplicaUnavailableError) as ei:
                    cli.search("corpus", q, 10)
                assert type(ei.value) is ReplicaUnavailableError
                assert ei.value.replicas == 2
                assert ei.value.name.endswith("/s0")
                code, body = cli.healthz()
                assert code == 503 and body["status"] == "failing"
        finally:
            mesh.close()

    def test_writes_route_by_shared_hash_and_survive_a_dead_twin(self, rng):
        ds = rng.standard_normal((300, 8)).astype(np.float32)
        mesh = ProcessMesh(ds, spec=MeshSpec(**CPU_MESH))
        try:
            mesh.kill_worker(1, 0)  # a dead twin must not block writes
            rows = rng.standard_normal((8, 8)).astype(np.float32)
            ids = np.arange(50_000, 50_008)
            mesh.upsert("corpus", rows, ids=ids)
            _, got = mesh.search("corpus", rows, 10)
            assert np.array_equal(np.asarray(got)[:, 0], ids)
            assert mesh.delete("corpus", ids) == len(ids)
            _, got2 = mesh.search("corpus", rows, 10)
            assert not np.intersect1d(np.asarray(got2), ids).size
            with pytest.raises(RaftError):
                mesh.upsert("corpus", rows)  # global ids are required
            # the launch tally the JAX stats lack: one entry per kernel,
            # summed over the live workers (the CPU route launches none)
            st = mesh.stats()
            assert st["workers"] == 3 and st["unreachable"] == ["s1r0"]
            assert set(st["launches"]) == {
                "fused_knn_rows", "fused_knn_tf32x3", "fused_knn_tc", "bf16_split",
                "tf32_split", "topk", "pq_scan", "pq_scan_topk", "cagra_hop"}
            assert all(v == 0 for v in st["launches"].values())
            assert sorted(st["per_worker"]) == ["s0r0", "s0r1", "s1r1"]
            assert st["per_worker"]["s0r0"]["device"] == "cpu"
            assert st["per_worker"]["s0r0"]["rows"] + st["per_worker"]["s1r1"]["rows"] == 300
        finally:
            mesh.close()


def test_mesh_spec_defaults_to_the_card_and_matches_jax_otherwise():
    from raft_tpu.net.mesh import MeshSpec as JSpec

    assert MeshSpec().device == "cuda"
    mine = {k: v for k, v in MeshSpec().__dict__.items() if k != "device"}
    assert mine == JSpec().__dict__


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_worker_without_a_card_fails_its_boot(rng):
    """A worker asked for ``cuda`` where there is none fails its boot with
    its traceback; it never builds on the CPU."""
    ds = rng.standard_normal((40, 8)).astype(np.float32)
    with pytest.raises(RaftError, match="failed to boot") as ei:
        ProcessMesh(ds, spec=MeshSpec(n_shards=1, n_replicas=1))
    assert "no CUDA device" in str(ei.value)
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("raft-net-worker-")]


def test_mesh_merge_breaks_ties_like_jax(rng):
    """The router's host merge is the JAX package's numpy merge: parts with
    tied distances across shards come out in the same order."""
    from raft_tpu.net.mesh import ProcessMesh as JMesh

    class Parts:
        def __init__(self, parts):
            self.spec = MeshSpec(n_shards=len(parts))
            self._pool = __import__("concurrent.futures").futures.ThreadPoolExecutor(2)
            self.parts = parts

        def _scatter_one(self, s, q, k, timeout_s, rid):
            return self.parts[s]

    d = np.round(rng.random((5, 6)) * 4).astype(np.float32) / 4  # many ties
    parts = [(np.sort(d[:, :3], 1), rng.integers(0, 99, (5, 3))),
             (np.sort(d[:, 3:], 1), rng.integers(100, 199, (5, 3)))]
    q = np.zeros((5, 2), np.float32)
    mine, theirs = Parts(parts), Parts(parts)
    try:
        got = ProcessMesh._search(mine, q, 4, None, None)
        want = JMesh._search(theirs, q, 4, None, None)
    finally:
        mine._pool.shutdown()
        theirs._pool.shutdown()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# nothing left running (keep last in the file)
# ---------------------------------------------------------------------------


def _leftovers():
    threads = [t.name for t in threading.enumerate()
               if t.name.startswith(("raft-net-", "raft-httpd", "raft-obs-exporter",
                                     "raft-control-"))]
    procs = [p.name for p in multiprocessing.active_children()
             if p.name.startswith("raft-net-worker-")]
    return threads, procs


def test_no_front_door_thread_or_mesh_worker_left():
    deadline = time.monotonic() + 10.0
    while _leftovers() != ([], []) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _leftovers() == ([], [])
