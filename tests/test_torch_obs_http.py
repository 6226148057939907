"""raft_tpu_torch.obs.http against raft_tpu.obs.http (tier-1 ``net`` marker).

The exporter's cases of the JAX suite on the port — the ``/healthz``
replica fold and its endpoint (tests/test_faults.py), ``/debug/mem`` and
the 404 contract (tests/test_obs_mem.py), the route table and the 503 on a
failing SLO (tests/test_obs_quality.py) — and the port held against the
JAX package where the two meet:

- ``_fold_replica_health`` gives both packages' ``(code, body)`` for the
  same health dicts: all healthy, one twin fenced, a group at zero and a
  reshard in flight, under a ready, degraded and failing verdict;
- the same SLO feed gives the same ``/healthz`` answer from both
  packages' exporters, and the same request trace the same
  ``/debug/requests`` keys;
- the mesh's ``/healthz`` fold over a port ``ShardedMutableIndex`` with
  replicas, and ``/debug/events`` / ``/debug/control`` routing.

Every exporter is stopped in a ``with`` or ``finally``; the last test
checks that no exporter thread is left.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu.obs import http as jhttp
from raft_tpu.obs import requestlog as jrequestlog
from raft_tpu.obs import slo as jslo
from raft_tpu_torch import obs
from raft_tpu_torch.core import Resources
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.obs import events as obs_events
from raft_tpu_torch.obs import http
from raft_tpu_torch.obs import mem as obs_mem
from raft_tpu_torch.obs import requestlog, slo
from raft_tpu_torch.serve import ReplicaUnavailableError
from raft_tpu_torch.stream import (FencingPolicy, ReplicatedShard,
                                   ShardedMutableIndex)
from raft_tpu_torch.testing import faults

pytestmark = pytest.mark.net

CPU = Resources(device="cpu")


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


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    leaked = faults.armed()
    faults.clear()
    assert not leaked, "test left faults armed"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


@pytest.fixture
def data(rng):
    return rng.standard_normal((256, 16)).astype(np.float32)


@pytest.fixture
def queries(rng):
    return rng.standard_normal((6, 16)).astype(np.float32)


def bf_build(x):
    return brute_force.BruteForce().build(x, res=CPU)


def group(data, clock, *, n_replicas=2, policy=None, **kw):
    return ReplicatedShard(
        bf_build(data), n_replicas=n_replicas, delta_capacity=64,
        policy=policy or FencingPolicy(max_consecutive=1, backoff_s=5.0),
        clock=clock, name="g", **kw)


# ---------------------------------------------------------------------------
# _fold_replica_health parity
# ---------------------------------------------------------------------------


def _rep(name, fenced, stale=False):
    return {"replica": name, "fenced": fenced, "stale": stale, "consecutive": int(fenced),
            "last_error": "FaultError('dead')" if fenced else None}


def _grp(name, fenced_flags):
    reps = [_rep(f"{name}/r{j}", f) for j, f in enumerate(fenced_flags)]
    return {"name": name, "replicas": reps, "healthy": sum(not f for f in fenced_flags)}


HEALTH = {
    "all_healthy": {"name": "mesh", "shards": [_grp("mesh/shard0", [False, False]),
                                              _grp("mesh/shard1", [False, False])],
                    "healthy_min": 2, "reshard": None},
    "one_twin_fenced": {"name": "mesh", "shards": [_grp("mesh/shard0", [True, False]),
                                                  _grp("mesh/shard1", [False, False])],
                        "healthy_min": 1, "reshard": None},
    "group_at_zero": {"name": "mesh", "shards": [_grp("mesh/shard0", [True, True]),
                                                _grp("mesh/shard1", [False, True])],
                      "healthy_min": 0, "reshard": None},
    "reshard_in_flight": {"name": "mesh", "shards": [_grp("mesh/shard0", [False, False]),
                                                    _grp("mesh/shard1", [False, False])],
                          "healthy_min": 2,
                          "reshard": {"from": 2, "to": 4, "phase": "fold", "donor": 1,
                                      "started_at": 12.5}},
    "single_group_fenced": _grp("g", [False, True]),
}

VERDICTS = [(200, {"status": "ready"}), (200, {"status": "degraded", "slo": "x"}),
            (503, {"status": "failing"})]


@pytest.mark.parametrize("case", sorted(HEALTH))
@pytest.mark.parametrize("verdict", range(len(VERDICTS)))
def test_fold_replica_health_equals_jax(case, verdict):
    code, body = VERDICTS[verdict]
    h = HEALTH[case]
    mine = http._fold_replica_health(code, dict(body), json.loads(json.dumps(h)))
    theirs = jhttp._fold_replica_health(code, dict(body), json.loads(json.dumps(h)))
    assert mine == theirs
    want_code = 503 if case == "group_at_zero" or code == 503 else 200
    assert mine[0] == want_code
    if case == "reshard_in_flight":
        assert mine[1]["reshard"]["to"] == 4


# ---------------------------------------------------------------------------
# /healthz replica verdict (tests/test_faults.py's cases)
# ---------------------------------------------------------------------------


def test_healthz_folds_replica_health(data, queries):
    clock = FakeClock()
    g = group(data, clock)
    code, body = http._fold_replica_health(200, {"status": "ready"}, g.health())
    assert (code, body["status"]) == (200, "ready")
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"),
                      match=lambda c: c["replica"].endswith("/r0"))
        while g._health[0].fenced_until is None:
            g.search(queries, 5)
    code, body = http._fold_replica_health(200, {"status": "ready"}, g.health())
    assert (code, body["status"]) == (200, "degraded")  # capacity down
    # a failing SLO verdict is never upgraded by healthy replicas
    code, body = http._fold_replica_health(503, {"status": "failing"}, g.health())
    assert (code, body["status"]) == (503, "failing")
    with faults.scope():
        faults.inject("replica/search", exc=faults.FaultError("dead"))
        with pytest.raises(ReplicaUnavailableError):
            g.search(queries, 5)
    code, body = http._fold_replica_health(200, {"status": "ready"}, g.health())
    assert (code, body["status"]) == (503, "failing")  # zero pickable


def test_healthz_endpoint_serves_replica_detail(data):
    clock = FakeClock()
    g = group(data, clock)
    with http.MetricsExporter(port=0, replicas=g) as exp:
        _, _, raw = _get(f"http://127.0.0.1:{exp.port}/healthz")
    body = json.loads(raw)
    assert body["status"] == "ready"
    assert [r["fenced"] for r in body["replicas"]["replicas"]] == [False, False]


def test_healthz_endpoint_folds_the_sharded_mesh(data, queries):
    """The mesh's fold: a port ShardedMutableIndex with replicas behind the
    exporter answers ready, then degraded with a twin fenced, then 503
    failing with a whole group out."""
    clock = FakeClock()
    sm = ShardedMutableIndex(data, n_shards=2, build=bf_build, replicas=2,
                             delta_capacity=64, clock=clock, name="mesh",
                             fencing=FencingPolicy(max_consecutive=1, backoff_s=5.0))
    with http.MetricsExporter(port=0, replicas=sm) as exp:
        url = f"http://127.0.0.1:{exp.port}/healthz"
        code, _, raw = _get(url)
        assert code == 200 and json.loads(raw)["status"] == "ready"
        assert json.loads(raw)["replicas"]["reshard"] is None
        with faults.scope():
            faults.inject("replica/search", exc=faults.FaultError("dead"),
                          match=lambda c: c["replica"] == "mesh/shard0/r0")
            for _ in range(4):
                sm.search(queries, 5)
        code, _, raw = _get(url)
        assert code == 200 and json.loads(raw)["status"] == "degraded"
        with faults.scope():
            faults.inject("replica/search", exc=faults.FaultError("dead"),
                          match=lambda c: c["replica"].startswith("mesh/shard0/"))
            with pytest.raises(ReplicaUnavailableError):
                sm.search(queries, 5)
        code, _, raw = _get(url)
        assert code == 503 and json.loads(raw)["status"] == "failing"


# ---------------------------------------------------------------------------
# /debug/mem (tests/test_obs_mem.py's cases)
# ---------------------------------------------------------------------------


class TestDebugMemEndpoint:
    def _get(self, port, path):
        code, _, body = _get(f"http://127.0.0.1:{port}{path}")
        return code, body

    def test_debug_mem_routes_and_404_contract(self):
        exp = obs.MetricsExporter(port=0)
        try:
            code, body = self._get(exp.port, "/debug/mem")
            assert code == 200
            payload = json.loads(body)
            # "tiers" registers once a TieredStore has lived in the
            # process — an extra registered section, not a route
            assert set(payload) - {"tiers"} == {"totals", "by_component",
                                                "top", "audit", "hbm"}
            assert payload["totals"]["device_bytes"] >= 0
            assert isinstance(payload["audit"]["retired_unfreed"], list)
            # the 404 contract survives, and names the endpoint
            code, body = self._get(exp.port, "/debug/memx")
            assert code == 404 and "/debug/mem" in body
            code, _ = self._get(exp.port, "/metrics")
            assert code == 200
        finally:
            exp.stop()

    def test_debug_mem_reflects_ledger(self):
        t = obs_mem.account("http_probe", name="probe", device_bytes=12345)
        exp = obs.MetricsExporter(port=0)
        try:
            _, body = self._get(exp.port, "/debug/mem")
            payload = json.loads(body)
            assert "http_probe" in payload["by_component"]
            assert payload["by_component"]["http_probe"]["device_bytes"] == 12345
        finally:
            exp.stop()
            obs_mem.release(t)

    def test_debug_mem_carries_the_tiers_section(self, rng):
        """A live tiered store registers its section on ``/debug/mem``."""
        from raft_tpu_torch.stream import MutableIndex

        x = rng.standard_normal((64, 8)).astype(np.float32)
        m = MutableIndex(bf_build(x), retain_vectors=True, storage="tiered")
        with obs.MetricsExporter(port=0) as exp:
            _, body = self._get(exp.port, "/debug/mem")
        payload = json.loads(body)
        assert "tiers" in payload and payload["tiers"]
        assert m.size == 64


# ---------------------------------------------------------------------------
# the route table (tests/test_obs_quality.py's cases) and parity with JAX
# ---------------------------------------------------------------------------


class TestHttpRouting:
    def test_routes_and_404(self):
        clk = [0.0]
        tracker = slo.SLOTracker(clock=lambda: clk[0])
        rl = requestlog.RequestLog(clock=lambda: clk[0])
        rid = rl.begin("s", 1)
        rl.complete(rid, stream="s", rows=1, spans={"queue": 0.001, "flush": 0.002})
        obs.counter("raft_tpu_items_total", "rows").inc(1, op="route-test")
        with obs.MetricsExporter(port=0, slo=tracker, request_log=rl) as exp:
            base = f"http://127.0.0.1:{exp.port}"
            code, ctype, body = _get(base + "/metrics")
            assert code == 200 and ctype.startswith("text/plain")
            assert 'raft_tpu_items_total{op="route-test"}' in body
            code, ctype, body = _get(base + "/healthz")
            assert code == 200 and ctype.startswith("application/json")
            assert json.loads(body)["status"] == "ready"
            code, _, body = _get(base + "/debug/requests")
            assert code == 200
            payload = json.loads(body)
            assert payload["recent"][0]["rid"] == rid
            assert payload["exemplars"]
            # unknown paths 404 loudly — a scrape-config typo must not
            # silently receive the exposition format
            for bad in ("/", "/metrcs", "/metrics/extra", "/debug"):
                code, _, body = _get(base + bad)
                assert code == 404, bad
                assert "/metrics, /healthz, /debug/requests" in body

    def test_healthz_503_on_failing_and_no_sources(self):
        clk = [0.0]
        tracker = slo.SLOTracker(slo.SLOPolicy(failing_burn=5.0), clock=lambda: clk[0])
        for _ in range(50):
            tracker.record_admission(False)
        with obs.MetricsExporter(port=0, slo=tracker) as exp:
            base = f"http://127.0.0.1:{exp.port}"
            code, _, body = _get(base + "/healthz")
            assert code == 503 and json.loads(body)["status"] == "failing"
            code, _, _ = _get(base + "/debug/requests")
            assert code == 404  # no request log attached
        with obs.MetricsExporter(port=0) as exp:
            code, _, body = _get(f"http://127.0.0.1:{exp.port}/healthz")
            assert code == 200
            assert json.loads(body)["note"] == "no SLO tracker attached"

    @pytest.mark.parametrize("bad", [0, 3, 50])
    def test_healthz_equals_jax_for_the_same_feed(self, bad):
        """Both packages' exporters answer one SLO feed with the same code
        and body, and route the same 404 listing."""
        answers = []
        for slo_mod, http_mod in ((slo, http), (jslo, jhttp)):
            clk = [0.0]
            tracker = slo_mod.SLOTracker(slo_mod.SLOPolicy(failing_burn=5.0),
                                         clock=lambda: clk[0])
            for j in range(100):
                tracker.record_admission(j >= bad)
            with http_mod.MetricsExporter(port=0, slo=tracker) as exp:
                base = f"http://127.0.0.1:{exp.port}"
                code, _, body = _get(base + "/healthz")
                nf_code, _, nf_body = _get(base + "/nope")
            answers.append((code, json.loads(body), nf_code, nf_body))
        assert answers[0] == answers[1]

    def test_debug_requests_keys_equal_jax(self):
        bodies = []
        for mod in (requestlog, jrequestlog):
            rl = mod.RequestLog(clock=lambda: 0.0)
            rid = rl.begin("s", 2, rid="r-1")
            rl.complete(rid, stream="s", rows=2, spans={"queue": 0.001, "flush": 0.002})
            bodies.append(rl.to_json())
        assert set(bodies[0]) == set(bodies[1])
        assert set(bodies[0]["recent"][0]) == set(bodies[1]["recent"][0])

    def test_debug_events_filters_and_pages(self):
        seq0 = obs_events.last_seq()
        for j in range(3):
            obs_events.emit("net_worker_fenced", subject=("net", "probe-mesh", j, None),
                            evidence={"worker": f"s{j}r0"})
        with obs.MetricsExporter(port=0) as exp:
            base = f"http://127.0.0.1:{exp.port}"
            code, _, body = _get(base + f"/debug/events?kind=net_worker_fenced"
                                        f"&since_seq={seq0}&limit=2")
            assert code == 200
            payload = json.loads(body)
            assert len(payload["events"]) == 2
            assert all(e["kind"] == "net_worker_fenced" for e in payload["events"])
            assert payload["last_seq"] >= seq0 + 3
            code, _, _ = _get(base + "/debug/events?limit=x")
            assert code == 400
            code, _, body = _get(base + "/debug/control")
            assert code == 404 and "controller=" in body


def test_module_level_exporter_is_one_per_process():
    first = obs.start_http_exporter(0)
    try:
        assert obs.start_http_exporter(0) is first
        code, _, _ = _get(f"http://127.0.0.1:{first.port}/metrics")
        assert code == 200
    finally:
        obs.stop_http_exporter()
    obs.stop_http_exporter()  # no-op with none running
    again = obs.start_http_exporter(0)
    try:
        assert again is not first
    finally:
        obs.stop_http_exporter()


# ---------------------------------------------------------------------------
# nothing left running (keep last in the file)
# ---------------------------------------------------------------------------


def test_no_exporter_thread_left():
    def left():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(("raft-obs-exporter", "raft-net-", "raft-httpd",
                                      "raft-control-"))]

    deadline = time.monotonic() + 10.0
    while left() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert left() == []
