"""raft_tpu_torch.obs.{quality,slo}, tune.decisions and the flight recorder
against the JAX package's modules (tier-1 ``quality`` marker).

Each piece is fed the same inputs on both sides and answers the same:

- ``wilson_interval`` bit for bit;
- ``RecallCanary``: the same seed over the same flushes samples the same
  queries (``random.Random``), so the reservoir, the counts and the
  estimate equal the JAX canary's over one deterministic oracle; over a
  port ``MutableIndex`` the canary's estimate is the recall measured against
  ``exact_search`` and falls in its own interval;
- ``DriftDetector`` reports and its ``retune_advised`` events, under one
  injected clock; ``local_scale_cv`` / ``list_size_cv`` / ``family_of``;
- ``SLOTracker`` burn rates, verdicts and ``healthz`` under an injected
  clock;
- ``DecisionLog`` JSON both ways (byte for byte);
- ``Compactor(drift=)``'s compaction-time report;
- the flight recorder's bundle on a failing verdict, its rate limit;
- ``SearchService(canary=, slo=)`` serving a tiered mutable index's
  ``refined_searcher()``.

Everything runs on the CPU.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.obs import events as jev
from raft_tpu.obs import quality as jq
from raft_tpu.obs import slo as jslo
from raft_tpu.tune import decisions as jdec
from raft_tpu_torch import stream
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.obs import events, metrics, quality, requestlog, slo
from raft_tpu_torch.serve import SearchService
from raft_tpu_torch.tune import decisions

pytestmark = pytest.mark.quality

CPU = Resources(device="cpu")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def fresh_journals():
    metrics.enable()
    events.configure(capacity=2048)
    jev.configure(capacity=2048)
    yield
    events.disarm_flight_recorder()
    jev.disarm_flight_recorder()
    events.configure(capacity=2048)
    jev.configure(capacity=2048)


# -- statistics ----------------------------------------------------------------------

@pytest.mark.parametrize("s,t,z", [(0, 0, 1.96), (0, 10, 1.96), (10, 10, 1.96),
                                   (97, 100, 1.96), (4321, 5000, 2.576), (1, 3, 1.0)])
def test_wilson_interval_equals_jax(s, t, z):
    assert quality.wilson_interval(s, t, z) == jq.wilson_interval(s, t, z)


# -- the canary ---------------------------------------------------------------------

def _table_oracle(dim, dtype="float32"):
    """A deterministic oracle both canaries can call: ids from the query's
    first coordinate (so a served id list can be made to match it or not)."""
    def fn(queries, k):
        q = np.asarray(queries.cpu() if isinstance(queries, torch.Tensor) else queries)
        base = np.floor(np.abs(q[:, :1]) * 100).astype(np.int64)
        ids = base + np.arange(k)[None, :]
        ids[q[:, 1] < -1.5] = -1          # rows the live corpus cannot fill
        return np.zeros(ids.shape, np.float32), ids

    fn.dim, fn.query_dtype = dim, dtype
    return fn


@pytest.mark.parametrize("rate,reservoir", [(1.0, 256), (0.3, 256), (0.5, 8), (0.0, 16)])
def test_canary_samples_and_estimates_as_jax(rate, reservoir):
    """Same seed, same flushes: the same queries are kept, the same ones
    displaced, and drain gives the same estimate (point value, Wilson
    bounds, counts) and the same per-drain pending counts."""
    r = np.random.default_rng(1)
    flushes = []
    for _ in range(6):
        q = r.standard_normal((13, 4)).astype(np.float32)
        truth = _table_oracle(4)(q, 5)[1]
        served = truth.copy()
        served[r.random(served.shape) < 0.2] += 1000     # some misses
        flushes.append((q, served))
    out = []
    for mod in (quality, jq):
        c = mod.RecallCanary(_table_oracle(4), k=5, sample_rate=rate,
                             reservoir=reservoir, buckets=(1, 2, 4, 8), seed=9,
                             name=f"canary_{rate}_{reservoir}")
        trail = []
        for i, (q, served) in enumerate(flushes):
            trail.append(c.offer(torch.from_numpy(q) if mod is quality else q, served))
            if i == 2:
                trail.append((c.pending(), c.drain()))
        trail.append((c.pending(), c.drain(), c.pending()))
        est = c.estimate()
        out.append((trail, {k: (None if isinstance(v, float) and math.isnan(v) else v)
                            for k, v in est.items()}))
    assert out[0] == out[1]
    if rate == 1.0:
        assert out[0][1]["seen"] == 78 and 0.7 < out[0][1]["recall"] < 0.9


def test_canary_over_a_mutable_index_brackets_measured_recall():
    """A port ``MutableIndex``'s ``exact_search`` as the oracle: the canary's
    estimate equals the recall of the offered ids against it, and lies in
    its own Wilson interval; warm() runs the oracle at every bucket."""
    r = np.random.default_rng(3)
    x = r.standard_normal((600, 16)).astype(np.float32)
    p = ivf_pq.IndexParams(n_lists=8, pq_bits=4, pq_dim=8, seed=0)
    m = stream.MutableIndex(ivf_pq.build(p, x, res=CPU), dataset=x,
                            search_params=ivf_pq.SearchParams(n_probes=2),
                            storage="tiered", name="canary_m")
    oracle = quality.exact_oracle(m)
    assert (oracle.dim, oracle.query_dtype) == (16, "float32")
    c = quality.RecallCanary(oracle, k=5, sample_rate=1.0, buckets=(1, 2, 4, 8, 16),
                             name="canary_m", seed=3)
    warm = c.warm()
    assert sorted(warm) == [1, 2, 4, 8, 16]
    q = r.standard_normal((40, 16)).astype(np.float32)
    _, served = m.search(q, 5)
    c.offer(q, served)
    assert c.drain() == 40
    _, truth = m.exact_search(q, 5)
    measured = np.mean([len(set(served[i].tolist()) & set(truth[i].tolist())) / 5
                        for i in range(40)])
    est = c.estimate()
    assert est["recall"] == pytest.approx(measured, abs=1e-12)
    assert c.in_interval(measured) and est["wilson_low"] < measured < est["wilson_high"]
    snap = metrics.to_json()
    assert snap['raft_tpu_quality_canary_reranked_total{name="canary_m"}'] == 40


def test_exact_oracle_of_a_sealed_index():
    """A sealed index needs its rows (the JAX error text); with them the
    oracle is ``brute_force.knn`` in the index's metric, on its device."""
    r = np.random.default_rng(4)
    x = r.standard_normal((300, 8)).astype(np.float32)
    q = r.standard_normal((5, 8)).astype(np.float32)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=4, seed=0), x, res=CPU)
    with pytest.raises(RaftError) as e:
        quality.exact_oracle(idx)
    with pytest.raises(Exception) as je:
        jq.exact_oracle(object())
    assert str(e.value).split(" index —")[1] == str(je.value).split(" index —")[1]
    d, i = quality.exact_oracle(idx, dataset=x)(q, 4)
    wd, wi = brute_force.knn(torch.from_numpy(x), torch.from_numpy(q), 4, res=CPU)
    assert torch.equal(i, wi) and torch.equal(d, wd)


def test_canary_refusals_match_jax():
    for kw in (dict(sample_rate=1.5), dict(reservoir=0), dict(buckets=(0,))):
        with pytest.raises(RaftError) as e:
            quality.RecallCanary(_table_oracle(2), **kw)
        with pytest.raises(Exception) as je:
            jq.RecallCanary(_table_oracle(2), **kw)
        assert str(e.value) == str(je.value)


# -- drift ---------------------------------------------------------------------------

def _families():
    r = np.random.default_rng(6)
    iso = r.standard_normal((1500, 32)).astype(np.float32)
    centers = r.standard_normal((30, 32)) * 4
    scales = np.exp(r.normal(0, 1.5, 30))
    lab = r.integers(0, 30, 1500)
    heavy = (centers[lab] + r.standard_normal((1500, 32)) * scales[lab, None]).astype(
        np.float32)
    return iso, heavy


def test_classifiers_equal_jax():
    iso, heavy = _families()
    for rows in (iso, heavy, iso[:5]):
        assert decisions.local_scale_cv(torch.from_numpy(rows)) == jdec.local_scale_cv(rows)
    sizes = np.array([0, 5, 9, 13, 0, 40], np.int32)
    assert decisions.list_size_cv(torch.from_numpy(sizes)) == jdec.list_size_cv(sizes)
    for n, d, b in ((12_000, 100, "bal"), (800_000, 128, "skew"), (50, 3, "clump")):
        assert decisions.shape_family(n, d, b) == jdec.shape_family(n, d, b)
    assert decisions.local_scale_cv(heavy) > decisions.SCALE_CV_THRESHOLD > \
        decisions.local_scale_cv(iso)


def test_family_of_equals_jax(tmp_path):
    """family_of reads the same structure off a port index as off the JAX
    index it was loaded from (brute force: the rows' scale CV; IVF-Flat:
    list sizes, then rows sampled from every list)."""
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu.neighbors import ivf_flat as jfl

    _, heavy = _families()
    jb = jbf.BruteForce().build(jnp.asarray(heavy))
    tb = brute_force.BruteForce().build(heavy, res=CPU)
    assert decisions.family_of(tb) == jdec.family_of(jb) == "1k-d32-skew"
    jf = jfl.build(jfl.IndexParams(n_lists=8, seed=0), jnp.asarray(heavy))
    jfl.save(jf, str(tmp_path / "fl.bin"))
    tf = ivf_flat.load(str(tmp_path / "fl.bin"), res=CPU)
    assert decisions.family_of(tf) == jdec.family_of(jf)
    assert decisions.kind_of(tf) == jdec.kind_of(jf) == "ivf_flat"
    with pytest.raises(RaftError, match="no tune support"):
        decisions.kind_of(object())


@pytest.mark.parametrize("feed", ["queries", "compaction"])
def test_drift_detector_reports_and_events_equal_jax(feed):
    """One pinned family, one sequence of feeds (in family, out, back in,
    out again): the same reports, the same single ``retune_advised`` a
    transition, the same gauge."""
    iso, heavy = _families()
    out = []
    for mod, ev in ((quality, events), (jq, jev)):
        clk = FakeClock(5.0)
        det = mod.DriftDetector("1k-d32-bal", name=f"drift_{feed}", min_rows=64,
                                sample_cap=512, clock=clk)
        reps = []
        for rows in (iso, heavy, iso, heavy):
            clk.advance(1.0)
            if feed == "queries":
                assert det.check() is None or reps
                det.offer_rows(rows[:600])
                reps.append(det.check())
            else:
                reps.append(det.check(rows=rows, n_rows=rows.shape[0], dim=32,
                                      source="compaction"))
        out.append((reps, det.drifted(), det.buffered(),
                    [{k: v for k, v in e.items()} for e in det.events]))
    assert out[0] == out[1]
    reps = out[0][0]
    assert [r["drifted"] for r in reps] == [False, True, False, True]
    assert len(out[0][3]) == 2 and out[0][3][0]["auto_apply"] is False
    with pytest.raises(RaftError, match="structured 'rows-dim-balance' key"):
        quality.DriftDetector("nope")
    dec = decisions.Decision("ivf_pq", "float32", "1k-d32-bal", {"n_probes": 8})
    assert quality.DriftDetector.from_decision(dec).pinned_family == "1k-d32-bal"


def test_compactor_drift_feed_equals_jax_check():
    """``Compactor(drift=)`` feeds each fold's retained rows and live count
    to the detector: its report is the JAX detector's on the same rows."""
    iso, heavy = _families()
    clk = FakeClock(1.0)
    det = quality.DriftDetector("1k-d32-bal", name="comp_drift", clock=clk)
    bf = brute_force.BruteForce().build(heavy, res=CPU)
    m = stream.MutableIndex(bf, delta_capacity=64, name="comp_drift", clock=clk)
    comp = stream.Compactor(m, drift=det,
                            policy=stream.CompactionPolicy(delta_fill=0.5))
    m.upsert(iso[:40])
    rep = comp.run_once()
    assert rep is not None and rep["trigger"] == "delta_fill"
    want = jq.DriftDetector("1k-d32-bal", name="comp_drift", clock=clk).check(
        rows=np.concatenate([heavy, iso[:40]]), n_rows=m.size, dim=32,
        source="compaction")
    assert rep["drift"] == want and want["drifted"] and want["source"] == "compaction"
    with pytest.raises(RaftError, match="DriftDetector"):
        stream.Compactor(m, drift=object())


# -- SLO -------------------------------------------------------------------------------

def _drive_slo(mod, ev_mod, clk):
    t = mod.SLOTracker(mod.SLOPolicy(windows_s=(60.0, 300.0), slot_s=30.0,
                                     failing_burn=5.0), name="slo_par", clock=clk)
    trail = [t.status()]
    for step in range(12):
        clk.advance(17.0)
        for i in range(20):
            t.record_admission(not (step in (3, 4, 5) and i % 2 == 0))
            t.record_request(0.01 * (i % 3), 0.2 if step in (7, 8) else 0.05)
        t.record_quality(8 if step != 10 else 2, 10)
        trail.append((t.burn_rates(), t.status(), t.burn_snapshot()))
    trail.append(t.healthz())
    kinds = [(e["kind"], e["evidence"].get("status"), e["evidence"].get("previous"))
             for e in ev_mod.query(kind="slo_verdict")]
    return trail, kinds


def test_slo_tracker_equals_jax():
    """Burn rates over both windows, verdicts, the burn snapshot, healthz and
    the ``slo_verdict`` transitions equal the JAX tracker's, step by step,
    under one injected clock."""
    got = _drive_slo(slo, events, FakeClock(100.0))
    want = _drive_slo(jslo, jev, FakeClock(100.0))
    assert got == want
    statuses = [s[1] for s in got[0][1:-1]]
    assert "failing" in statuses and "degraded" in statuses
    assert got[0][-1][0] in (200, 503)


def test_slo_policy_checks_equal_jax():
    for kw in (dict(availability_target=1.5), dict(slot_s=0.0),
               dict(slot_s=30.0, windows_s=(100.0,)), dict(recall_floor=0.0)):
        with pytest.raises(RaftError) as e:
            slo.SLOTracker(slo.SLOPolicy(**kw))
        with pytest.raises(Exception) as je:
            jslo.SLOTracker(jslo.SLOPolicy(**kw))
        assert str(e.value) == str(je.value)
    t = slo.SLOTracker()
    with pytest.raises(RaftError, match="matched_slots"):
        t.record_quality(5, 3)
    with pytest.raises(RaftError, match="unknown objective"):
        t.burn_rate("speed", 300.0)


# -- decisions -------------------------------------------------------------------------

def test_decision_log_json_both_ways(tmp_path):
    """A JAX-saved log loads into the port; the port's save of it is the JAX
    file byte for byte, and loads back in JAX; resolve() keeps to the
    balance class in both."""
    jlog = jdec.DecisionLog(meta={"round": "r08", "backend": "cpu"})
    jlog.add(jdec.Decision("ivf_pq", "float32", "1k-d32-bal", {"n_probes": 8},
                           {"recall": 0.93, "trials": [{"n_probes": 4, "qps": 1.5}]}))
    jlog.add(jdec.Decision("ivf_flat", "uint8", "100k-d128-skew", {"n_probes": 32}))
    jlog.add(jdec.Decision.from_dict({"kind": "cagra", "params": {"itopk_size": 64}}))
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jlog.save(jp)
    log = decisions.DecisionLog.load(jp)
    assert log.to_json() == jlog.to_json() and len(log) == 3
    log.save(tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    assert jdec.DecisionLog.load(tp).to_json() == jlog.to_json()
    iso, _ = _families()
    bf = brute_force.BruteForce().build(iso, res=CPU)
    assert log.resolve(bf) is None
    with pytest.raises(RaftError, match="not a tune decision-log artifact"):
        decisions.DecisionLog.from_json({"format": "other"})
    with pytest.raises(RaftError, match="unknown decision kind"):
        log.add(decisions.Decision("nope", "float32", "any", {}))


# -- the flight recorder -----------------------------------------------------------------

def _record(ev_mod, slo_mod, rl_mod, path):
    clk = FakeClock()
    ev_mod.configure(capacity=256, clock=clk)
    rl = rl_mod.RequestLog(clock=clk)
    rid = rl.begin("s", 1)
    rl.complete(rid, stream="s", rows=1, spans={"queue": 0.001, "flush": 0.002})
    ev_mod.arm_flight_recorder(str(path), request_log=rl, min_interval_s=300.0, window=4)
    for i in range(6):
        ev_mod.emit("replica_probe", subject=("replica", "g", i % 2))
    tracker = slo_mod.SLOTracker(slo_mod.SLOPolicy(failing_burn=5.0), name="evt-slo",
                                 clock=clk)
    for _ in range(50):
        tracker.record_admission(False)
    status = tracker.status()
    bundles = sorted(p for p in path.iterdir() if p.is_dir())
    files = sorted(f.name for f in bundles[0].iterdir())
    window = json.loads((bundles[0] / "events.json").read_text())
    meta = json.loads((bundles[0] / "meta.json").read_text())
    reqs = json.loads((bundles[0] / "requests.json").read_text())
    crumbs = ev_mod.query(kind="flight_recorder")
    # the rate limit: a second failing transition inside the interval writes none
    tracker2 = slo_mod.SLOTracker(slo_mod.SLOPolicy(failing_burn=5.0), name="evt-2",
                                  clock=clk)
    for _ in range(50):
        tracker2.record_admission(False)
    tracker2.status()
    n_after = len([p for p in path.iterdir() if p.is_dir()])
    clk.advance(10.0)
    manual = ev_mod.snapshot("manual")
    return (status, [b.name for b in bundles], files,
            [(e["kind"], e["seq"]) for e in window], meta, reqs["recent"][0]["rid"] == rid,
            [c["evidence"]["events"] for c in crumbs], n_after,
            manual is not None and manual.endswith("-manual"))


def test_flight_recorder_bundle_equals_jax(tmp_path):
    """A failing SLO verdict writes one bundle, as the JAX recorder does:
    the same name, files, event window, meta and breadcrumb; a second one
    inside the interval is suppressed; an explicit snapshot is not."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    from raft_tpu.obs import requestlog as jrl

    got = _record(events, slo, requestlog, tmp_path / "port")
    want = _record(jev, jslo, jrl, tmp_path / "jax")
    assert got == want
    assert got[0] == "failing" and len(got[1]) == 1 and got[1][0].endswith("-slo_failing")
    assert got[2] == ["events.json", "mem.json", "meta.json", "metrics.json",
                      "requests.json"]
    assert got[7] == 1 and got[8]
    events.disarm_flight_recorder()
    assert events.snapshot("nowhere") is None


# -- the service hooks ---------------------------------------------------------------------

def test_service_serves_a_tiered_index_with_canary_and_slo():
    """A tiered mutable's ``refined_searcher()`` publishes and serves through
    ``SearchService`` with a real ``RecallCanary`` and ``SLOTracker``: every
    served row is the direct ``search_refined`` row, the canary's estimate is
    the recall against ``exact_search`` and lies in its interval, the SLO
    sees every admission and request, and writes go through the service."""
    r = np.random.default_rng(8)
    x = r.standard_normal((700, 16)).astype(np.float32)
    p = ivf_pq.IndexParams(n_lists=8, pq_bits=4, pq_dim=8, seed=0)
    m = stream.MutableIndex(ivf_pq.build(p, x, res=CPU), dataset=x, index_params=p,
                            search_params=ivf_pq.SearchParams(n_probes=2),
                            storage="tiered",
                            tier=stream.TierPolicy(oracle_chunk=256), name="svc_tier")
    clk = FakeClock()
    tracker = slo.SLOTracker(slo.SLOPolicy(), name="svc_tier", clock=clk)
    canary = quality.RecallCanary(quality.exact_oracle(m), k=5, sample_rate=1.0,
                                  buckets=(1, 2, 4, 8), name="svc_tier", seed=0,
                                  slo=tracker)
    svc = SearchService(max_batch=8, start_workers=False, clock=clk, canary=canary,
                        slo=tracker)
    svc.publish("svc_tier", m.refined_searcher(refine_ratio=4), k=5, warm=False)
    q = r.standard_normal((24, 16)).astype(np.float32)
    futs = [svc.submit("svc_tier", q[i:i + 1], 5) for i in range(24)]
    while svc.pump(force=True):
        pass
    served = np.concatenate([np.asarray(f.result()[1]) for f in futs])
    for i in range(24):
        np.testing.assert_array_equal(served[i], m.search_refined(q[i:i + 1], 5)[1][0].numpy())
    assert canary.pending() == 24 and canary.drain() == 24
    truth = m.exact_search(q, 5)[1].numpy()
    measured = np.mean([len(set(served[i]) & set(truth[i])) / 5 for i in range(24)])
    assert canary.estimate()["recall"] == pytest.approx(measured, abs=1e-12)
    assert canary.in_interval(measured)
    code, body = tracker.healthz()
    assert code == 200 and body["status"] in ("ready", "degraded")
    snap = metrics.to_json()
    assert snap['raft_tpu_slo_events_total{objective="availability",outcome="good"}'] >= 24
    assert snap['raft_tpu_slo_events_total{objective="quality",outcome="good"}'] >= 1
    ids = svc.upsert("svc_tier", x[:2] + 0.01)
    assert len(ids) == 2 and m.size == 702
    svc.shutdown()
