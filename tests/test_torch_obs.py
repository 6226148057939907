"""raft_tpu_torch.obs (and core.tracing / core.logger) against raft_tpu.obs.

The port keeps its own copies of the JAX package's pure-Python observability
modules; the same operations on both must give the same exposition, journal,
request traces and ledger. Then what is the port's own: build attribution
fed by ``ops._build`` (thread-safe loading, monkeypatched nvcc), launch
counters under threads, ``hbm_stats`` without a card, and tracing ranges.
"""

import ast
import ctypes
import io
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.obs import events as jevents
from raft_tpu.obs import mem as jmem
from raft_tpu.obs import metrics as jmetrics
from raft_tpu.obs import requestlog as jrequestlog
from raft_tpu.serve import errors as jerrors
from raft_tpu_torch.core import RaftError, Resources, logger, tracing
from raft_tpu_torch.neighbors import brute_force, ivf_pq
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import dispatch, events, mem, metrics, requestlog
from raft_tpu_torch.ops import _build
from raft_tpu_torch.serve import errors

REPO = Path(__file__).resolve().parents[1]
CPU = Resources(device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# -- metrics -------------------------------------------------------------------

def _drive_metrics(m):
    reg = m.Registry()
    c = reg.counter("raft_tpu_x_total", "a counter")
    c.inc(2, stream="a.k5")
    c.inc(1, stream="a.k5")
    c.inc(7, k="5", op="b")
    reg.gauge("raft_tpu_x_depth", "a gauge").set(3, stream="a")
    h = reg.histogram("raft_tpu_x_seconds", "latency", unit="seconds")
    for v in (0.0002, 0.003, 0.003, 0.2, 99.0):
        h.observe(v, stream="a")
    r = reg.histogram("raft_tpu_x_ratio", buckets=m.RATIO_BUCKETS)
    r.observe(0.97)
    errs = []
    for bad in (lambda: reg.gauge("raft_tpu_x_total"),
                lambda: reg.histogram("raft_tpu_x_ratio")):
        try:
            bad()
        except ValueError as e:
            errs.append(type(e).__name__)
    return (reg.to_prometheus(), reg.to_json(), reg.snapshot(),
            [h.quantile(q, stream="a") for q in (0.1, 0.5, 0.99)], errs)


def test_metrics_exposition_matches_jax():
    assert _drive_metrics(metrics) == _drive_metrics(jmetrics)
    a, b = {"x": 1.0, "y": 2.0}, {"x": 3.0, "y": 2.0, "z": 1.0}
    assert metrics.delta(a, b) == jmetrics.delta(a, b) == {"x": 2.0, "z": 1.0}


def test_every_port_metric_is_in_the_jax_catalogue():
    """The port registers metrics only under names the JAX package's
    catalogue (docs/observability.md) lists, so the two compare one to one."""
    reg = re.compile(r'\b(?:counter|gauge|histogram)\(\s*"(raft_tpu_[a-z0-9_]+)"')
    doc = set(re.findall(r"^\|\s*`(raft_tpu_[a-z0-9_]+)`\s*\|",
                         (REPO / "docs" / "observability.md").read_text(), re.M))
    names = set()
    for path in (REPO / "raft_tpu_torch").rglob("*.py"):
        names.update(reg.findall(path.read_text()))
    assert len(names) >= 20, sorted(names)
    assert names <= doc, sorted(names - doc)


# -- events ----------------------------------------------------------------------

def _drive_journal(ev_mod, path):
    clock = FakeClock()
    j = ev_mod.EventJournal(capacity=4, clock=clock)
    seen = []
    j.subscribe(seen.append)
    j.subscribe(lambda e: 1 / 0)          # a raising tap never breaks emit
    j.attach_sink(str(path), rotate_bytes=10_000)
    out = []
    for n in range(6):
        clock.t += 0.5
        out.append(j.emit("serve_published", subject=("serve", "main", None, n),
                          evidence={"swap": n > 0, "ks": [5]}, request_id=f"r{n}"))
    out.append(j.emit("budget_refusal", subject={"component": "mem", "name": "publish"},
                      evidence={"need_bytes": 4}))
    errs = []
    for bad in (lambda: j.emit("no_such_kind"), lambda: j.emit("serve_retired", "loud")):
        try:
            bad()
        except ValueError as e:
            errs.append(str(e).split(":")[0].split(" (")[0])
    trans = [j.transition("k", "a", {"p": 1}), j.transition("k", "a"),
             j.transition("k", "b", {"p": 2}), j.transition_payload("k")]
    page = j.query(since_seq=3, limit=2)
    j.detach_sink()
    return (out, seen, j.tail(10), j.query(kind="serve_published", name="main"), page,
            j.counts_by_kind(), j.last_seq(), trans, errs, ev_mod.load_jsonl(str(path)))


@pytest.mark.events
def test_journal_matches_jax(tmp_path):
    got = _drive_journal(events, tmp_path / "t.jsonl")
    want = _drive_journal(jevents, tmp_path / "j.jsonl")
    assert got == want
    assert len(got[2]) == 4 and got[6] == 7          # ring of 4, seq kept counting
    assert events.KINDS == jevents.KINDS


@pytest.mark.events
def test_journal_torn_tail_and_disabled_emit(tmp_path):
    path = tmp_path / "ev.jsonl"
    j = events.EventJournal(clock=FakeClock())
    j.attach_sink(str(path))
    j.emit("serve_retired", subject=("serve", "x", None, 1))
    j.detach_sink()
    with open(path, "ab") as f:
        f.write(b'{"torn": ')
    assert [e["kind"] for e in events.load_jsonl(str(path))] == ["serve_retired"]
    metrics.disable()
    try:
        assert j.emit("serve_retired") is None
    finally:
        metrics.enable()
    assert j.last_seq() == 1


@pytest.mark.events
def test_concurrent_emitters_strictly_increasing_seq():
    j = events.EventJournal(capacity=10_000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            j.emit("serve_published") for _ in range(300)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    seqs = [e["seq"] for e in j.tail(10_000)]
    assert seqs == list(range(1, 2401))


# -- request log -----------------------------------------------------------------

def _drive_requestlog(rl_mod):
    clock = FakeClock()
    log = rl_mod.RequestLog(capacity=3, in_flight_capacity=2, clock=clock)
    rids = [log.begin("s.k5", 1) for _ in range(3)]
    rids.append(log.begin("s.k5", 2, rid="wire-1"))
    with rl_mod.collect() as col:
        rl_mod.add_span("serve/lease", 0.001)
        with rl_mod.prefix("shard0/"):
            rl_mod.add_span("search", 0.002)
            rl_mod.annotate("version", 3)
        rl_mod.add_span("serve/lease", 0.001)
    with rl_mod.collect(resume=col):
        rl_mod.add_span("serve/search", 0.004)
    for n, rid in enumerate(rids):
        clock.t += 1.0
        log.complete(rid, stream="s.k5", rows=1, bucket=1,
                     spans={"queue": 0.001 * n, "flush": 0.01 * (n + 1), **col.spans},
                     notes=col.notes, outcome="ok" if n != 2 else "error")
    log.attach_span("wire-1", "wire", 0.5)
    log.complete(None, stream="s.k5", rows=1, spans={})
    return log.to_json(), log.get("wire-1"), log.get(rids[0])


def test_request_log_matches_jax():
    assert _drive_requestlog(requestlog) == _drive_requestlog(jrequestlog)


def test_dispatch_counter_nests_and_rolls_up():
    dispatch.note(5)                     # no counter open: a no-op
    with dispatch.count() as outer:
        dispatch.note()
        with dispatch.count() as inner:
            dispatch.note(2)
        assert inner.total == 2
        dispatch.note()
    assert outer.total == 4


# -- memory ledger -----------------------------------------------------------------

class Owner:
    pass


def _drive_ledger(mem_mod, errors_mod):
    clock = FakeClock()
    led = mem_mod.MemLedger(clock=clock)
    owners = [Owner() for _ in range(3)]
    t0 = led.account("index/ivf_pq", name="main", device=[np.zeros(1000, np.float32)],
                     owner=owners[0])
    t1 = led.account("serve/version", name="main", epoch=1, owner=owners[1])
    t2 = led.account("serve/staging", name="main.k10", host=np.zeros(64, np.int8),
                     device_bytes=256)
    led.account("index/ivf_pq", name="renamed", device_bytes=10, owner=owners[0])
    led.reaccount(t2, host_bytes=32, device_bytes=512, epoch=2)
    clock.t += 2.0
    led.retire(t1)
    clock.t += 3.0
    leak = led.audit()
    owners[1] = None                                   # the retired owner dies
    after = led.audit(collect=True)
    led.release(t0)                                    # already replaced: a no-op
    led.reset_peak()
    rows = led.breakdown()
    return led.totals(), rows, leak, after, led.has_owner(owners[0]), t0 != t2


@pytest.mark.mem
def test_ledger_totals_breakdown_and_audit_match_jax():
    got, want = _drive_ledger(mem, errors), _drive_ledger(jmem, jerrors)
    assert got == want
    totals, _, leak, after, _, _ = got
    assert len(leak["retired_unfreed"]) == 1 and after["clean"]
    assert totals == {"device_bytes": 522, "host_bytes": 32, "device_peak_bytes": 522,
                      "host_peak_bytes": 32, "allocations": 2}


@pytest.mark.mem
def test_gate_refusal_matches_jax():
    class Res:
        memory_budget_bytes = 0

    outs = []
    for mod in (mem, jmem):
        try:
            mod.gate(Res(), lambda: 1 << 40, site="publish", detail="x")
        except Exception as e:   # the refusal's type and fields are compared
            outs.append((type(e).__name__, type(e).__mro__[1].__name__, e.site,
                         e.budget_bytes, e.need_bytes))
    assert outs[0] == outs[1]
    assert outs[0][:2] == ("MemoryBudgetError", "OverloadedError")
    assert issubclass(errors.MemoryBudgetError, RaftError)
    metrics.disable()
    try:
        with pytest.raises(RaftError, match="observability is disabled"):
            mem.gate(Res(), 1, site="publish")
    finally:
        metrics.enable()
    mem.gate(CPU, 1 << 60, site="publish")           # no budget armed: admitted


@pytest.mark.mem
def test_index_accounting_counts_tensor_bytes(tmp_path):
    x = np.random.default_rng(0).standard_normal((500, 16)).astype(np.float32)
    bf = brute_force.BruteForce().build(x, res=CPU)
    assert mem.unaccounted_index_bytes(bf) == x.nbytes
    tok = mem.account_index(bf, name="bf")
    assert mem.unaccounted_index_bytes(bf) == 0
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=8, pq_dim=8, pq_bits=4, seed=0), x,
                      res=CPU)
    want = sum(t.nbytes for t in (pq.centers, pq.centers_rot, pq.rotation, pq.codebooks,
                                  pq.list_codes, pq.list_ids, pq.list_sizes,
                                  pq.list_consts, pq.list_scales, pq.list_sig,
                                  pq.sig_scales))
    assert mem.unaccounted_index_bytes(pq) == want
    assert mem.unaccounted_index_bytes(object()) == 0
    rows = [r for r in mem.breakdown() if r["name"] == "bf"]
    assert rows[0]["component"] == "index/brute_force"
    assert rows[0]["device_bytes"] == x.nbytes
    mem.release(tok)


@pytest.mark.mem
def test_mem_surfaces_on_the_cpu_and_not_ported():
    assert mem.hbm_stats() == {}
    assert set(mem.debug_payload()) == set(jmem.debug_payload()) >= {
        "totals", "by_component", "top", "audit", "hbm"}
    assert mem.headroom(CPU) is None
    room = mem.headroom(Resources(device="cpu", memory_budget_bytes=1 << 40))
    assert set(room) == {"budget_bytes", "device_bytes", "headroom_bytes",
                         "headroom_frac", "spillable_bytes", "spillable_frac"}
    mem.note_workspace("pairwise", 1024)
    assert metrics.to_json()['raft_tpu_mem_workspace_bytes{op="pairwise"}'] == 1024
    for fn in (lambda: mem.plan("ivf_pq", None, 1000, 16),
               lambda: mem.gate_host(CPU, 1, site="x")):
        with pytest.raises(RaftError, match="not yet ported"):
            fn()


# -- kernel builds and launch counters --------------------------------------------

def test_concurrent_load_builds_once(monkeypatch, tmp_path):
    """Eight threads asking for one kernel together start nvcc once and load
    one library; attribution sees one build, and a later load none."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_reports", {})
    monkeypatch.setattr(_build, "_lib_path", lambda name: tmp_path / f"{name}.so")
    starts, loads = [], []
    gate = threading.Barrier(8)

    class Proc:
        returncode = 0

        def communicate(self):
            return "ptxas info: Used 32 registers", None

    def fake_start(name):
        starts.append(name)
        tmp = tmp_path / f"{name}.tmp"
        tmp.write_bytes(b"")
        return Proc(), tmp, tmp_path / f"{name}.so"

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    got = []

    def worker():
        gate.wait(10)
        got.append(_build.load("topk"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs_compile.attribution() as rec:
            threads = [threading.Thread(target=worker) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert starts == ["topk"] and len(loads) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert (rec.programs, rec.cache_misses, rec.cache_hits, rec.built) == (1, 1, 0, ["topk"])
    with obs_compile.attribution() as again:
        _build.load("topk")
    assert again.summary() == {"compile_s": 0.0, "trace_s": 0.0, "programs": 0,
                               "cache_hits": 0, "cache_misses": 0}
    monkeypatch.setattr(_build, "_start", lambda name: None)   # a cached .so
    with obs_compile.attribution() as cached:
        _build.build_all(("pq_scan",))
    assert (cached.programs, cached.cache_hits) == (0, 1)


def test_launch_counters_lose_nothing_under_threads():
    def fn():
        pass

    fn.launches = 0
    fn.launches_by_mode = {"f32": 0, "bf16": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda m=m: [
            _build.count_launch(fn, m) for _ in range(5_000)])
            for m in ("f32", "bf16") * 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 40_000
    assert fn.launches_by_mode == {"f32": 20_000, "bf16": 20_000}


def test_wrappers_count_through_count_launch():
    """Every kernel wrapper counts its launches with ``count_launch``."""
    ops = REPO / "raft_tpu_torch" / "ops"
    for name in ("fused_knn", "topk", "pq_scan", "cagra_hop"):
        src = (ops / f"{name}.py").read_text()
        assert ".launches += 1" not in src, name
        assert "count_launch(" in src, name


# -- tracing and logging ------------------------------------------------------------

def test_tracing_ranges_off_by_default_and_on_when_enabled():
    assert not tracing._enabled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.range("serve/flush/%d", 8):
            torch.ones(4).sum()
        tracing.enable()
        try:
            with tracing.range("serve/flush/%d", 16):
                torch.ones(4).sum()
            tracing.annotate("my_fn")(lambda: torch.ones(2))()
        finally:
            tracing.disable()
    names = {e.key for e in prof.key_averages()}
    assert "serve/flush/16" in names and "my_fn" in names
    assert "serve/flush/8" not in names


def test_logger_basic_config():
    buf = io.StringIO()
    log = logger.basic_config(logger.INFO, stream=buf)
    try:
        log.info("hello %d", 3)
        logger.trace("hidden")
    finally:
        log.removeHandler(logger._handler)
        logger._handler = None
        log.propagate = True
    assert log.name == "raft_tpu_torch"
    assert "[INFO]" in buf.getvalue() and "hello 3" in buf.getvalue()
    assert "hidden" not in buf.getvalue()


def test_obs_package_does_not_import_http():
    tree = ast.parse((REPO / "raft_tpu_torch" / "obs" / "__init__.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                for a in n.names}
    assert "http" not in imported and "mem" in imported
