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
    catalogue (docs/observability.md) lists, so the two compare one to one,
    or under names the port's list of its own metrics holds
    (raft_tpu_torch/OBSERVABILITY.md, "Metrics of its own")."""
    reg = re.compile(r'\b(?:counter|gauge|histogram)\(\s*"(raft_tpu_[a-z0-9_]+)"')
    doc = set(re.findall(r"^\|\s*`(raft_tpu_[a-z0-9_]+)`\s*\|",
                         (REPO / "docs" / "observability.md").read_text(), re.M))
    text = (REPO / "raft_tpu_torch" / "OBSERVABILITY.md").read_text()
    own = text.split("## Metrics of its own")[1].split("\n## ")[0]
    doc |= set(re.findall(r"^- `(raft_tpu_[a-z0-9_]+)` \(", own, re.M))
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
def test_mem_surfaces_on_the_cpu_and_not_ported(monkeypatch):
    # each payload gains a "tiers" section once a tiered store of its package
    # has registered one in this process (the tiered tests, in the same
    # worker): compare the two with no extra section registered, then with
    # each package's own
    monkeypatch.setattr(jmem, "_debug_sections", {})
    monkeypatch.setattr(mem, "_debug_sections", {})
    assert mem.hbm_stats() == {}
    assert set(mem.debug_payload()) == set(jmem.debug_payload()) >= {
        "totals", "by_component", "top", "audit", "hbm"}
    assert mem.headroom(CPU) is None
    room = mem.headroom(Resources(device="cpu", memory_budget_bytes=1 << 40))
    assert set(room) == {"budget_bytes", "device_bytes", "headroom_bytes",
                         "headroom_frac", "spillable_bytes", "spillable_frac"}
    mem.note_workspace("pairwise", 1024)
    assert metrics.to_json()['raft_tpu_mem_workspace_bytes{op="pairwise"}'] == 1024
    # plan() gives the JAX plan's numbers (plan(tier=) too: a duck-typed
    # policy with a disk_path moves the rows to the disk tier); gate_host
    # admits unarmed and refuses as the JAX gate does armed
    class Disk:
        disk_path = "/nonexistent/cold"

    for kw in (dict(), dict(streamed=True, chunk_rows=256), dict(storage="tiered"),
               dict(storage="tiered", tier=object()), dict(storage="tiered", tier=Disk())):
        assert mem.plan("ivf_pq", None, 1000, 16, **kw) == jmem.plan("ivf_pq", None, 1000, 16,
                                                                     **kw)
    mem.gate_host(CPU, 1, site="x")
    used = mem.totals()["host_bytes"]
    with pytest.raises(errors.MemoryBudgetError) as exc:
        mem.gate_host(Resources(device="cpu", host_budget_bytes=used), 1, site="x")
    assert (exc.value.site, exc.value.need_bytes) == ("x/host", 1)
    assert mem.plan("ivf_pq", None, 1000, 16, storage="tiered", tier=Disk())["tiers"][
        "disk"] == 1000 * 16 * 4
    mem.register_debug_section("probe", lambda: {"ok": 1})
    assert mem.debug_payload()["probe"] == {"ok": 1}


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


def test_launch_tally_counts_only_its_own_thread():
    """``launch_tally`` counts the launches of the thread that opened it,
    inner blocks nest in outer ones, and the wrappers' totals keep every
    thread's launches."""
    def fn():
        pass

    fn.launches = 0
    fn.launches_by_mode = {"f32": 0}
    fn.launches_by_route = {"rows": 0}
    with _build.launch_tally() as outer:
        _build.count_launch(fn, "f32")
        _build.count_launch(fn, "f32", "rows")
        with _build.launch_tally() as inner:
            _build.count_launch(fn)
            other = threading.Thread(target=lambda: [_build.count_launch(fn)
                                                     for _ in range(7)])
            other.start()
            other.join(60)
            assert not other.is_alive()
        _build.count_launch(fn)
    _build.count_launch(fn)
    assert inner == {("fn", None, None): 1}
    assert outer == {("fn", "f32", None): 1, ("fn", "f32", "rows"): 1, ("fn", None, None): 2}
    assert fn.launches == 12 and fn.launches_by_mode == {"f32": 2}
    assert fn.launches_by_route == {"rows": 1}


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
    tracing.clear()
    with tracing.range("serve/flush/%d", 4):
        torch.ones(4).sum()
    assert tracing.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # an open profiler session records without enable()
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
    assert {"serve/flush/16", "my_fn"} <= names and "serve/flush/4" not in names
    # a session alone annotates where every session records CPU activity
    assert ("serve/flush/8" in names) == (not torch.cuda.is_available())
    tracing.enable()
    try:
        with tracing.range("serve/publish/%s", "a"):
            pass
    finally:
        tracing.disable()
    assert [s.name for s in tracing.spans()] == ["serve/flush/8", "serve/flush/16", "my_fn",
                                                 "serve/publish/a"]
    tracing.clear()


def test_tracing_off_site_is_the_shared_no_op_and_records_nothing():
    tracing.clear()
    assert tracing.range("a") is tracing.range("b.%d", 3) is tracing._OFF
    with tracing.range("cagra.search") as span:
        span.set("hops", 3)
    assert tracing.spans() == [] and tracing.dropped() == 0

    def sites(n):
        r = tracing.range
        for _ in range(n):
            with r("cagra.hop") as span:
                span.set("hops", 1)

    sites(100)
    before = sys.getallocatedblocks()
    sites(20_000)
    assert sys.getallocatedblocks() - before < 2_000   # a block a site would be 20,000


def test_tracing_records_under_enable_and_inside_a_profiler_session():
    tracing.clear()
    with tracing.range("off.before"):
        pass
    tracing.enable()
    try:
        with tracing.range("on.enable"):
            pass
    finally:
        tracing.disable()
    with tracing.range("off.between"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.range("on.profiler"):
            pass
    with tracing.range("off.after"):
        pass
    assert [s.name for s in tracing.spans()] == ["on.enable", "on.profiler"]
    tracing.clear()


def test_tracing_spans_nest_with_parent_and_call_ids_on_each_thread():
    tracing.clear()
    go = threading.Barrier(2)

    def work(tag):
        with tracing.range(f"{tag}.outer") as outer:
            outer.set("tag", tag)
            go.wait()
            with tracing.range(f"{tag}.mid"):
                with tracing.range(f"{tag}.inner"):
                    pass
            with tracing.range(f"{tag}.second"):
                pass
        with tracing.range(f"{tag}.next"):
            pass

    tracing.enable()
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        tracing.disable()
    by = {s.name: s for s in tracing.spans()}
    assert len(by) == 10
    for tag in ("a", "b"):
        outer, mid, inner, second, nxt = (by[f"{tag}.{n}"] for n in
                                          ("outer", "mid", "inner", "second", "next"))
        assert outer.parent == 0 and outer.call == outer.id and outer.attrs == {"tag": tag}
        assert mid.parent == outer.id and second.parent == outer.id and inner.parent == mid.id
        assert {mid.call, inner.call, second.call} == {outer.id}
        assert nxt.parent == 0 and nxt.call == nxt.id != outer.id
        assert len({outer.thread, mid.thread, inner.thread, nxt.thread}) == 1
        assert outer.start_ns <= mid.start_ns <= inner.start_ns <= inner.end_ns <= mid.end_ns
        assert mid.end_ns <= second.start_ns <= second.end_ns <= outer.end_ns <= nxt.start_ns
    assert by["a.outer"].thread != by["b.outer"].thread
    assert by["a.outer"].call != by["b.outer"].call
    tracing.clear()


@pytest.mark.parametrize("threads", [1, 16])
def test_tracing_buffer_drops_and_counts_past_its_bound(monkeypatch, threads):
    """The bound and the dropped count are exact, also with threads closing
    spans at once (more threads than cores, switching often)."""
    tracing.clear()
    per = 8 if threads == 1 else 2_000
    monkeypatch.setattr(tracing, "MAX_SPANS", 5 if threads == 1 else 10_000)

    def work(t):
        for i in range(per):
            with tracing.range("s%d", i):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        tracing.disable()
        sys.setswitchinterval(interval)
    kept = tracing.MAX_SPANS
    assert len(tracing.spans()) == kept and tracing.dropped() == threads * per - kept
    if threads == 1:
        assert [s.name for s in tracing.spans()] == ["s0", "s1", "s2", "s3", "s4"]
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_tracing_spans_share_the_profiler_clock():
    """A span and a ``record_function`` event around the same region, under
    a CPU profiler, agree to within 100 µs at both ends in the median
    region: spans are stamped on the clock the profiler's events carry (the
    first region, which pays the session's first annotation, is left out)."""
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(6):
            with torch.profiler.record_function("clock.outer"):
                with tracing.range("clock.span"):
                    torch.ones(64).sum()
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name() == "clock.outer")
    spans = sorted((s.start_ns, s.end_ns) for s in tracing.spans() if s.name == "clock.span")
    assert len(events) == len(spans) == 6
    starts = sorted(abs(s0 - e0) for (e0, _), (s0, _) in zip(events[1:], spans[1:]))
    ends = sorted(abs(s1 - e1) for (_, e1), (_, s1) in zip(events[1:], spans[1:]))
    # the median region: one preempted region cannot fail the clock
    assert starts[2] < 100_000 and ends[2] < 100_000, (starts, ends)
    tracing.clear()


def test_ivf_pq_search_records_coarse_and_a_scan_span_a_tile():
    x = np.random.default_rng(0).standard_normal((2_000, 16)).astype(np.float32)
    q = np.random.default_rng(1).standard_normal((300, 16)).astype(np.float32)
    pq = ivf_pq.build(ivf_pq.IndexParams(n_lists=16, pq_dim=8, pq_bits=4, seed=0), x,
                      res=CPU)
    tracing.clear()
    tracing.enable()
    try:
        ivf_pq.search(ivf_pq.SearchParams(n_probes=4), pq, q, 10)
    finally:
        tracing.disable()
    spans = tracing.spans()
    (top,) = [s for s in spans if s.name == "ivf_pq.search"]
    coarse = [s for s in spans if s.name == "ivf_pq.search.coarse"]
    scans = [s for s in spans if s.name == "ivf_pq.search.scan"]
    assert top.parent == 0 and top.attrs["queries"] == 300
    assert len(coarse) == 1 and len(scans) == top.attrs["tiles"] >= 3
    assert {s.parent for s in coarse + scans} == {top.id}
    assert {s.call for s in spans} == {top.id}
    assert coarse[0].end_ns <= min(s.start_ns for s in scans)
    tracing.clear()


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
    """The obs package imports the submodules and names the JAX package's
    obs/__init__.py imports, the exporter (``http``, ported with the network
    front door) among them, and pulls in no ``raft_tpu_torch.net`` module but
    ``net._httpd``, the stdlib server the exporter rides."""
    def imported(pkg):
        tree = ast.parse((REPO / pkg / "obs" / "__init__.py").read_text())
        return {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                for a in n.names}

    assert imported("raft_tpu_torch") == imported("raft_tpu")
    assert {"http", "mem", "start_http_exporter"} <= imported("raft_tpu_torch")
    http_tree = ast.parse((REPO / "raft_tpu_torch" / "obs" / "http.py").read_text())
    from_net = {n.module for n in ast.walk(http_tree)
                if isinstance(n, ast.ImportFrom) and n.module and "net" in n.module}
    assert from_net == {"net._httpd"}
