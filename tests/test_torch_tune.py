"""raft_tpu_torch.tune (apply, sweep, reference) and ``publish(tuned=)``
against the JAX package's (tier-1 ``tune`` marker).

The parity seam is the index file, as in the other port files: the JAX
package builds the reference families of ``TUNE_r08.json`` on its own data
(``raft_tpu.tune.reference.build_family``), saves them, and the port loads
them. Then, on the same inputs:

- ``tuned_search_params`` gives the same SearchParams and the same error
  texts for every kind and knob;
- ``search_fn`` / ``make_searcher`` / a tuned ``batched_searcher`` answer
  with the JAX package's ids (each row's id set, or distances that tie
  where the sets differ) and distances at rtol 1e-5 plus an absolute
  2^-20 x max |x|^2 (the expanded form's float32 rounding at the families'
  norms, ~2,100: 2e-3);
- ``sweep``'s recall of every trial equals the JAX sweep's within one
  neighbour in m·k (1 / 5,120 at the families' 512 queries x k=10), and
  the artifact's within its own drift pin's 0.03 (the artifact predates
  later JAX changes, so the JAX sweep itself moves up to 0.0025 from it);
- the choice rule on fixed trial tables (``_measure`` patched in both
  packages at run time) picks the same point with the same evidence.

Port differences pinned here: ``sweep_select_k``'s arms are ``"torch"`` /
``"kernel"`` with ``backend`` the device type and the port's 1,024-column
default kept where the kernel is ineligible (``kernel_measured``), and
``apply_global`` ignores a ``select_k`` pin whose kernel arm was not
measured on the port's kernel (the artifact's CPU entry among them).
Everything runs on the CPU, torch on one thread.
"""

import dataclasses
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import serve as jserve
from raft_tpu import tune as jtune
from raft_tpu.core.errors import RaftError as JRaftError
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.tune import reference as jref
from raft_tpu_torch import tune
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.matrix.select_k import (WIDE_SELECT_COLS_DEFAULT,
                                            set_wide_cols_threshold, wide_cols_threshold)
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import metrics
from raft_tpu_torch.serve import IndexRegistry
from raft_tpu_torch.tune import reference

pytestmark = pytest.mark.tune

CPU = Resources(device="cpu")
ARTIFACT = pathlib.Path(__file__).resolve().parents[1] / "TUNE_r08.json"
ARTIFACT_TOL = 0.03                       # tests/test_tune.py's drift pin
# the modules (``tune.sweep`` / ``tune.apply`` the names are their functions)
jsweep = importlib.import_module("raft_tpu.tune.sweep")
tsweep = importlib.import_module("raft_tpu_torch.tune.sweep")
japply = importlib.import_module("raft_tpu.tune.apply")
tapply = importlib.import_module("raft_tpu_torch.tune.apply")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_wide_cols_threshold(None)


def _one_call(fn, queries, repeats):
    """``_measure`` without timing: one call, a fixed QPS (the trial
    recalls, not the host's clock, are what two packages can share)."""
    return 1.0, fn(queries)


@pytest.fixture(scope="module")
def fams(tmp_path_factory):
    """family -> (JAX index, port index, dataset, queries, k), the JAX
    package's ``build_family`` on its own data, loaded into the port."""
    d = tmp_path_factory.mktemp("tune")
    out = {}
    for name, jmod, tmod in (("ivf_flat_bal", jfl, tfl), ("ivf_pq_bal", jpq, tpq)):
        fam = jref.build_family(name)
        path = str(d / f"{name}.bin")
        jmod.save(fam["index"], path)
        out[name] = (fam["index"], tmod.load(path, res=CPU), np.asarray(fam["dataset"]),
                     np.asarray(fam["queries"]), fam["k"])
    return out


def _same_answers(td, ti, jd, ji, x):
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    assert ti.shape == ji.shape
    atol = 2.0 ** -20 * float((np.asarray(x, np.float64) ** 2).sum(1).max())
    sd, sj = np.sort(td, 1), np.sort(jd, 1)
    np.testing.assert_allclose(sd, sj, rtol=1e-5, atol=atol)
    for r in range(ti.shape[0]):
        if set(ti[r].tolist()) != set(ji[r].tolist()):
            # a swap at the k-th place: only between distances that tie
            assert abs(sd[r, -1] - sj[r, -1]) <= atol + 1e-5 * abs(sj[r, -1]), r


# -- tuned_search_params ----------------------------------------------------------------

@pytest.mark.parametrize("kind,params", [
    ("ivf_pq", {"n_probes": 4, "refine_ratio": 8, "lut_dtype": "bfloat16"}),
    ("ivf_pq", {"n_probes": 16, "scan_order": "grouped", "group_size": 8,
                "select_impl": "auto", "funnel_widen": 2}),
    ("ivf_flat", {"n_probes": 12, "refine_ratio": 2}),
    ("cagra", {"itopk_size": 64, "max_iterations": 9, "search_width": 2, "seed_pool": 0,
               "hop_impl": "xla"}),
    ("brute_force", {}),
])
def test_tuned_search_params_match_jax(kind, params):
    sp, rr = tune.tuned_search_params(kind, dict(params))
    jsp, jrr = jtune.tuned_search_params(kind, dict(params))
    assert rr == jrr
    if kind == "brute_force":
        assert sp is None and jsp is None
        return
    for field in (f.name for f in dataclasses.fields(jsp)):
        if field in params:
            assert getattr(sp, field) == getattr(jsp, field), field
    assert set(params) - {"refine_ratio"} <= {f.name for f in dataclasses.fields(sp)}


@pytest.mark.parametrize("kind,params", [
    ("ivf_flat", {"itopk_size": 32}),
    ("cagra", {"refine_ratio": 4}),
    ("ivf_pq", {"refine_ratio": 0}),
    ("brute_force", {"n_probes": 1}),
    ("annoy", {}),
])
def test_tuned_search_params_errors_match_jax(kind, params):
    with pytest.raises(RaftError) as te:
        tune.tuned_search_params(kind, dict(params))
    with pytest.raises(JRaftError) as je:
        jtune.tuned_search_params(kind, dict(params))
    assert str(te.value) == str(je.value)


# -- search_fn, make_searcher, a tuned batched_searcher ----------------------------------

@pytest.mark.parametrize("name,params", [
    ("ivf_flat_bal", {"n_probes": 4}),
    ("ivf_flat_bal", {"n_probes": 2, "refine_ratio": 4}),
    ("ivf_pq_bal", {"n_probes": 8}),
    ("ivf_pq_bal", {"n_probes": 8, "refine_ratio": 4}),
])
def test_search_fn_answers_as_jax(fams, name, params):
    jidx, tidx, x, q, k = fams[name]
    got = tapply.search_fn(tidx, dict(params), dataset=x)(q[:64], k)
    want = japply.search_fn(jidx, dict(params), dataset=jnp.asarray(x))(jnp.asarray(q[:64]), k)
    assert all(t.device.type == "cpu" for t in got)
    _same_answers(*got, *want, x)


def test_make_searcher_matches_jax(fams, caplog):
    jidx, tidx, x, q, k = fams["ivf_pq_bal"]
    dec = {"kind": "ivf_pq", "dtype": "float32", "family": "10k-d64-bal",
           "params": {"n_probes": 8, "refine_ratio": 4}}
    with pytest.raises(RaftError, match="raw rows") as te:
        tune.make_searcher(tidx, dec)
    with pytest.raises(JRaftError) as je:
        jtune.make_searcher(jidx, dec)
    assert str(te.value) == str(je.value)
    hook = tune.make_searcher(tidx, dec, dataset=x)
    jhook = jtune.make_searcher(jidx, dec, dataset=jnp.asarray(x))
    for attr in ("kind", "dim", "query_dtype", "tuned"):
        assert getattr(hook, attr) == getattr(jhook, attr), attr
    assert hook.device.type == "cpu"
    _same_answers(*hook(q[:32], k), *jhook(jnp.asarray(q[:32]), k), x)
    # the loaded-index contract: a refine pin without rows serves the
    # refine-free remainder, with a warning
    with caplog.at_level("WARNING"):
        degraded = tune.make_searcher(tidx, dec, degrade_without_rows=True)
    assert degraded.kind == "ivf_pq" and degraded.tuned == hook.tuned
    assert any("refine-free remainder" in r.getMessage() for r in caplog.records)
    jdegraded = jtune.make_searcher(jidx, dec, degrade_without_rows=True)
    _same_answers(*degraded(q[:32], k), *jdegraded(jnp.asarray(q[:32]), k), x)


@pytest.mark.parametrize("name", ["ivf_flat_bal", "ivf_pq_bal"])
def test_jax_saved_pin_serves_through_the_ports_batched_searcher(fams, name, tmp_path):
    """A raft_tpu/9 ``tuned`` record saved by the JAX package is served by
    the port's ``batched_searcher`` with no params (refine pins without
    their rows in both: the remainder)."""
    jidx, _, x, q, k = fams[name]
    jmod, tmod = (jfl, tfl) if name.startswith("ivf_flat") else (jpq, tpq)
    kind = name.rsplit("_", 1)[0]
    params = {"n_probes": 4, "refine_ratio": 2}
    dec = jtune.Decision(kind=kind, dtype="float32", family=jtune.family_of(jidx, x),
                         params=params)
    path = str(tmp_path / "pinned.bin")
    jtune.attach(jidx, dec)
    try:
        jmod.save(jidx, path)
        jhook = jmod.batched_searcher(jidx)
    finally:
        jidx.tuned = None
    loaded = tmod.load(path, res=CPU)
    assert loaded.tuned == dec.to_dict()
    hook = tmod.batched_searcher(loaded)
    assert (hook.kind, hook.tuned) == (jhook.kind, jhook.tuned) == (kind, dec.key)
    _same_answers(*hook(q[:32], k), *jhook(jnp.asarray(q[:32]), k), x)
    # explicit params still win over the pin
    assert not hasattr(tmod.batched_searcher(loaded, tmod.SearchParams(n_probes=8)), "tuned")


def test_attach_and_resolve_match_jax(fams):
    jidx, tidx, x, _, _ = fams["ivf_flat_bal"]
    bad = [tune.Decision(kind="cagra", dtype="float32", family="10k-d64-bal", params={}),
           tune.Decision(kind="ivf_flat", dtype="float32", family="10k-d64-bal",
                         params={"nope": 1}),
           "not a decision"]
    for b in bad:
        with pytest.raises(RaftError) as te:
            tune.attach(tidx, b)
        jb = jtune.Decision(**dataclasses.asdict(b)) if isinstance(b, tune.Decision) else b
        with pytest.raises(JRaftError) as je:
            jtune.attach(jidx, jb)
        assert str(te.value) == str(je.value)
    assert tidx.tuned is None
    dec = tune.Decision(kind="ivf_flat", dtype="float32", family="10k-d64-bal",
                        params={"n_probes": 4})
    log, jlog = tune.DecisionLog(), jtune.DecisionLog()
    log.add(dec)
    jlog.add(jtune.Decision(**dataclasses.asdict(dec)))
    assert tune.resolve(tidx, log, x).key == jtune.resolve(jidx, jlog, x).key == dec.key
    assert tune.resolve(tidx, dec.to_dict()).key == dec.key
    assert tune.resolve(tidx, None) is None and tune.resolve(tidx, True) is None
    assert tune.family_of(tidx, x) == jtune.family_of(jidx, x)


# -- sweep ------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ivf_flat_bal", "ivf_pq_bal"])
def test_sweep_of_the_artifact_families_matches_jax(fams, name, monkeypatch):
    """The port's sweep of the JAX-built family on the JAX package's data:
    every trial's recall within one neighbour in m·k of the JAX sweep's,
    and within the artifact's drift pin of ``TUNE_r08.json``'s."""
    monkeypatch.setattr(jsweep, "_measure", _one_call)
    monkeypatch.setattr(tsweep, "_measure", _one_call)
    jidx, tidx, x, q, k = fams[name]
    kind = name.rsplit("_", 1)[0]
    grid = tune.default_grid(kind)
    dec = tune.sweep(tidx, q, k=k, dataset=x, grid=grid, repeats=1)
    jdec = jtune.sweep(jidx, q, k=k, dataset=x, grid=grid, repeats=1)
    tol = 1.0 / (q.shape[0] * k)
    got = [t["recall"] for t in dec.evidence["trials"]]
    want = [t["recall"] for t in jdec.evidence["trials"]]
    assert np.allclose(got, want, rtol=0, atol=tol + 1e-9), (got, want)
    assert dec.family == jdec.family and dec.key == jdec.key
    assert set(dec.evidence) == set(jdec.evidence)
    assert dec.evidence["backend"] == "cpu" and dec.evidence["queries"] == q.shape[0]
    with open(ARTIFACT) as f:
        art = jtune.DecisionLog.from_json(json.load(f)).get(kind, "float32", dec.family)
    recorded = [t["recall"] for t in art.evidence["trials"]]
    assert np.allclose(got, recorded, rtol=0, atol=ARTIFACT_TOL), (got, recorded)


@pytest.mark.parametrize("table,target", [
    ([300.0, 500.0, 100.0, 50.0], "default"),    # a faster point that meets the head
    ([900.0, 500.0, 100.0, 50.0], "default"),    # the head is fastest
    ([100.0, 200.0, 300.0, 400.0], 2.0),         # nothing meets the target
    ([100.0, 200.0, 300.0, 400.0], 0.5),         # a float target
])
def test_choice_rule_matches_jax(fams, monkeypatch, table, target):
    """Fixed QPS tables over real trials (``_measure`` patched in both
    packages): the same chosen point, frontier, target and ratio."""
    jidx, tidx, x, q, k = fams["ivf_flat_bal"]

    def fixed(calls):
        def measure(fn, queries, repeats):
            calls.append(1)
            return table[len(calls) - 1], fn(queries)
        return measure

    monkeypatch.setattr(jsweep, "_measure", fixed([]))
    monkeypatch.setattr(tsweep, "_measure", fixed([]))
    grid = [{"n_probes": 1}, {"n_probes": 2}, {"n_probes": 4}, {"n_probes": 8}]
    dec = tune.sweep(tidx, q[:128], k=k, dataset=x, grid=grid, recall_target=target)
    jdec = jtune.sweep(jidx, q[:128], k=k, dataset=x, grid=grid, recall_target=target)
    assert dec.params == jdec.params
    for key in ("recall_target", "target_met", "frontier", "default_params",
                "default_qps", "chosen_qps", "chosen_qps_over_default"):
        assert dec.evidence[key] == jdec.evidence[key], key
    assert np.allclose(dec.evidence["chosen_recall"], jdec.evidence["chosen_recall"],
                       atol=1.0 / (128 * k) + 1e-9)


def test_failed_arm_is_evidence_and_frontier_matches_jax(fams, monkeypatch):
    monkeypatch.setattr(tsweep, "_measure", _one_call)
    _, tidx, x, q, k = fams["ivf_flat_bal"]
    dec = tune.sweep(tidx, q[:64], k=k, dataset=x,
                     grid=[{"bogus_knob": 1}, {"n_probes": 8}, {"n_probes": 2}])
    trials = dec.evidence["trials"]
    assert "error" in trials[0] and "bogus_knob" in trials[0]["error"]
    assert dec.evidence["default_params"] == {"n_probes": 8}
    tables = [
        [dict(params={"a": 1}, recall=0.9, qps=100.0), dict(params={"a": 2}, recall=0.95,
                                                            qps=50.0),
         dict(params={"a": 3}, error="x"), dict(params={"a": 4}, recall=0.8, qps=200.0)],
        [dict(params={}, recall=0.5, qps=10.0), dict(params={}, recall=0.5, qps=10.0)],
        [dict(params={}, error="y")],
    ]
    for table in tables:
        assert (tsweep._frontier([tsweep.Trial(t) for t in table])
                == jsweep._frontier([jsweep.Trial(t) for t in table]))
    with pytest.raises(RaftError, match="every sweep trial failed"):
        tune.sweep(tidx, q[:8], k=k, dataset=x, grid=[{"nope": 1}])
    with pytest.raises(RaftError, match="exact ground truth"):
        tune.sweep(tidx, q[:8], k=k)


def test_sweep_counts_trials_and_attaches(fams, monkeypatch):
    monkeypatch.setattr(tsweep, "_measure", _one_call)
    _, tidx, x, q, k = fams["ivf_flat_bal"]
    metrics.enable()
    before = metrics.to_json()
    log = tune.DecisionLog()
    try:
        dec = tune.sweep(tidx, q[:64], k=k, dataset=x, grid=tune.smoke_grid("ivf_flat"),
                         log=log, attach=True)
        assert tidx.tuned == dec.to_dict() and log.get(*dec.key.split("/")) == dec
        hook = tfl.batched_searcher(tidx)
        assert hook.tuned == dec.key
    finally:
        tidx.tuned = None
    d = metrics.delta(before, metrics.to_json())
    assert d['raft_tpu_tune_trials_total{family="10k-d64-bal",kind="ivf_flat"}'] == 3
    assert tune.smoke_grid("ivf_pq") == jtune.smoke_grid("ivf_pq")
    assert tune.funnel_grid() == jtune.funnel_grid()
    for kind in ("ivf_flat", "ivf_pq", "cagra", "brute_force"):
        assert tune.default_grid(kind) == jtune.default_grid(kind)


# -- sweep_select_k and apply_global ---------------------------------------------------

def test_sweep_select_k_records_ineligible_on_the_cpu():
    """The port's arms and backend, its 1,024 default kept, against the JAX
    sweep's arms and default on the same shapes."""
    metrics.enable()
    before = metrics.to_json()
    dec = tune.sweep_select_k(rows=8, cols=(2048, 4096), ks=(5, 300), repeats=1, res=CPU)
    jdec = jtune.sweep_select_k(rows=8, cols=(2048, 4096), ks=(5, 300), repeats=1)
    ev, jev = dec.evidence, jdec.evidence
    assert dec.params == {"wide_cols_min": WIDE_SELECT_COLS_DEFAULT} == {"wide_cols_min": 1024}
    assert jdec.params == {"wide_cols_min": 65536}
    assert ev["kernel_measured"] is False and jev["pallas_measured"] is False
    assert ev["backend"] == "cpu" and ev["previous_threshold"] == 1024
    assert [t["params"]["impl"] for t in ev["trials"]] == ["torch", "kernel"] * 4
    assert [t["params"]["impl"] for t in jev["trials"]] == ["xla", "pallas"] * 4
    assert [dict(t["params"], impl=None) for t in ev["trials"]] == \
        [dict(t["params"], impl=None) for t in jev["trials"]]
    errs = [t["error"] for t in ev["trials"] if "error" in t]
    assert errs[0] == "ineligible: backend=cpu, k=5 (cap 256)"
    assert all(t.get("recall") == 1.0 for t in ev["trials"] if t["params"]["impl"] == "torch")
    d = metrics.delta(before, metrics.to_json())
    assert d['raft_tpu_tune_trials_total{family="wide",kind="select_k"}'] == 8
    assert wide_cols_threshold() == 1024


def test_apply_global_applies_only_measured_pins():
    log = tune.DecisionLog()
    assert tune.apply_global(log) == {}
    # a hand-written pin applies, as in the JAX package
    log.add(tune.Decision(kind="select_k", dtype="float32", family="wide",
                          params={"wide_cols_min": 32768}))
    assert tune.apply_global(log) == {"select_k.wide_cols_min": 32768}
    assert wide_cols_threshold() == 32768
    set_wide_cols_threshold(None)
    # the artifact's entry (JAX, CPU: its Pallas arm ineligible) moves nothing
    with open(ARTIFACT) as f:
        art = tune.DecisionLog.from_json(json.load(f))
    assert art.get("select_k", "float32", "wide").params == {"wide_cols_min": 65536}
    assert tune.apply_global(art) == {} and wide_cols_threshold() == 1024
    # a port sweep whose kernel arm was ineligible moves nothing; a measured one applies
    cpu = tune.DecisionLog()
    tune.sweep_select_k(rows=4, cols=(512,), ks=(3,), repeats=1, res=CPU, log=cpu)
    assert tune.apply_global(cpu) == {} and wide_cols_threshold() == 1024
    measured = tune.DecisionLog()
    measured.add(tune.Decision(kind="select_k", dtype="float32", family="wide",
                               params={"wide_cols_min": 512},
                               evidence={"kernel_measured": True, "trials": []}))
    metrics.enable()
    before = metrics.to_json()
    assert tune.apply_global(measured) == {"select_k.wide_cols_min": 512}
    assert wide_cols_threshold() == 512
    d = metrics.delta(before, metrics.to_json())
    assert d['raft_tpu_tune_applied_total{kind="select_k"}'] == 1


# -- publish(tuned=) ---------------------------------------------------------------------

def test_publish_tuned_forms_and_refusals_match_jax(fams):
    """Each ``tuned=`` form publishes the pin, warmed at every bucket before
    the flip, the report naming it; the refusals are the JAX registry's."""
    _, tidx, x, q, k = fams["ivf_flat_bal"]
    dec = tune.Decision(kind="ivf_flat", dtype="float32", family=tune.family_of(tidx, x),
                        params={"n_probes": 4})
    log = tune.DecisionLog()
    log.add(dec)
    reg = IndexRegistry(buckets=(1, 2, 4))
    forms = {"log": log, "decision": dec, "dict": dec.to_dict()}
    for name, tuned in forms.items():
        report = reg.publish(name, tidx, tuned=tuned, k=(k, 5))
        assert report["tuned"] == dec.key, name
        assert sorted(report["warm"]) == [5, k] and all(
            sorted(report["warm"][kk]) == [1, 2, 4] for kk in report["warm"])
        with reg.lease(name) as v:
            got = v.searcher(q[:3], k)
        want = tfl.search(tfl.SearchParams(n_probes=4), tidx, q[:3], k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    tidx.tuned = dec.to_dict()
    try:
        assert reg.publish("attached", tidx, tuned=True, warm=False)["tuned"] == dec.key
    finally:
        tidx.tuned = None
    jreg = jserve.IndexRegistry(buckets=(1,))
    jbf_index = jbf.BruteForce().build(x[:200])
    tbf_index = tbf.BruteForce().build(x[:200], res=CPU)
    hook = tbf.batched_searcher(tbf_index)
    jhook = jbf.batched_searcher(jbf_index)
    for kw, jkw in ((dict(index=tbf_index, search_params=object()),
                     dict(index=jbf_index, search_params=object())),
                    (dict(index=hook), dict(index=jhook))):
        with pytest.raises(RaftError) as te:
            reg.publish("refused", kw.pop("index"), tuned=True, warm=False, **kw)
        with pytest.raises(JRaftError) as je:
            jreg.publish("refused", jkw.pop("index"), tuned=True, warm=False, **jkw)
        assert str(te.value) == str(je.value)
    assert "refused" not in reg.names()


# -- reference --------------------------------------------------------------------------

def test_reference_surface_matches_jax():
    assert reference.FAMILY_NAMES == jref.FAMILY_NAMES
    assert reference._SCALE == jref._SCALE
    assert reference.ROUND != jref.ROUND == "r08"
    assert reference.build_family("select_k") == jref.build_family("select_k")
    with pytest.raises(RaftError) as te:
        reference.build_family("nope")
    with pytest.raises(JRaftError) as je:
        jref.build_family("nope")
    assert str(te.value) == str(je.value)
    a = reference._clustered(300, 8, 20, 4, seed=5)
    b = reference._clustered(300, 8, 20, 4, seed=5)
    assert all(u.dtype == np.float32 and np.array_equal(u, v) for u, v in zip(a, b))
    xs, _ = reference._clustered(4000, 32, 16, 64, seed=5, heavytail=True)
    xb, _ = reference._clustered(4000, 32, 16, 64, seed=5)
    assert tune.decisions.local_scale_cv(xs) > tune.decisions.SCALE_CV_THRESHOLD
    assert tune.decisions.local_scale_cv(xb) < tune.decisions.SCALE_CV_THRESHOLD
    log = reference.cpu_mesh_decisions(names=("select_k",), repeats=1, res=CPU)
    assert log.meta["round"] == reference.ROUND and log.meta["backend"] == "cpu"
    (dec,) = log.entries()
    assert dec.kind == "select_k" and dec.evidence["kernel_measured"] is False
    assert set(tune.__all__) >= set(jtune.__all__)


def test_port_reference_family_sweeps_on_its_own_build():
    """The port's own build of ``ivf_flat_bal`` from its own generator:
    the head (8 probes) is feasible, so the chosen point meets it."""
    dec = reference.run_family("ivf_flat_bal", repeats=1, res=CPU)
    ev = dec.evidence
    assert dec.family == "10k-d64-bal" and ev["target_met"]
    assert ev["chosen_recall"] >= ev["recall_target"] >= 0.99
    assert dec.params in [t["params"] for t in ev["trials"]]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ivf_pq_skew", "cagra_bal"])
def test_artifact_heavy_families_within_the_drift_pin(name, tmp_path):
    """The slow half (as tests/test_tune.py's): the JAX-built family loaded
    into the port, the chosen and default points re-measured against the
    artifact within its drift pin. CAGRA's entry pool is the port's own
    draw, so its recall is held to the pin, not to JAX's sweep."""
    with open(ARTIFACT) as f:
        log = jtune.DecisionLog.from_json(json.load(f))
    fam = jref.build_family(name)
    jidx, x, q, k = fam["index"], np.asarray(fam["dataset"]), np.asarray(fam["queries"]), fam["k"]
    path = str(tmp_path / "fam.bin")
    mod = tcagra if name.startswith("cagra") else tpq
    (jpq if mod is tpq else importlib.import_module("raft_tpu.neighbors.cagra")).save(jidx, path)
    tidx = mod.load(path, res=CPU)
    entry = log.resolve(jidx, fam["dataset"])
    assert entry is not None
    gt = tsweep._ground_truth(x, q, k, res=CPU)
    recorded = {json.dumps(t["params"], sort_keys=True): t["recall"]
                for t in entry.evidence["trials"] if "error" not in t}
    for params in (entry.params, entry.evidence["default_params"]):
        _, ids = tapply.search_fn(tidx, dict(params), dataset=x)(q, k)
        got = tsweep._recall(ids, gt)
        want = recorded[json.dumps(params, sort_keys=True)]
        assert abs(got - want) <= ARTIFACT_TOL, (params, got, want)
