"""Sample filters on raft_tpu_torch.neighbors.ivf_pq search against raft_tpu's.

A JAX-built index loads into the port from its file and answers the same
filtered searches: the JAX package masks each chunk's scores with
``apply_id_filter`` before the chunk select and reports id -1 wherever a
merged distance is ±inf (raft_tpu/neighbors/ivf_pq.py:1788-1814). The port
runs the same mask on each of its routes: inside ``pq_scan_topk`` as a
packed bitset (its plain version on CPU tensors), after the ``pq_scan``
kernel on the unfused route, and on the plain formulations. Answers are
compared as tests/test_torch_ivf_pq.py compares them (id sets per row,
sorted distances at rtol 1e-5 / atol 1e-4), and underfilled rows by the
shared ``check_filter_underfill`` contract. The indexes are the codec
tests' JAX builds (``jax_built``, one build a process): pq4 under L2 over
int8 rows, split pq8 under L2 over uint8 rows, pq4 under inner product.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.matrix.select_k import _select_k as j_select_k
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors.sample_filter import apply_id_filter as j_apply_id_filter
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.sample_filter import BitsetFilter
from raft_tpu_torch.ops.pq_scan import (keep_bits, pack_keep_words, pq_scan_plain,
                                        pq_scan_topk_plain)
from test_torch_ivf_pq_codec import N, N_PROBES, jax_built

CPU = Resources(device="cpu")
# name -> the codec tests' configuration it searches
CONFIGS = {"pq4": "int8", "pq8split": "uint8_auto", "pq4ip": "aniso_1bit_ip"}
# the port's routes: (scan_impl, select_impl); on CPU tensors "kernel" with
# "pallas" is pq_scan_topk's plain version, "kernel" with "xla" the unfused
# pq_scan route
ROUTES = [("auto", "pallas"), ("kernel", "xla"), ("onehot", "auto"), ("select", "auto")]


@pytest.fixture(scope="module")
def data():
    """keep share -> a keep-mask over the N ids."""
    return {frac: np.random.default_rng(7).random(N) < frac for frac in (0.5, 0.02)}


@pytest.fixture(scope="module")
def indexes():
    """name -> (queries, JAX index, the port's load of its file)."""
    out = {}
    for name, config in CONFIGS.items():
        _, q, jindex, _, tindex = jax_built(config)
        out[name] = (q, jindex, tindex)
    return out


def _assert_same_answers(td, ti, jd, ji):
    td, ti, jd, ji = (np.asarray(a) for a in (td, ti, jd, ji))
    assert td.dtype == np.float32 and ti.dtype == np.int32
    for r in range(ti.shape[0]):
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("route", ROUTES, ids=["-".join(r) for r in ROUTES])
@pytest.mark.parametrize("frac", [0.5, 0.02])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_filtered_search_matches_jax(data, indexes, name, frac, route):
    masks = data
    q, jindex, tindex = indexes[name]
    keep = masks[frac]
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES), jindex, jnp.asarray(q), 10,
                        sample_filter=jnp.asarray(keep))
    scan, select = route
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, scan_impl=scan,
                                         select_impl=select),
                        tindex, q, 10, sample_filter=keep, res=CPU)
    _assert_same_answers(td, ti, jd, ji)
    ti = ti.numpy()
    assert keep[ti[ti >= 0]].all()                     # every returned id is kept
    assert ((ti < 0) == np.isinf(td.numpy())).all()    # -1 exactly where ±inf
    if frac == 0.02:
        assert (ti < 0).any()                          # some rows underfill


def test_jax_pallas_filtered_search_matches(data, indexes, monkeypatch):
    """The JAX side on its Pallas scan (interpret mode) under a filter."""
    monkeypatch.setenv("RAFT_TPU_PQ_SCAN_INTERPRET", "1")
    masks = data
    q, jindex, tindex = indexes["pq4"]
    q = q[:16]                  # each interpret-mode shape costs seconds to trace
    keep = masks[0.5]
    jd, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, scan_impl="pallas"), jindex,
                        jnp.asarray(q), 10, sample_filter=jnp.asarray(keep))
    td, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, scan_impl="kernel",
                                         select_impl="pallas"),
                        tindex, q, 10, sample_filter=BitsetFilter(keep), res=CPU)
    _assert_same_answers(td, ti, jd, ji)


@pytest.mark.parametrize("name", ["pq4", "pq4ip"])
def test_underfill_contract(data, indexes, check_filter_underfill, name):
    """Fewer kept rows than k: the kept ones first, then -1 at ±inf, on the
    fused and the plain routes, as in the JAX search."""
    q, jindex, tindex = indexes[name]
    alive = [5, 77, 1234]
    keep = np.zeros(N, bool)
    keep[alive] = True
    inner = name == "pq4ip"
    params = tpq.SearchParams(n_probes=tindex.n_lists)
    jd, ji = jpq.search(jpq.SearchParams(n_probes=jindex.n_lists), jindex, jnp.asarray(q), 10,
                        sample_filter=jnp.asarray(keep))
    check_filter_underfill(jd, ji, alive, select_min=not inner)
    for select in ("pallas", "xla"):
        td, ti = tpq.search(dataclasses.replace(params, select_impl=select), tindex, q, 10,
                            sample_filter=keep, res=CPU)
        check_filter_underfill(td.numpy(), ti.numpy(), alive, select_min=not inner)


@pytest.mark.parametrize("split,inner", [(False, False), (True, False), (False, True)])
def test_pq_scan_topk_plain_keep_words_matches_jax_composition(split, inner):
    """pq_scan_topk_plain with keep_words equals the JAX package's chunk
    step on the same scores: apply_id_filter, then the select over the
    chunk's flat slots (ids of filtered slots kept, ±inf values), with an
    underfilled query and a list of holes."""
    rng = np.random.default_rng(3)
    n_lists, cap, s, t, pc, k = 12, 40, 8, 6, 3, 16
    kk = 32 if split else 16
    codes = rng.integers(0, 256 if split else 16, (n_lists, cap, s), dtype=np.uint8)
    ids = rng.permutation(n_lists * cap).astype(np.int32).reshape(n_lists, cap)
    ids[2, 30:] = -1                                      # a short list
    probes = np.stack([rng.choice(n_lists, pc, replace=False)
                       for _ in range(t)]).astype(np.int32)
    probes[0] = [2, 2, 2]
    lut = rng.normal(size=(t, pc, s, kk)).astype(np.float32)
    bias = rng.normal(size=(t, pc)).astype(np.float32)
    keep = rng.random(n_lists * cap) < 0.3
    keep[ids[2, :30]] = False                             # query 0 keeps nothing
    keep[ids[2, :2]] = True                               # ... but two slots
    tc, ti, tp, tl, tb = (torch.from_numpy(a) for a in (codes, ids, probes, lut, bias))
    words = pack_keep_words(torch.from_numpy(keep))
    assert torch.equal(keep_bits(words, torch.from_numpy(ids)), torch.from_numpy(keep[
        np.maximum(ids, 0)] & (ids >= 0)))
    v, i = pq_scan_topk_plain(tc, ti, tp, tl, tb, k, not inner, split=split, keep_words=words)
    scores = pq_scan_plain(tc, tp.reshape(-1), tl.reshape(t * pc, s, kk), split)
    scores = scores.numpy().reshape(t, pc, cap) + bias[:, :, None]
    sid = ids[probes]
    scores = np.where(sid >= 0, scores, -np.inf if inner else np.inf).astype(np.float32)
    js = j_apply_id_filter(jnp.asarray(scores), jnp.asarray(sid), jnp.asarray(keep), not inner)
    jv, ji = j_select_k(js.reshape(t, pc * cap), jnp.asarray(sid.reshape(t, pc * cap)), k,
                        not inner)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # query 0 probes list 2 three times: its two kept slots, three times each
    assert np.isfinite(v.numpy()[0, :2 * pc]).all() and np.isinf(v.numpy()[0, 2 * pc:]).all()


def test_keep_words_shorter_than_the_ids_keep_none_past_them():
    """A bitset that ends before the largest stored id: the ids past its
    last word read as not kept (the kernel reads no word past it)."""
    ids = torch.tensor([[-1, 0, 31, 32, 63, 64, 1000]], dtype=torch.int32)
    words = pack_keep_words(torch.ones(64, dtype=torch.bool))       # two words: ids < 64
    assert keep_bits(words, ids).tolist() == [[False, True, True, True, True, False, False]]
    codes = torch.zeros((1, 7, 16), dtype=torch.uint8)
    lut = torch.zeros((1, 1, 16, 16))
    v, i = pq_scan_topk_plain(codes, ids, torch.zeros((1, 1), dtype=torch.int32), lut,
                              torch.zeros((1, 1)), 7, True, keep_words=words)
    assert i[0, :4].tolist() == [0, 31, 32, 63] and bool(torch.isinf(v[0, 4:]).all())
    with pytest.raises(RaftError):
        pq_scan_topk_plain(codes, ids, torch.zeros((1, 1), dtype=torch.int32), lut,
                           torch.zeros((1, 1)), 7, True,
                           keep_words=torch.zeros(0, dtype=torch.int32))


def test_all_ones_filter_gives_the_unfiltered_answer(data, indexes):
    q, _, tindex = indexes["pq8split"]
    for select in ("pallas", "xla"):
        params = tpq.SearchParams(n_probes=N_PROBES, select_impl=select)
        d0, i0 = tpq.search(params, tindex, q, 10, res=CPU)
        d1, i1 = tpq.search(params, tindex, q, 10, sample_filter=np.ones(N, bool), res=CPU)
        assert torch.equal(d0, d1) and torch.equal(i0, i1)


def test_filter_must_cover_every_stored_id(data, indexes):
    q, _, tindex = indexes["pq4"]
    with pytest.raises(RaftError, match="cover"):
        tpq.search(tpq.SearchParams(n_probes=N_PROBES), tindex, q, 10,
                   sample_filter=np.ones(N - 1, bool), res=CPU)
