"""raft_tpu_torch.cluster.kmeans against raft_tpu.cluster.kmeans on seeded
numpy blobs on the CPU.

From ``init="array"`` both run the same Lloyd loop: centroids within 1e-5
relative, labels and ``n_iter`` equal. The random inits draw from different
streams (a torch generator against JAX's keys), so k-means++ and "random"
are held by inertia: the port's at most 1.05x JAX's. ``find_k`` picks JAX's
k on well-separated blobs; ``predict``, ``transform``, ``cluster_cost`` and
``update_centroids`` agree within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.cluster import kmeans as jkm
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.cluster import KMeansParams
from raft_tpu_torch.cluster import kmeans as tkm

CPU = Resources(device="cpu")


def _blobs(n, k, d, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (k, d)).astype(np.float32)
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(0, 1.0, (n, d))).astype(np.float32), centers


@pytest.fixture(scope="module")
def blobs():
    return _blobs(1500, 12, 8, seed=3)


def _jparams(p):
    return jkm.KMeansParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})


def test_params_mirror_jax():
    assert ({f: getattr(KMeansParams(), f) for f in KMeansParams.__dataclass_fields__}
            == {f: getattr(jkm.KMeansParams(), f)
                for f in jkm.KMeansParams.__dataclass_fields__})


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_from_array_matches_jax(blobs, weighted):
    x, _ = blobs
    init = x[::125][:12] + 0.5                 # a start Lloyd needs a few steps from
    w = np.random.default_rng(1).uniform(0.1, 3.0, len(x)).astype(np.float32) if weighted else None
    p = KMeansParams(n_clusters=12, init="array", max_iter=50, tol=1e-4)
    jo = jkm.fit(_jparams(p), jnp.asarray(x), None if w is None else jnp.asarray(w),
                 centroids=jnp.asarray(init))
    to = tkm.fit(p, x, w, centroids=init, res=CPU)
    assert to.n_iter == jo.n_iter and to.n_iter > 1
    np.testing.assert_array_equal(to.labels.numpy(), np.asarray(jo.labels))
    np.testing.assert_allclose(to.centroids.numpy(), np.asarray(jo.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(to.inertia), float(jo.inertia), rtol=1e-5)


def test_max_iter_and_empty_cluster_rules(blobs):
    """max_iter stops the loop; a centroid far from every row keeps its place."""
    x, _ = blobs
    init = np.concatenate([x[:11], np.full((1, 8), 1e4, np.float32)])
    p = KMeansParams(n_clusters=12, init="array", max_iter=3)
    jo = jkm.fit(_jparams(p), jnp.asarray(x), centroids=jnp.asarray(init))
    to = tkm.fit(p, x, centroids=init, res=CPU)
    assert to.n_iter == jo.n_iter == 3
    np.testing.assert_array_equal(to.centroids[11].numpy(), init[11])
    np.testing.assert_allclose(to.centroids.numpy(), np.asarray(jo.centroids), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_random_inits_inertia_within_5pct(blobs, init):
    x, _ = blobs
    p = KMeansParams(n_clusters=12, init=init, n_init=3 if init == "random" else 1, seed=7)
    jo = jkm.fit(_jparams(p), jnp.asarray(x))
    to = tkm.fit(p, x, res=CPU)
    assert to.labels.dtype == torch.int32 and to.centroids.shape == (12, 8)
    assert float(to.inertia) <= 1.05 * float(jo.inertia), (float(to.inertia), float(jo.inertia))


def test_init_plus_plus_inertia(blobs):
    x, _ = blobs
    jc = np.asarray(jkm.init_plus_plus(jnp.asarray(x), 12, seed=2))
    tc = tkm.init_plus_plus(x, 12, seed=2, res=CPU)
    assert tc.shape == (12, 8) and tc.dtype == torch.float32
    # every seed is a data row
    assert all((x == row).all(1).any() for row in tc.numpy())
    jcost = float(jkm.cluster_cost(jnp.asarray(x), jnp.asarray(jc)))
    assert float(tkm.cluster_cost(x, tc, res=CPU)) <= 1.05 * jcost


def test_find_k_picks_jax_k():
    x, _ = _blobs(900, 5, 6, seed=11, spread=30.0)
    p = KMeansParams(init="kmeans++", seed=1)
    jk, jscores = jkm.find_k(jnp.asarray(x), [2, 3, 5, 8], _jparams(p))
    tk, tscores = tkm.find_k(x, [2, 3, 5, 8], p, res=CPU)
    assert tk == jk == 5 and set(tscores) == set(jscores)
    np.testing.assert_allclose(tscores[5], jscores[5], rtol=1e-3)


def test_predict_transform_cost_update_match_jax(blobs):
    x, centers = blobs
    c = centers + 0.3
    w = np.random.default_rng(2).uniform(0.5, 2.0, len(x)).astype(np.float32)
    jl, ji = jkm.predict(jnp.asarray(x), jnp.asarray(c), jnp.asarray(w))
    tl, ti = tkm.predict(x, c, w, res=CPU)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    np.testing.assert_allclose(tkm.transform(x, c, res=CPU).numpy(),
                               np.asarray(jkm.transform(jnp.asarray(x), jnp.asarray(c))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tkm.cluster_cost(x, c, res=CPU)),
                               float(jkm.cluster_cost(jnp.asarray(x), jnp.asarray(c))),
                               rtol=1e-5)
    for ww in (None, w):
        jc, jlab = jkm.update_centroids(jnp.asarray(x), jnp.asarray(c),
                                        None if ww is None else jnp.asarray(ww))
        tc, tlab = tkm.update_centroids(x, c, ww, res=CPU)
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_contract_errors(blobs):
    x, _ = blobs
    with pytest.raises(RaftError, match="n_clusters > n_samples"):
        tkm.fit(KMeansParams(n_clusters=2000), x, res=CPU)
    with pytest.raises(RaftError, match="requires centroids"):
        tkm.fit(KMeansParams(init="array"), x, res=CPU)
    with pytest.raises(RaftError, match="unknown init"):
        tkm.fit(KMeansParams(init="bogus"), x, res=CPU)
    labels, out = tkm.fit_predict(KMeansParams(n_clusters=4, seed=3), x, res=CPU)
    assert torch.equal(labels, out.labels)
