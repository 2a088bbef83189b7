"""The port's clustering, prefilter and flat index against the JAX
reference, on the same numpy inputs.

Tolerances: centroids within rtol 1e-5 (the port sums each cluster with a
one-hot product, the reference with a segment sum: same terms, other
order); PCA bases within 1e-5 up to each row's sign (two eigensolvers);
index vectors and search scores within rtol 1e-5 / atol 1e-6; counts,
ids, rows, validity and window pointers exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclus, index as jindex, prefilter as jpre
from repro_torch.core import clustering as tclus, index as tindex, prefilter as tpre

RNG = np.random.default_rng(0)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("mode", ["batched", "sequential", "frozen"])
def test_cluster_updates_match(mode):
    k, d, B = 16, 32, 64
    jc = jclus.ClusterConfig(num_clusters=k, dim=d, update_mode=mode)
    tc = tclus.ClusterConfig(num_clusters=k, dim=d, update_mode=mode)
    c0 = RNG.normal(size=(k, d)).astype(np.float32)
    n0 = RNG.integers(0, 5, size=k).astype(np.float32)
    js = jclus.ClusterState(jnp.asarray(c0), jnp.asarray(n0))
    ts = tclus.ClusterState(torch.from_numpy(c0.copy()), torch.from_numpy(n0.copy()))
    for _ in range(3):
        x = RNG.normal(size=(B, d)).astype(np.float32)
        labels = RNG.integers(0, k, size=B).astype(np.int32)
        labels[:10] = 2                          # a crowded cluster
        mask = RNG.random(B) < 0.75
        js = jclus.update(jc, js, jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(mask))
        ts = tclus.update(tc, ts, torch.from_numpy(x),
                          torch.from_numpy(labels), torch.from_numpy(mask))
        np.testing.assert_allclose(_np(ts.centroids), _np(js.centroids),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(_np(ts.counts), _np(js.counts))


def test_kmeans_plus_plus_seeds_data_rows_and_survives_duplicates():
    """D² seeding returns k unit rows of the data; with fewer distinct rows
    than k every distance reaches 0 and the draw must not raise."""
    gen = torch.Generator().manual_seed(0)
    data = torch.from_numpy(RNG.normal(size=(5, 8)).astype(np.float32))
    data = data.repeat(4, 1)                     # 5 distinct rows, 20 total
    c = tclus.kmeans_plus_plus(gen, data, 12)
    assert c.shape == (12, 8)
    unit = data / data.norm(dim=1, keepdim=True)
    dist = torch.cdist(c, unit).min(dim=1).values
    assert float(dist.max()) < 1e-5
    # distinct rows are preferred while any distance is left
    first5 = torch.cdist(c[:5], unit[:5]).argmin(dim=1)
    assert len(set(first5.tolist())) == 5


def test_prefilter_warmup_basis_matches_up_to_sign():
    d, n = 48, 5
    # five topic directions of distinct weight: well-separated eigenvalues
    topics = RNG.normal(size=(n, d)) * np.array([8.0, 6.0, 4.5, 3.0, 2.0])[:, None]
    warm = (RNG.normal(size=(200, d)) * 0.3
            + topics[np.arange(200) % n]).astype(np.float32)
    for basis in ("fixed", "adaptive"):
        jcfg = jpre.PrefilterConfig(num_vectors=n, dim=d, basis=basis, window=64)
        tcfg = tpre.PrefilterConfig(num_vectors=n, dim=d, basis=basis, window=64)
        js = jpre.init(jcfg, jax.random.key(0), jnp.asarray(warm))
        ts = tpre.init(tcfg, torch.Generator().manual_seed(0),
                       torch.from_numpy(warm), "cpu")
        _assert_rows_up_to_sign(_np(ts.basis), _np(js.basis))


def _assert_rows_up_to_sign(got, ref):
    sign = np.sign(np.sum(got * ref, axis=1))[:, None]
    np.testing.assert_allclose(got * sign, ref, atol=1e-5)


def test_prefilter_adaptive_ingest_matches():
    """Window ring writes (masked rows skipped), pointers and PCA refreshes
    every T arrivals; the basis is compared up to each row's sign."""
    d, n, W, T = 32, 3, 40, 50
    jcfg = jpre.PrefilterConfig(num_vectors=n, dim=d, basis="adaptive",
                                window=W, update_interval=T)
    tcfg = tpre.PrefilterConfig(num_vectors=n, dim=d, basis="adaptive",
                                window=W, update_interval=T)
    # topic-structured rows so the leading directions are well separated
    topics = RNG.normal(size=(n, d)) * np.array([6.0, 4.0, 2.5])[:, None]
    js = jpre.init(jcfg, jax.random.key(0))
    ts = tpre.init(tcfg, torch.Generator().manual_seed(0), None, "cpu")
    ts = ts._replace(basis=torch.from_numpy(np.array(js.basis)))
    refreshed = 0
    for step in range(6):
        x = (RNG.normal(size=(24, d)) * 0.3
             + topics[RNG.integers(0, n, size=24)]).astype(np.float32)
        mask = np.ones(24, bool)
        mask[-5:] = step % 2 == 0                # ragged tails
        js = jpre.ingest(jcfg, js, jnp.asarray(x), jnp.asarray(mask))
        ts = tpre.ingest(tcfg, ts, torch.from_numpy(x), mask)
        np.testing.assert_array_equal(_np(ts.window_buf), _np(js.window_buf))
        assert (ts.write_ptr, ts.fill, ts.since_update) == (
            int(js.write_ptr), int(js.fill), int(js.since_update))
        refreshed += ts.since_update == 0
        _assert_rows_up_to_sign(_np(ts.basis), _np(js.basis))
    assert refreshed >= 2


def test_gram_schmidt_matches():
    v = RNG.normal(size=(5, 24)).astype(np.float32)
    np.testing.assert_allclose(_np(tpre._gram_schmidt(torch.from_numpy(v))),
                               _np(jpre._gram_schmidt(jnp.asarray(v))),
                               rtol=1e-5, atol=1e-6)


def test_random_basis_is_orthonormal():
    cfg = tpre.PrefilterConfig(num_vectors=5, dim=24, basis="random")
    b = _np(tpre.init(cfg, torch.Generator().manual_seed(1), None, "cpu").basis)
    np.testing.assert_allclose(b @ b.T, np.eye(5), atol=1e-5)


def test_flat_index_upsert_and_search_match():
    cap, d, Q, k = 24, 32, 9, 5
    jcfg, tcfg = jindex.IndexConfig(cap, d), tindex.IndexConfig(cap, d)
    ji, ti = jindex.init(jcfg), tindex.init(tcfg, "cpu")
    for step in range(3):
        rows = RNG.permutation(cap)[:16].astype(np.int32)
        vecs = RNG.normal(size=(16, d)).astype(np.float32)
        ids = (RNG.integers(0, 1000, size=16) + step * 1000).astype(np.int32)
        valid = RNG.random(16) < 0.7
        ji = jindex.upsert(jcfg, ji, jnp.asarray(rows), jnp.asarray(vecs),
                           jnp.asarray(ids), jnp.asarray(valid))
        ti = tindex.upsert(tcfg, ti, torch.from_numpy(rows),
                           torch.from_numpy(vecs), torch.from_numpy(ids),
                           torch.from_numpy(valid))
    np.testing.assert_allclose(_np(ti.vectors), _np(ji.vectors), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(ti.ids), _np(ji.ids))
    np.testing.assert_array_equal(_np(ti.valid), _np(ji.valid))
    assert ti.version == int(ji.version) == 3
    q = RNG.normal(size=(Q, d)).astype(np.float32)
    js_, jr, jid = jindex.search(jcfg, ji, jnp.asarray(q), k)
    ts_, tr, tid = tindex.search(tcfg, ti, torch.from_numpy(q), k)
    np.testing.assert_allclose(_np(ts_), _np(js_), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(tr), _np(jr))
    np.testing.assert_array_equal(_np(tid), _np(jid))
    assert np.all(_np(ti.valid)[_np(tr)[_np(ts_) > -1e29]])
    assert int(tindex.size(ti)) == int(jindex.size(ji))
    assert tindex.memory_bytes(tcfg) == jindex.memory_bytes(jcfg)
