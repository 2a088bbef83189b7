"""Shared helpers for the tests that hold the PyTorch port against the JAX
reference: the same numpy inputs go through both packages, and state
crosses between them as nested dicts of numpy arrays."""
from __future__ import annotations

import jax
import numpy as np
import torch


def jax_tree(state) -> dict:
    """A reference NamedTuple state as nested dicts of numpy arrays (the
    typed PRNG key is left out)."""
    if hasattr(state, "_fields"):
        return {n: jax_tree(v) for n, v in zip(state._fields, state)
                if n != "rng"}
    return np.asarray(state)


def hh_draws(key, B: int, bmax: int) -> dict:
    """The per-arrival draws the reference's counter makes from ``key``:
    ``split(key, B)``, then ``split(., 3)`` -> (gate uniform, Gumbel
    [bmax], Morris uniform), as torch tensors."""
    def one(k):
        ka, kb, kc = jax.random.split(k, 3)
        return (jax.random.uniform(ka), jax.random.gumbel(kb, (bmax,)),
                jax.random.uniform(kc))

    u, g, m = jax.vmap(one)(jax.random.split(key, B))
    return {name: torch.from_numpy(np.array(a)) for name, a in
            (("uniforms", u), ("gumbel", g), ("morris", m))}


def ingest_draws(state, B: int, bmax: int) -> dict:
    """The counter draws the reference's ``ingest_impl`` makes for its next
    batch: ``split(state.rng)[1]`` is the counter key."""
    _, k_hh = jax.random.split(state.rng)
    return hh_draws(k_hh, B, bmax)


def assert_trees(ref: dict, got: dict, rtol=1e-5, atol=1e-6, path=""):
    """Integers and bools exact; floats within (rtol, atol): the two
    packages sum in different orders, so float leaves may differ in the
    last bits."""
    assert set(ref) == set(got), (path, set(ref) ^ set(got))
    for name in ref:
        a, b = ref[name], got[name]
        where = f"{path}{name}"
        if isinstance(a, dict):
            assert_trees(a, b, rtol, atol, where + ".")
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=where)


def reservoir_draws(key, n: int, k: int) -> dict:
    """The per-arrival draws the reference's reservoir makes for a batch of
    ``n`` from its state key: ``split(rng, 3)`` per arrival -> (join
    uniform, slot in [0, k))."""
    def step(rng, _):
        rng, ka, kb = jax.random.split(rng, 3)
        return rng, (jax.random.uniform(ka), jax.random.randint(kb, (), 0, k))

    _, (u, r) = jax.lax.scan(step, key, None, length=n)
    return {"uniforms": torch.from_numpy(np.array(u)),
            "slots": torch.from_numpy(np.array(r))}


def kmeanspp_picks(key, data, k: int) -> np.ndarray:
    """The rows the reference's ``clustering.kmeans_plus_plus(key, data,
    k)`` picks, as indices into ``data``: each returned centroid is a unit
    row of ``data``, matched to its nearest (rows equal after
    normalization are interchangeable)."""
    from repro.core.clustering import kmeans_plus_plus

    c = np.asarray(kmeans_plus_plus(key, jax.numpy.asarray(data), k), np.float64)
    x = np.asarray(data, np.float64)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    d2 = ((c[:, None, :] - xn[None, :, :]) ** 2).sum(-1)
    picks = np.argmin(d2, axis=1)
    assert np.all(d2[np.arange(k), picks] < 1e-10), "a centroid is no row"
    return picks


def ivfpq_train_draws(key, sample, nlist: int, m: int, nbits: int = 8) -> dict:
    """The draws the reference's ``ivfpq_train(cfg, key, sample)`` makes:
    the coarse k-means++ rows from ``split(key)[0]`` (over the unit
    sample) and each subspace's codeword rows from ``split(split(key)[1],
    m)``."""
    from repro.kernels.common import l2_normalize

    k1, k2 = jax.random.split(key)
    x = np.asarray(sample, np.float32)
    xs = np.asarray(l2_normalize(jax.numpy.asarray(x)))
    choices = np.stack([np.asarray(jax.random.choice(km, x.shape[0], (2 ** nbits,),
                                                     replace=True))
                        for km in jax.random.split(k2, m)])
    return {"picks": kmeanspp_picks(k1, xs, nlist), "choices": choices}
