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
