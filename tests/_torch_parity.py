"""Shared helpers for the tests that hold the PyTorch port against the JAX
reference: the same numpy inputs go through both packages, and state
crosses between them as nested dicts of numpy arrays."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.models.transformer import LMConfig as JLMConfig, TransformerLM as JLM
from repro_torch.convert import params_to_numpy
from repro_torch.models.transformer import LMConfig, TransformerLM

# the dense transformer family's tolerance (tests/test_torch_transformer.py)
TOL = dict(rtol=1e-5, atol=1e-5)


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


def recsys_draws(name: str, rng: np.ndarray, B: int, S: int, n_items: int,
                 n_neg: int = 512) -> dict:
    """The draws the reference's recsys losses make from a batch's ``rng``
    key data, as the numpy entries a port batch carries: MIND's sampled
    negatives ``randint(key, (n_neg,), 0, n_items)`` (``recsys.py:61``);
    BERT4Rec's ``split(key)`` -> (mask uniforms [B, S], negatives)
    (``recsys.py:310-312``); none for DIEN and FM."""
    key = jax.random.wrap_key_data(jax.numpy.asarray(rng, jax.numpy.uint32))
    if name.startswith("mind"):
        return {"negatives": np.asarray(jax.random.randint(key, (n_neg,), 0, n_items))}
    if name.startswith("bert4rec"):
        k1, k2 = jax.random.split(key)
        return {"mask_u": np.asarray(jax.random.uniform(k1, (B, S))),
                "negatives": np.asarray(jax.random.randint(k2, (n_neg,), 0, n_items))}
    return {}


def opt_tree(state) -> dict:
    """A reference ``OptState`` as ``{step, mu, nu}`` of numpy (``None``
    kept, Adafactor's (row, col) tuples kept as tuples)."""
    def conv(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(conv(v) for v in t)
        return np.asarray(t)

    return {"step": np.asarray(state.step), "mu": conv(state.mu), "nu": conv(state.nu)}


# ------------------------------------------------------------ transformer
def tiny_lm_pair(**kw):
    """The reference's and the port's LM at ``tests/test_models.py``'s
    ``tiny_dense`` shapes, with ``kw`` on top."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=512, remat=False, attn_chunk=16)
    base.update(kw)
    return JLM(JLMConfig(**base)), TransformerLM(LMConfig(**base))


def redraw_uniform_leaves(tree, rng):
    """The reference's params as numpy, each all-ones / all-zeros leaf
    (norm scales, QKV biases) redrawn around its value."""
    def leaf(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, tree)


def np_tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def np_positions(B, S):
    return np.tile(np.arange(S, dtype=np.int32), (B, 1))


def close_to_largest(got, want):
    """Within 1e-5: rtol 1e-5 and atol 1e-5 of the largest |want| (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def hold_grads(got, want):
    """The port's gradient tree against the reference's, leaf for leaf:
    rtol 1e-4, atol 1e-4 of the leaf's largest |gradient|."""
    for g, w in zip(jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))


def hold_cache(got, want):
    """A prefill / decode cache leaf for leaf: positions and lengths exact,
    k / v within ``close_to_largest``."""
    assert sorted(got) == sorted(want)
    for name in ("pos", "len"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        close_to_largest(got[name].numpy(), want[name])
