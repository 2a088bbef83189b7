"""The port's dense layers (``repro_torch/models/layers.py``) against the
JAX reference on the same numpy inputs: rotary embeddings (rotation by
halves, angles in fp32), ``layer_norm``, ``gqa_attention`` (causal, sliding
window, cache-slot validity) and ``init_embedding``'s shapes.

Tolerance: rtol 1e-5 / atol 1e-6 (the packages sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta,shape", [(10_000.0, (2, 16, 4, 32)),
                                         (1_000_000.0, (1, 9, 2, 128))])
def test_rope_matches_reference(theta, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    pos = np.tile(rng.integers(0, 5000, shape[1]), (shape[0], 1)).astype(np.int32)
    np.testing.assert_allclose(L.rope_frequencies(shape[-1], theta).numpy(),
                               np.asarray(JL.rope_frequencies(shape[-1], theta)), **TOL)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # rotation by halves: position 0 is the identity, norms are kept
    zero = L.apply_rope(torch.from_numpy(x), torch.zeros(shape[:2], dtype=torch.int32), theta)
    np.testing.assert_array_equal(zero.numpy(), x)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


def test_rope_keeps_bf16():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 4, 2, 8)).astype(np.float32)).to(torch.bfloat16)
    out = L.apply_rope(x, torch.arange(4)[None], 10_000.0)
    assert out.dtype == torch.bfloat16


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    got = L.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,with_valid,KV", [
    (True, None, False, 2),
    (True, 4, False, 2),
    (True, None, True, 1),
    (False, None, True, 4),
    (True, 3, True, 2),
])
def test_gqa_attention_matches_reference(causal, window, with_valid, KV):
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, D = 2, 6, 12, 4, 16
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    qp = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    valid = rng.random((B, Sk)) < 0.7 if with_valid else None
    if valid is not None:
        valid[:, -1] = True     # every query sees at least its own key
    kw = dict(causal=causal, window=window)
    want = JL.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp),
                            k_valid=None if valid is None else jnp.asarray(valid), **kw)
    got = L.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          q_positions=torch.from_numpy(qp), k_positions=torch.from_numpy(kp),
                          k_valid=None if valid is None else torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_init_embedding_shapes_and_scale(tied):
    gen = torch.Generator()
    gen.manual_seed(0)
    p, axes = L.init_embedding(gen, 300, 40, torch.float32, tied=tied)
    jp, jaxes = JL.init_embedding(jax.random.key(0), 300, 40, jnp.float32, tied=tied)
    assert axes == jaxes
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert abs(float(p["embedding"].std()) - 0.02) < 0.002
