"""The port's flash attention (``repro_torch/models/flash_attention.py``)
against the reference's on the same numpy inputs: the reference's own grid
of GQA group sizes, windows and ragged key blocks, forward within 1e-5 and
dq / dk / dv against ``jax.grad`` of the reference's flash within rtol
1e-4 / atol 5e-4; bf16 within 5e-2; a sliding window whose first key
blocks are fully masked for the later query rows (NEG, not -inf, keeps
them finite); and the transformer's flash path against its exact path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash_attention import flash_sdpa as j_flash_sdpa
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.flash_attention import flash_sdpa
from repro_torch.models.transformer import LMConfig, TransformerLM

GRID = [
    (32, 32, 4, 2, None, 16),
    (48, 48, 4, 4, 8, 16),     # SWA + non-divisible block boundary
    (64, 64, 4, 1, None, 64),  # MQA, single block
    (16, 16, 2, 2, 4, 5),      # ragged blocks
    (64, 64, 4, 2, 8, 16),     # SWA: rows past 24 see no key of block 0
]


def _inputs(B, Sq, Skv, H, KV, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(dtype)
    k = rng.normal(size=(B, Skv, KV, D)).astype(dtype)
    v = rng.normal(size=(B, Skv, KV, D)).astype(dtype)
    qp = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    return q, k, v, qp, kp


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad and a.dtype.kind == "f")
            for a in arrays]


@pytest.mark.parametrize("Sq,Skv,H,KV,window,block_k", GRID)
def test_flash_forward_and_grads_match_reference(Sq, Skv, H, KV, window, block_k):
    q, k, v, qp, kp = _inputs(2, Sq, Skv, H, KV, 16, seed=Sq + block_k)
    kw = dict(n_heads=H, window=window, block_k=block_k)
    tq, tk, tv = _t(q, k, v, grad=True)
    tqp, tkp = _t(qp, kp)
    out = flash_sdpa(tq, tk, tv, tqp, tkp, **kw)
    want = j_flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
                        jnp.asarray(kp), **kw)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # and the exact attention of the same inputs
    exact = L.gqa_attention(tq, tk, tv, q_positions=tqp, k_positions=tkp, window=window)
    np.testing.assert_allclose(out.detach().numpy(), exact.detach().numpy(),
                               rtol=1e-5, atol=1e-5)

    grads = torch.autograd.grad(torch.sum(out ** 2), (tq, tk, tv))
    j_grads = jax.grad(lambda a, b, c: jnp.sum(j_flash_sdpa(
        a, b, c, jnp.asarray(qp), jnp.asarray(kp), **kw) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, jg in zip(grads, j_grads):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=5e-4)


def test_flash_bf16_stays_close_to_reference():
    q, k, v, qp, _ = _inputs(2, 64, 64, 4, 4, 32, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = j_flash_sdpa(jq, jk, jv, jnp.asarray(qp), jnp.asarray(qp), n_heads=4, block_k=16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_sdpa(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(qp), n_heads=4,
                     block_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=5e-2, atol=5e-2)


def test_transformer_flash_path_matches_exact_path():
    """The port's loss and its gradients with use_flash on and off, on
    the reference's params (its test of the same name, on the port)."""
    from repro.models.transformer import LMConfig as JLMConfig, TransformerLM as JLM

    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=256, window=16, remat=False, attn_chunk=16)
    jp = JLM(JLMConfig(use_flash=False, **kw)).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 64)).astype(np.int32))
    cfg = LMConfig(use_flash=False, **kw)
    l0, _, g0 = TransformerLM(cfg).loss_and_grads(params, {"tokens": toks})
    l1, _, g1 = TransformerLM(dataclasses.replace(cfg, use_flash=True, flash_block_k=16)
                              ).loss_and_grads(params, {"tokens": toks})
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    flat0 = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), g0))
    flat1 = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), g1))
    for a, b in zip(flat0, flat1):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
