"""DeepSeek's mixture of experts, multi-head latent attention and depth-1
multi-token prediction in the port (``repro_torch/models/layers.py``,
``models/transformer.py``) against the JAX reference on the CPU: the same
seeded numpy inputs through both packages, the reference's params carried
across with ``convert.params_from_numpy`` (norm scales redrawn so that
they matter).

``moe_ffn`` (both routers, 0 or 2 shared experts, a nonzero router bias;
one group, several, a token count whose group count the ``while T % G``
loop lowers, capacity factor 1.0 so assignments drop): expert ids,
``tok_buf`` and the drop set equal to the reference's (the inputs hold no
router near-tie under 1e-6, asserted), y and aux within 1e-5 of the
largest |value|, the gradients of sum(y * g) + aux against ``jax.grad``
within rtol 1e-4. The reference's own MoE tests (``tests/test_models.py``)
run on the port. ``mla_attention`` (flash, q-chunked, one chunk) and
``mla_decode`` on a filled latent cache within 1e-5. ``TransformerLM``
with MoE + MLA + MTP (the reference's decode test config) and a GQA MoE
variant: hidden, logits, loss with ``mtp_ce`` and gradients, prefill's
cache leaves and three chained decodes against the reference, and the
reference's decode-vs-forward check on the port. The two deepseek
configs: fields, smoke cells and a two-microbatch train step against the
reference's. Then the repairs on this path: ``stack_layers`` into a
preallocated stack, experts drawn one at a time, and a bf16 tree with an
fp32 ``router_bias`` across ``convert`` and the train checkpoint bit for
bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from _torch_parity import (TOL, close_to_largest, hold_grads, np_positions, np_tokens,
                           opt_tree, redraw_uniform_leaves)
from repro.models import layers as JL
from repro.models.api import get_arch as j_get_arch
from repro.models.transformer import LMConfig as JLMConfig, TransformerLM as JLM
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy)
from repro_torch.models import layers as L
from repro_torch.models.api import get_arch
from repro_torch.models.transformer import LMConfig, TransformerLM, _init_block
from repro_torch.train.checkpoint import CheckpointManager

NEAR_TIE = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads(fn, params: dict, *inputs):
    """Gradients of the scalar ``fn(params, *inputs)`` by autograd: (the
    params' gradient tree, zeros for an unused leaf; each input's)."""
    live = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True), params)
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    leaves = jax.tree.leaves(live)
    got = torch.autograd.grad(fn(live, *xs), leaves + xs, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves + xs, got)]
    return jax.tree.unflatten(jax.tree.structure(live), got[:len(leaves)]), got[len(leaves):]


# ------------------------------------------------------------------ MoE
def moe_cfgs(**kw):
    base = dict(num_experts=8, num_shared=0, top_k=2, d_model=16, d_ff=12,
                tokens_per_group=64, capacity_factor=4.0)
    base.update(kw)
    return JL.MoEConfig(**base), L.MoEConfig(**base)


# (T, config fields, a nonzero router bias, expected group count G)
MOE_CASES = {
    "softmax-one-group": (32, dict(), False, 1),
    "softmax-shared2-groups": (64, dict(num_shared=2, tokens_per_group=16), False, 4),
    "softmax-lowered": (30, dict(tokens_per_group=4), False, 6),        # 7 -> 6
    "softmax-drops": (64, dict(capacity_factor=1.0, num_shared=2), False, 1),
    "sigmoid-one-group": (32, dict(router="sigmoid_norm", route_scale=2.5), False, 1),
    "sigmoid-bias-groups": (64, dict(router="sigmoid_norm", tokens_per_group=16), True, 4),
    "sigmoid-bias-shared2-lowered": (30, dict(router="sigmoid_norm", num_shared=2,
                                             tokens_per_group=4, route_scale=2.5), True, 6),
    "sigmoid-bias-drops": (64, dict(router="sigmoid_norm", capacity_factor=1.0, top_k=3),
                           True, 1),
}


def _moe_case(name, seed=0):
    T, kw, bias, G = MOE_CASES[name]
    jcfg, tcfg = moe_cfgs(**kw)
    rng = np.random.default_rng(seed)
    np_p = _np(JL.init_moe(jax.random.key(seed), jcfg, jnp.float32)[0])
    if bias:
        np_p["router_bias"] = (rng.normal(size=jcfg.num_experts) * 0.05).astype(np.float32)
    x = rng.normal(size=(T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, np_p, x, G


def _assert_no_near_tie(jp, x, jcfg):
    """No two of the top K + 1 selection scores of a token lie within
    NEAR_TIE (so which experts and in what order is decided alike)."""
    logits = np.asarray(x, np.float64) @ np.asarray(jp["router"], np.float64)
    if jcfg.router == "sigmoid_norm":
        sel = 1 / (1 + np.exp(-logits)) + np.asarray(jp["router_bias"], np.float64)
    else:
        sel = np.exp(logits - logits.max(1, keepdims=True))
        sel /= sel.sum(1, keepdims=True)
    top = -np.sort(-sel, axis=1)[:, :jcfg.top_k + 1]
    assert np.min(top[:, :-1] - top[:, 1:]) > NEAR_TIE


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_dispatch_outputs_and_grads_match_reference(case):
    jcfg, tcfg, np_p, x, G = _moe_case(case)
    jp, tp = jax.tree.map(jnp.asarray, np_p), params_from_numpy(np_p)
    _assert_no_near_tie(np_p, x, jcfg)
    T, E, K = x.shape[0], jcfg.num_experts, jcfg.top_k

    # the reference's routing and its vmapped group dispatch
    jgw, jids, _ = JL._route(jp, jnp.asarray(x), jcfg)
    g, Tg, C = L.groups(T, tcfg)
    assert g == G and Tg * G == T
    _, jtok, _ = jax.vmap(lambda xi, wi, ii: JL._dispatch_group(xi, wi, ii, E, C))(
        jnp.asarray(x).reshape(G, Tg, -1), jgw.reshape(G, Tg, K), jids.reshape(G, Tg, K))
    jtok, jids = np.asarray(jtok), np.asarray(jids).reshape(G, Tg, K)
    kept = np.array([[[t in jtok[gi, jids[gi, t, k]] for k in range(K)] for t in range(Tg)]
                     for gi in range(G)])

    r = L.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(r.ids.numpy().reshape(G, Tg, K), jids)
    np.testing.assert_array_equal(r.tok_buf.numpy(), jtok)
    np.testing.assert_array_equal(r.slot.numpy() >= 0, kept)
    assert int(r.dropped()) == int((~kept).sum())
    if "drops" in case:
        assert int(r.dropped()) > 0
    close_to_largest(r.gw.numpy(), jgw)

    jy, jaux = JL.moe_ffn(jp, jnp.asarray(x), jcfg)
    y, aux = L.moe_ffn(tp, torch.from_numpy(x), tcfg)
    close_to_largest(y.numpy(), jy)
    close_to_largest(np.asarray(float(aux)), jaux)

    gy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        yy, a = JL.moe_ffn(p, xx, jcfg)
        return jnp.sum(yy * gy) + a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    def tloss(p, xx):
        yy, a = L.moe_ffn(p, xx, tcfg)
        return torch.sum(yy * torch.from_numpy(gy)) + a

    tgp, (tgx,) = _grads(tloss, tp, torch.from_numpy(x))
    hold_grads(tgp, jgp)
    hold_grads({"x": tgx}, {"x": jgx})


def test_moe_combine_is_bit_stable_and_dispatch_is_scatter_only():
    """Two calls give the same bits; a token routed nowhere (every
    assignment dropped) gets the shared experts' output alone."""
    jcfg, tcfg, np_p, x, _ = _moe_case("softmax-drops")
    tp = params_from_numpy(np_p)
    tx = torch.from_numpy(x)
    y1, a1 = L.moe_ffn(tp, tx, tcfg)
    y2, a2 = L.moe_ffn(tp, tx, tcfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    r = L.route(tp, tx, tcfg)
    gone = (r.slot[0] < 0).all(1)
    if bool(gone.any()):
        np.testing.assert_allclose(y1[gone].numpy(), L.mlp(tp["shared"], tx[gone]).numpy(),
                                   rtol=1e-6, atol=1e-6)


# the reference's own MoE tests (tests/test_models.py), run on the port
def test_moe_capacity_drops_are_bounded_and_outputs_finite():
    cfg = L.MoEConfig(num_experts=4, num_shared=0, top_k=2, d_model=16,
                      d_ff=8, capacity_factor=1.0, tokens_per_group=32)
    gen = torch.Generator().manual_seed(0)
    p, _ = L.init_moe(gen, cfg, torch.float32)
    x = torch.randn((64, 16), generator=gen)
    y, aux = L.moe_ffn(p, x, cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all()) and np.isfinite(float(aux))
    r = L.route(p, x, cfg)
    _, _, C = L.groups(64, cfg)
    assert int((r.tok_buf < 32).sum()) == 64 * 2 - int(r.dropped()) <= 2 * 4 * C


def test_moe_router_bias_update_direction():
    cfg = L.MoEConfig(num_experts=4, num_shared=0, top_k=1, d_model=8,
                      d_ff=8, router="sigmoid_norm")
    p, _ = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    load = torch.tensor([1.0, 0.0, 0.0, 0.0])  # expert 0 overloaded
    b = L.router_bias_update(p, load, lr=0.1)["router_bias"]
    assert b.dtype == torch.float32
    assert float(b[0]) < 0 and bool((b[1:] > 0).all())


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 4), st.integers(4, 32))
def test_property_moe_is_token_permutation_equivariant(k, T):
    """Permuting tokens permutes outputs (dispatch must not mix tokens)."""
    cfg = L.MoEConfig(num_experts=4, num_shared=0, top_k=k, d_model=8,
                      d_ff=8, capacity_factor=8.0, tokens_per_group=T)
    p, _ = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((T, 8), generator=torch.Generator().manual_seed(T))
    perm = torch.from_numpy(np.random.default_rng(k).permutation(T))
    y1, _ = L.moe_ffn(p, x, cfg)
    y2, _ = L.moe_ffn(p, x[perm], cfg)
    np.testing.assert_allclose(y1[perm].numpy(), y2.numpy(), rtol=2e-4, atol=2e-5)


# ------------------------------------------------------------------ MLA
MLA_DIMS = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def _mla_case(seed=0):
    jcfg, tcfg = JL.MLAConfig(**MLA_DIMS), L.MLAConfig(**MLA_DIMS)
    np_p = redraw_uniform_leaves(_np(JL.init_mla(jax.random.key(seed), jcfg, jnp.float32)[0]),
                                 np.random.default_rng(seed))
    return jcfg, tcfg, np_p


@pytest.mark.parametrize("use_flash,attn_chunk", [(True, 512), (False, 8), (False, 512)])
def test_mla_attention_matches_reference(use_flash, attn_chunk):
    """Flash (512-key blocks), q-chunked (chunks of 8 over S = 24) and one
    chunk, against the reference within 1e-5; and its latents are what
    prefill caches."""
    jcfg, tcfg, np_p = _mla_case()
    x = np.random.default_rng(2).normal(size=(2, 24, 64)).astype(np.float32)
    pos = np_positions(2, 24)
    want = JL.mla_attention(jax.tree.map(jnp.asarray, np_p), jcfg, jnp.asarray(x),
                            jnp.asarray(pos), attn_chunk=attn_chunk, use_flash=use_flash)
    tp = params_from_numpy(np_p)
    got = L.mla_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                          attn_chunk=attn_chunk, use_flash=use_flash)
    close_to_largest(got.numpy(), want)


def test_mla_decode_on_a_filled_latent_cache_matches_reference():
    jcfg, tcfg, np_p = _mla_case(1)
    rng = np.random.default_rng(3)
    B, S = 2, 12
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    ckv = rng.normal(size=(B, S, 16)).astype(np.float32)
    kr = rng.normal(size=(B, S, 8)).astype(np.float32)
    pos = np.array([5, 9], np.int32)
    want = JL.mla_decode(jax.tree.map(jnp.asarray, np_p), jcfg, jnp.asarray(x),
                         jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(pos), jnp.asarray(pos))
    got = L.mla_decode(params_from_numpy(np_p), tcfg, torch.from_numpy(x), torch.from_numpy(ckv),
                       torch.from_numpy(kr), torch.from_numpy(pos), torch.from_numpy(pos))
    for g, w in zip(got, want):
        close_to_largest(g.numpy(), w)


# ------------------------------------------------------------------ the LM
def lm_pair(variant: str):
    """The reference's and the port's LM: ``mla_moe_mtp`` is the
    reference's ``test_mla_moe_mtp_decode_matches_forward`` config;
    ``gqa_moe_mtp`` a GQA (kv 2) sliding-window variant with the softmax
    router, 2 shared experts and 4 dispatch groups; ``mla_flash_remat``
    the first with flash attention and remat."""
    moe = dict(num_experts=8, num_shared=1, top_k=2, d_model=64, d_ff=32,
               router="sigmoid_norm", tokens_per_group=64, capacity_factor=4.0)
    base = dict(name="v3", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
                vocab=512, first_k_dense=1, dense_ff=128, mtp=True, remat=False,
                attn_chunk=16)
    mla = True
    if variant == "gqa_moe_mtp":
        moe.update(router="softmax_topk", num_shared=2, tokens_per_group=16)
        base.update(n_kv_heads=2, window=8)
        mla = False
    elif variant == "mla_flash_remat":
        base.update(use_flash=True, remat=True)

    def make(Cfg, Moe, Mla):
        return Cfg(**base, moe=Moe(**moe), mla=Mla(**MLA_DIMS) if mla else None)

    return (JLM(make(JLMConfig, JL.MoEConfig, JL.MLAConfig)),
            TransformerLM(make(LMConfig, L.MoEConfig, L.MLAConfig)))


LM_VARIANTS = ["mla_moe_mtp", "gqa_moe_mtp", "mla_flash_remat"]


def _conditioned(np_params):
    """The attention projections rescaled to the usual fan-in: the
    reference's init takes the heads axis as fan-in of wq/wk/wv [d, h, hd]
    and wq_b/wk_b/wv_b [r, h, x], and head_dim as wo's [h, hd, d], so q
    and k are large and a 3-layer model is already chaotic (fp32 rounding
    alone, in either package, moves the GQA variant's hidden by ~2e-5 of
    its max against a float64 run). Scaled to std 1/sqrt(d) (1/sqrt(r))
    and 1/sqrt(h * hd); the same params go to both packages."""
    def attn(p):
        out = dict(p)
        for name in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b"):
            if name in p:
                out[name] = (p[name] * np.sqrt(p[name].shape[-2] / p[name].shape[-3])
                             ).astype(p[name].dtype)
        out["wo"] = (p["wo"] / np.sqrt(p["wo"].shape[-3])).astype(p["wo"].dtype)
        return out

    return {k: {**v, "attn": attn(v["attn"])} if isinstance(v, dict) and "attn" in v else v
            for k, v in np_params.items()}


def _lm_params(jlm, seed=0):
    np_params = _conditioned(redraw_uniform_leaves(_np(jlm.init(jax.random.key(seed))),
                                                   np.random.default_rng(seed)))
    return jax.tree.map(jnp.asarray, np_params), params_from_numpy(np_params)


@pytest.mark.parametrize("variant", LM_VARIANTS)
def test_lm_hidden_logits_loss_and_grads_match_reference(variant):
    jlm, tlm = lm_pair(variant)
    jp, tp = _lm_params(jlm)
    assert sorted(tp) == sorted(jp) == ["dense_layers", "embed", "final_norm", "moe_layers",
                                        "mtp_block", "mtp_proj"]
    toks = np_tokens((2, 32), seed=1)
    pos = np_positions(2, 32)
    jh, jaux = jlm.hidden(jp, jnp.asarray(toks), jnp.asarray(pos))
    th, taux = tlm.hidden(tp, torch.from_numpy(toks), torch.from_numpy(pos))
    close_to_largest(th.numpy(), jh)
    close_to_largest(np.asarray(float(taux)), jaux)
    assert float(taux) > 0
    np.testing.assert_allclose(tlm.logits(tp, torch.from_numpy(np.array(jh))).numpy(),
                               np.asarray(jlm.logits(jp, jh)), **TOL)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True))(jp)
    tl, tm, tg = tlm.loss_and_grads(tp, {"tokens": torch.from_numpy(toks)})
    assert sorted(tm) == sorted(jm) == ["aux", "ce", "mtp_ce"]
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    hold_grads(tg, jg)


@pytest.mark.parametrize("variant,S,budget", [
    ("mla_moe_mtp", 32, 48),        # the latent cache padded to the budget
    ("mla_moe_mtp", 20, 20),        # exactly full: the decodes wrap, as the reference's
    ("gqa_moe_mtp", 29, None),      # SWA ring of 8, shift (29 - 8) % 8 = 5
    ("mla_flash_remat", 32, 40),
])
def test_prefill_and_chained_decode_match_reference(variant, S, budget):
    jlm, tlm = lm_pair(variant)
    jp, tp = _lm_params(jlm)
    toks = np_tokens((2, S), seed=6)
    jl, jc = jlm.prefill(jp, jnp.asarray(toks), budget=budget)
    tl, tc = tlm.prefill(tp, torch.from_numpy(toks), budget=budget)
    close_to_largest(tl.numpy(), jl)

    def hold(got, want):
        assert sorted(got) == sorted(want)
        for name in want:
            assert tuple(got[name].shape) == want[name].shape, name
            if got[name].dtype.is_floating_point:
                close_to_largest(got[name].numpy(), want[name])
            else:
                np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))

    hold(tc, jc)
    nxt = np_tokens((3, 2), seed=7)
    for t in range(3):
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[t]))
        tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(nxt[t]))
        close_to_largest(tl.numpy(), jl)
        hold(tc, jc)


@pytest.mark.parametrize("variant,budget", [("mla_moe_mtp", 48), ("gqa_moe_mtp", None)])
def test_decode_matches_forward(variant, budget):
    """The reference's ``_decode_consistency`` on the port (its tolerance
    for the MLA/MoE/MTP config, 2e-2): prefill, one greedy decode step,
    against the forward over the longer sequence."""
    lm = lm_pair(variant)[1]
    params = lm.init(0, "cpu")
    toks = torch.from_numpy(np_tokens((2, 32), 3))
    lp, cache = lm.prefill(params, toks, budget=budget)
    nxt = torch.argmax(lp, -1).to(torch.int32)
    ld, cache = lm.decode_step(params, cache, nxt)
    toks2 = torch.cat([toks, nxt[:, None]], 1)
    pos = torch.arange(toks2.shape[1], dtype=torch.int32).expand(toks2.shape)
    h, _ = lm.hidden(params, toks2, pos)
    full = lm.logits(params, h[:, -1:])[:, 0]
    err = float(torch.max(torch.abs(full - ld)))
    assert err < 2e-2, err


# ------------------------------------------------------------------ configs
DEEPSEEK = ["deepseek-moe-16b", "deepseek-v3-671b"]


@pytest.mark.parametrize("name", DEEPSEEK)
def test_deepseek_train_step_matches_reference_with_microbatches(name):
    """The smoke config (2 microbatches of [1, 64]; AdamW or Adafactor):
    the port's train step's loss, metrics and updated params against the
    reference's step."""
    ja, ta = j_get_arch(name, smoke=True), get_arch(name, smoke=True)
    jstate = ja.init_train_state(jax.random.key(0))
    tstate = train_state_from_numpy({"params": _np(jstate.params), "opt": opt_tree(jstate.opt)})
    toks = np_tokens((2, 1, 64), seed=9)
    jnew, jm = jax.jit(ja.step("train_4k").fn)(jstate, {"tokens": jnp.asarray(toks)})
    tnew, tm = ta.step("train_4k").fn(tstate, {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    if ta.cfg.mtp:
        np.testing.assert_allclose(float(tm["mtp_ce"]), float(jm["mtp_ce"]), **TOL)
    for g, w in zip(jax.tree.leaves(params_to_numpy(tnew.params)), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------ repairs
def _old_stack_layers(gen, n_layers, make_one):
    """``stack_layers`` before the preallocated stack: a list, then stack."""
    layers = [make_one(gen) for _ in range(n_layers)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return stack(layers)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stack_layers_fills_a_preallocated_stack_with_the_same_draws(n_layers):
    cfg = lm_pair("mla_moe_mtp")[1].cfg
    for kind in ("dense", "moe"):
        def make(g, k=kind):
            return _init_block(g, cfg, k)[0]
        new, axes = L.stack_layers(torch.Generator().manual_seed(3), n_layers,
                                   lambda g: _init_block(g, cfg, kind))
        old = _old_stack_layers(torch.Generator().manual_seed(3), n_layers, make)
        assert jax.tree.structure(new) == jax.tree.structure(
            axes, is_leaf=lambda x: isinstance(x, tuple))
        assert jax.tree.structure(new) == jax.tree.structure(old)
        for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(old)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_experts_drawn_one_at_a_time_and_dense_draws_unchanged():
    """An experts leaf is its experts' draws in turn, in the param dtype;
    a dense leaf is one draw, as before."""
    b = L.Builder(torch.Generator().manual_seed(5), torch.bfloat16)
    b.normal("w", (3, 16, 8), ("experts", "embed", "mlp"), by_expert=True)
    b.normal("d", (16, 8), ("embed", "mlp"))
    g = torch.Generator().manual_seed(5)
    want = torch.stack([(torch.randn((16, 8), generator=g) / 4.0).to(torch.bfloat16)
                        for _ in range(3)])
    assert torch.equal(b.params["w"], want)
    assert torch.equal(b.params["d"], (torch.randn((16, 8), generator=g) / 4.0).to(torch.bfloat16))


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _bf16_tree_with_fp32_bias():
    lm = lm_pair("mla_moe_mtp")[1]
    cfg = dataclasses.replace(lm.cfg, param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    return TransformerLM(cfg).init(0, "cpu")


def test_bf16_tree_with_fp32_router_bias_crosses_convert_bit_for_bit():
    """The reference's bf16 tree (its ``router_bias`` fp32) into the port
    and back, and the port's own tree out and in, every leaf's dtype and
    bits kept."""
    jlm = lm_pair("mla_moe_mtp")[0]
    jlm = JLM(dataclasses.replace(jlm.cfg, param_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16))
    np_tree = _np(jlm.init(jax.random.key(0)))
    np_tree["moe_layers"]["moe"]["router_bias"] = np.random.default_rng(1).normal(
        size=np_tree["moe_layers"]["moe"]["router_bias"].shape).astype(np.float32)
    t = params_from_numpy(np_tree)
    assert t["moe_layers"]["moe"]["router_bias"].dtype == torch.float32
    assert t["moe_layers"]["moe"]["w_up"].dtype == t["mtp_proj"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(params_to_numpy(t)), jax.tree.leaves(np_tree)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    params = _bf16_tree_with_fp32_bias()
    back = params_from_numpy(params_to_numpy(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_bf16_train_checkpoint_round_trips_bit_for_bit(tmp_path):
    """The train checkpoint writes a bf16 leaf by its 16-bit view and reads
    it back by the abstract leaf's dtype; the fp32 leaf beside it and every
    other dtype as before."""
    params = _bf16_tree_with_fp32_bias()
    params["moe_layers"]["moe"]["router_bias"].normal_(generator=torch.Generator().manual_seed(2))
    tree = {"params": params, "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree)
    abstract = jax.tree.map(torch.zeros_like, tree)
    got, meta = mgr.restore(abstract)
    assert meta["step"] == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    z = np.load(tmp_path / "step_000000000007" / "arrays.npz")
    key = next(k for k in z.files if "w_up" in k)
    assert z[key].dtype.itemsize == 2 and z[key].dtype.kind == "V"
