"""The port's dense transformer family and the paper's embedder
(``repro_torch/models/transformer.py``) against the JAX reference: the
reference's params cross with ``convert.params_from_numpy`` (its ones and
zeros — norms, QKV biases — redrawn in numpy first so that they matter),
the same seeded numpy tokens go through both packages.

``TransformerLM`` (the ``tiny_dense`` shapes of ``tests/test_models.py``;
full and sliding-window attention; untied, and biased + tied): ``hidden``,
``logits`` and ``loss`` within 1e-5 (rtol 1e-5, atol 1e-5 of the largest
|value|: the reference's init draws q and k with std 0.5, so its scores
are large and each package lands up to ~1e-5 of the largest |hidden| off a
float64 run of the same model, summing in its own order), the gradients of ``loss`` against
``jax.grad`` within rtol 1e-4 (atol 1e-4 of the leaf's largest gradient);
``prefill``'s logits and every cache leaf for a SWA ring that wraps and a
padded budget; three chained ``decode_step``s; the reference's
decode-vs-forward and out-of-window tests on the port; each LM config's
fields (the deepseek pair's MoE and MLA settings too) and smoke cells
shaped as the reference's, and qwen2's train step with two microbatches
(``tests/test_torch_moe_mla.py`` holds the deepseek pair's). ``tests/test_torch_embedder.py`` holds the encoder, bf16
across ``convert`` and the train launcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.api import get_arch as j_get_arch
from repro.models.testing import dummy_batch as j_dummy_batch
from _torch_parity import (TOL, close_to_largest, hold_cache, hold_grads, np_positions,
                           np_tokens, redraw_uniform_leaves, tiny_lm_pair)
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.api import get_arch
from repro_torch.models.testing import assert_finite, dummy_batch
from repro_torch.models.transformer import TransformerLM

LM_ARCHS = ["qwen2-1.5b", "h2o-danube-1.8b", "h2o-danube-3-4b", "deepseek-moe-16b",
            "deepseek-v3-671b"]
VARIANTS = {
    "full": dict(),
    "swa": dict(window=8),
    "biased_tied": dict(qkv_bias=True, tied_embeddings=True),
    "swa_flash_remat": dict(window=8, use_flash=True, flash_block_k=16, remat=True),
}


def _lm_pair(variant, seed=0):
    jlm, tlm = tiny_lm_pair(**VARIANTS[variant])
    np_params = redraw_uniform_leaves(jax.tree.map(np.asarray, jlm.init(jax.random.key(seed))),
                        np.random.default_rng(seed))
    return jlm, jax.tree.map(jnp.asarray, np_params), tlm, params_from_numpy(np_params)



# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lm_hidden_logits_loss_and_grads_match_reference(variant):
    jlm, jp, tlm, tp = _lm_pair(variant)
    toks = np_tokens((2, 32), seed=1)
    pos = np_positions(2, 32)
    jh, _ = jlm.hidden(jp, jnp.asarray(toks), jnp.asarray(pos))
    th, aux = tlm.hidden(tp, torch.from_numpy(toks), torch.from_numpy(pos))
    close_to_largest(th.numpy(), jh)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlm.logits(tp, torch.from_numpy(np.array(jh))).numpy(),
                               np.asarray(jlm.logits(jp, jh)), **TOL)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True))(jp)
    tl, tm, tg = tlm.loss_and_grads(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **TOL)
    hold_grads(tg, jg)


def test_ce_chunked_ignores_negative_labels_like_reference():
    jlm, jp, tlm, tp = _lm_pair("full")
    toks = np_tokens((2, 24), seed=2)
    labels = np_tokens((2, 24), seed=3)
    labels[0, :5] = -1
    labels[1, 20:] = -7
    jh, _ = jlm.hidden(jp, jnp.asarray(toks), jnp.asarray(np_positions(2, 24)))
    th, _ = tlm.hidden(tp, torch.from_numpy(toks), torch.from_numpy(np_positions(2, 24)))
    for chunk in (512, 5):   # one chunk; the largest divisor of 24 at most 5 (4)
        want = jlm._ce_chunked(jp, jh, jnp.asarray(labels), chunk=chunk)
        got = tlm._ce_chunked(tp, th, torch.from_numpy(labels), chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_q_chunked_attention_matches_reference_and_one_chunk():
    """attn_chunk 16 over S = 40: chunks of the largest divisor, 10."""
    jlm, tlm = tiny_lm_pair(window=12)
    jp = jlm.init(jax.random.key(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks, pos = np_tokens((1, 40), seed=5), np_positions(1, 40)
    jh, _ = jlm.hidden(jp, jnp.asarray(toks), jnp.asarray(pos))
    th, _ = tlm.hidden(tp, torch.from_numpy(toks), torch.from_numpy(pos))
    close_to_largest(th.numpy(), jh)
    whole = TransformerLM(dataclasses.replace(tlm.cfg, attn_chunk=64))
    np.testing.assert_allclose(
        whole.hidden(tp, torch.from_numpy(toks), torch.from_numpy(pos))[0].numpy(),
        th.numpy(), rtol=1e-5, atol=1e-5 * float(np.abs(th.numpy()).max()))


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("variant,S,budget", [
    ("swa", 32, None),            # ring of 8: positions 24..31 at slots 0..7
    ("swa", 29, None),            # shift (29 - 8) % 8 = 5
    ("swa_flash_remat", 29, None),
    ("biased_tied", 32, 48),      # full attention, padded to the budget
    ("full", 32, None),
])
def test_prefill_and_chained_decode_match_reference(variant, S, budget):
    jlm, jp, tlm, tp = _lm_pair(variant)
    toks = np_tokens((2, S), seed=6)
    jl, jc = jlm.prefill(jp, jnp.asarray(toks), budget=budget)
    tl, tc = tlm.prefill(tp, torch.from_numpy(toks), budget=budget)
    close_to_largest(tl.numpy(), jl)
    hold_cache(tc, jc)
    nxt = np_tokens((3, 2), seed=7)
    for t in range(3):
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(nxt[t]))
        tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(nxt[t]))
        close_to_largest(tl.numpy(), jl)
        hold_cache(tc, jc)


def test_swa_prefill_places_each_position_at_its_ring_slot():
    _, _, tlm, tp = _lm_pair("swa")
    _, cache = tlm.prefill(tp, torch.from_numpy(np_tokens((1, 29), seed=8)))
    pos = cache["pos"][0]
    assert pos.tolist() == sorted(range(21, 29), key=lambda p: p % 8)
    assert all(int(p) % 8 == s for s, p in enumerate(pos))


def _decode_consistency(lm, toks, budget, tol):
    """The reference's ``tests/test_models.py::_decode_consistency`` on the
    port: prefill, one greedy decode step, against the forward over the
    longer sequence."""
    params = lm.init(0, "cpu")
    lp, cache = lm.prefill(params, toks, budget=budget)
    nxt = torch.argmax(lp, -1).to(torch.int32)
    ld, cache = lm.decode_step(params, cache, nxt)
    toks2 = torch.cat([toks, nxt[:, None]], 1)
    pos = torch.arange(toks2.shape[1], dtype=torch.int32).expand(toks2.shape)
    h, _ = lm.hidden(params, toks2, pos)
    full = lm.logits(params, h[:, -1:])[:, 0]
    err = float(torch.max(torch.abs(full - ld)))
    assert err < tol, err


def test_dense_swa_decode_matches_forward():
    _decode_consistency(tiny_lm_pair(window=8)[1], torch.from_numpy(np_tokens((2, 32), 1)),
                        budget=None, tol=2e-3)


def test_full_attn_decode_matches_forward():
    _decode_consistency(tiny_lm_pair(qkv_bias=True, tied_embeddings=True)[1],
                        torch.from_numpy(np_tokens((2, 32), 2)), budget=48, tol=2e-3)


def test_swa_masks_out_of_window():
    """Tokens beyond the sliding window must not affect logits."""
    lm = tiny_lm_pair(window=4)[1]
    params = lm.init(0, "cpu")
    t1 = torch.from_numpy(np_tokens((1, 16), 4))
    t2 = t1.clone()
    t2[:, :8] = torch.from_numpy(np_tokens((1, 8), 5))
    pos = torch.arange(16, dtype=torch.int32)[None]
    l1 = lm.logits(params, lm.hidden(params, t1, pos)[0][:, -1:])
    l2 = lm.logits(params, lm.hidden(params, t2, pos)[0][:, -1:])
    # window 4, 2 layers -> receptive field 8 < 16: early tokens invisible
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_config_matches_reference_and_smoke_cells_run(name):
    ja, ta = j_get_arch(name, smoke=True), get_arch(name, smoke=True)
    full_j, full_t = j_get_arch(name).cfg, get_arch(name).cfg
    for f in dataclasses.fields(full_t):
        want, got = getattr(full_j, f.name), getattr(full_t, f.name)
        if f.name in ("param_dtype", "act_dtype"):
            assert str(got).split(".")[-1] == jnp.dtype(want).name, f.name
        elif f.name in ("moe", "mla"):   # the packages' own MoEConfig / MLAConfig
            assert (got is None) == (want is None), f.name
            if want is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert ta.optimizer == get_arch(name).optimizer and ta.optimizer.kind == ja.optimizer.kind
    assert ta.microbatches == ja.microbatches == 2
    assert {n: (s.kind, s.dims, s.skip) for n, s in ta.shapes.items()} == \
        {n: (s.kind, s.dims, s.skip) for n, s in ja.shapes.items()}
    assert get_arch(name).shapes["long_500k"].skip == j_get_arch(name).shapes["long_500k"].skip
    jparams = ja.abstract_params()
    params = ta.init(0, "cpu")
    for shape, sh in ta.shapes.items():
        if sh.skip:
            continue
        spec, jspec = ta.step(shape), ja.step(shape)
        assert spec.kind == jspec.kind
        jbatch = j_dummy_batch(jspec.input_specs)
        batch = dummy_batch(spec.input_specs, device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), batch) == \
            jax.tree.map(lambda a: tuple(a.shape), jbatch)
        if spec.kind == "train":
            state = ta.init_train_state(0, "cpu")
            new, metrics = spec.fn(state, batch)
            assert np.isfinite(float(metrics["loss"]))
            assert not torch.equal(new.params["embed"]["embedding"],
                                   state.params["embed"]["embedding"])
            continue
        out = spec.fn(params, batch)
        assert_finite(out, f"{name}/{shape}")
        want = jax.eval_shape(jspec.fn, jparams, jbatch)
        assert jax.tree.map(lambda t: tuple(t.shape), out) == \
            jax.tree.map(lambda a: tuple(a.shape), want)


def test_lm_train_step_matches_reference_with_microbatches():
    """qwen2's smoke config (2 microbatches of [1, 64]): the port's train
    step's loss and updated params against the reference's step."""
    ja, ta = j_get_arch("qwen2-1.5b", smoke=True), get_arch("qwen2-1.5b", smoke=True)
    jstate = ja.init_train_state(jax.random.key(0))
    np_state = jax.tree.map(np.asarray, jstate.params)
    from repro_torch.convert import train_state_from_numpy
    tstate = train_state_from_numpy({"params": np_state, "opt": {
        "step": np.asarray(jstate.opt.step), "mu": jax.tree.map(np.asarray, jstate.opt.mu),
        "nu": jax.tree.map(np.asarray, jstate.opt.nu)}})
    toks = np_tokens((2, 1, 64), seed=9)
    jnew, jm = jax.jit(ja.step("train_4k").fn)(jstate, {"tokens": jnp.asarray(toks)})
    tnew, tm = ta.step("train_4k").fn(tstate, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    for g, w in zip(jax.tree.leaves(params_to_numpy(tnew.params)), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
