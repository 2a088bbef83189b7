"""The paper's embedder (``repro_torch/models/transformer.py::
EncoderEmbedder``, registered as ``streaming-rag-embedder``) against the
JAX reference, with the reference's params carried by
``convert.params_from_numpy`` (its norm scales redrawn in numpy first so
that they matter): ``embed`` (an all-padding row is the zero vector in
both), the InfoNCE loss and ``alignment`` within 1e-5, gradients against
``jax.grad`` within rtol 1e-4 (atol 1e-4 of the leaf's largest gradient),
and the full config's param shapes and cells. Then bf16 leaves across
``convert`` both ways bit for bit, a bf16 LM forward, and the train
launcher for the embedder and an LM."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models.api import get_arch as j_get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.api import get_arch
from repro_torch.models.transformer import TransformerLM
from _torch_parity import (TOL, close_to_largest, hold_grads, np_positions,
                           np_tokens, redraw_uniform_leaves, tiny_lm_pair)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


# ------------------------------------------------------------------ encoder
def _encoder_pair():
    ja, ta = (j_get_arch("streaming-rag-embedder", smoke=True),
              get_arch("streaming-rag-embedder", smoke=True))
    np_params = redraw_uniform_leaves(jax.tree.map(np.asarray, ja.init(jax.random.key(0))),
                        np.random.default_rng(0))
    return ja, jax.tree.map(jnp.asarray, np_params), ta, params_from_numpy(np_params)


def _pairs_batch(B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("anchor", "positive"):
        lens = rng.integers(1, S + 1, B)
        out[side] = rng.integers(0, vocab, (B, S)).astype(np.int32)
        out[f"{side}_mask"] = np.arange(S)[None, :] < lens[:, None]
    return out


def test_encoder_embed_matches_reference_with_an_all_padding_row():
    ja, jp, ta, tp = _encoder_pair()
    b = _pairs_batch(6, 16, 128, seed=10)
    mask = b["anchor_mask"].copy()
    mask[3] = False
    want = np.asarray(ja.embed(jp, jnp.asarray(b["anchor"]), jnp.asarray(mask)))
    got = ta.embed(tp, torch.from_numpy(b["anchor"]), torch.from_numpy(mask)).numpy()
    close_to_largest(got, want)
    assert np.all(got[3] == 0) and np.all(want[3] == 0)
    np.testing.assert_allclose(np.linalg.norm(np.delete(got, 3, 0), axis=-1), 1.0, rtol=1e-5)
    # padding keys are invisible: other tokens under the mask change nothing
    toks = b["anchor"].copy()
    toks[~mask] = 0
    again = ta.embed(tp, torch.from_numpy(toks), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(again, got, rtol=1e-6, atol=1e-7)


def test_encoder_loss_alignment_and_grads_match_reference():
    ja, jp, ta, tp = _encoder_pair()
    b = _pairs_batch(8, 16, 128, seed=11)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: ja.loss(p, {k: jnp.asarray(v) for k, v in b.items()}), has_aux=True))(jp)
    tl, tm, tg = ta.loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["alignment"]), float(jm["alignment"]), **TOL)
    hold_grads(tg, jg)


def test_encoder_full_config_param_shapes_and_cells():
    ja, ta = j_get_arch("streaming-rag-embedder"), get_arch("streaming-rag-embedder")
    want = jax.eval_shape(ja.init, jax.random.key(0))
    got = ta.init(0, "cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), got) == \
        jax.tree.map(lambda a: (tuple(a.shape), "torch." + str(a.dtype)), want)
    # 30,522 x 384 tied embedding + 6 x 2,359,296 + the norms (the
    # reference's "~22M" comment undercounts)
    assert sum(t.numel() for t in jax.tree.leaves(got)) == 25_881_216
    assert {n: (s.kind, s.dims) for n, s in ta.shapes.items()} == \
        {n: (s.kind, s.dims) for n, s in ja.shapes.items()}
    for shape in ta.shapes:
        spec, jspec = ta.step(shape), ja.step(shape)
        assert spec.kind == jspec.kind
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in spec.input_specs.items()} == \
            {k: (tuple(v.shape), jnp.dtype(v.dtype).name.replace("bool_", "bool"))
             for k, v in jspec.input_specs.items()}


# ------------------------------------------------------------------ convert
def test_bf16_params_cross_both_ways_bit_for_bit():
    rng = np.random.default_rng(12)
    jtree = {"w": jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16),
             "n": {"s": jnp.asarray(rng.normal(size=(3,)), jnp.bfloat16),
                   "f": jnp.asarray(rng.normal(size=(2, 2)), jnp.float32),
                   "i": jnp.arange(4, dtype=jnp.int32)}}
    np_tree = jax.tree.map(np.asarray, jtree)
    assert np_tree["w"].dtype == ml_dtypes.bfloat16
    t = params_from_numpy(np_tree)
    assert t["w"].dtype == t["n"]["s"].dtype == torch.bfloat16
    assert t["n"]["f"].dtype == torch.float32 and t["n"]["i"].dtype == torch.int32
    np.testing.assert_array_equal(t["w"].view(torch.int16).numpy(),
                                  np_tree["w"].view(np.int16))
    back = params_to_numpy(t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = jax.tree.map(jnp.asarray, back)
    assert again["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(again["w"], np.float32),
                                  np.asarray(jtree["w"], np.float32))


def test_bf16_lm_forward_stays_close_to_reference():
    jlm, tlm = tiny_lm_pair(window=8, param_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16)
    tlm = TransformerLM(dataclasses.replace(tlm.cfg, param_dtype=torch.bfloat16,
                                            act_dtype=torch.bfloat16))
    jp = jlm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks, pos = np_tokens((2, 16), seed=13), np_positions(2, 16)
    jh, _ = jlm.hidden(jp, jnp.asarray(toks), jnp.asarray(pos))
    th, _ = tlm.hidden(tp, torch.from_numpy(toks), torch.from_numpy(pos))
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(th.to(torch.float32).numpy(), np.asarray(jh, np.float32),
                               rtol=5e-2, atol=5e-2)


# ------------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch", ["streaming-rag-embedder", "qwen2-1.5b"])
def test_train_launcher_runs_the_new_archs(arch, tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                          "--device", "cpu", "--steps", "2", "--ckpt-interval", "1",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "final checkpoint: 2", lines
    assert lines[-2].startswith("step 2: loss=")
    assert np.isfinite(float(lines[-2].split("loss=")[1].split()[0]))
