"""The port's optimizer (``repro_torch/train/optimizer.py``) against the
JAX reference's on the same numpy params and grads: the schedule,
clipping, ``init`` and three ``apply`` steps of AdamW, Adafactor (factored
and full leaves) and SGD; then the reference's own optimizer tests
(``test_train_infra.py``) on the port.

Tolerance: the schedule within 1 float32 ulp (both compute it in float32
tensors; ``cos`` may round the other way); everything else within rtol
1e-6 / atol 1e-7: both sides see identical grads, so only the order of a
sum (the global norm, Adafactor's means) differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import opt_tree
from repro.train import optimizer as j_opt
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.train import optimizer as t_opt

TOL = dict(rtol=1e-6, atol=1e-7)


def _cfg(mod, **kw):
    return mod.OptimizerConfig(**kw)


def _params(rng):
    """A param tree with a factored leaf (both dims >= 8), a full matrix, a
    vector and a 0-d leaf; keys out of sorted order."""
    return {"w": rng.normal(size=(16, 12)).astype(np.float32),
            "b": rng.normal(size=(12,)).astype(np.float32),
            "m": {"z": rng.normal(size=(3, 5)).astype(np.float32),
                  "a": np.float32(rng.normal())}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_tree(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree(got[k], want[k], **tol)
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree(g, w, **tol)
    elif want is None:
        assert got is None
    else:
        got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10_000])
def test_schedule_matches_reference(step):
    for kw in ({}, dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
               dict(lr=1e-3, warmup_steps=0, total_steps=1)):
        want = np.float32(j_opt.schedule(_cfg(j_opt, **kw), jnp.int32(step)))
        got = t_opt.schedule(_cfg(t_opt, **kw), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(np.float32(got.item()) - want) <= np.spacing(want), (kw, step)


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(0)
    g = _params(rng)
    for max_norm in (1.0, 1e3):
        jc, jn = j_opt.clip_by_global_norm(_j(g), max_norm)
        tc, tn = t_opt.clip_by_global_norm(_t(g), max_norm)
        np.testing.assert_allclose(tn.item(), float(jn), **TOL)
        _assert_tree(tc, jax.tree.map(np.asarray, jc), **TOL)


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_init_and_three_steps_match_reference(kind):
    kw = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10, factored_min_dim=8)
    jc, tc = _cfg(j_opt, **kw), _cfg(t_opt, **kw)
    rng = np.random.default_rng(1)
    p = _params(rng)
    jp, jst = _j(p), j_opt.init(jc, _j(p))
    tp, tst = _t(p), t_opt.init(tc, _t(p))
    _assert_tree(opt_state_to_numpy(tst), opt_tree(jst), rtol=0, atol=0)
    if kind == "adafactor":
        assert isinstance(tst.nu["w"], tuple) and tst.nu["w"][0].shape == (16,)
        assert not isinstance(tst.nu["m"]["z"], tuple) and tst.mu is None
    for i in range(3):
        g = _params(np.random.default_rng(10 + i))
        jp, jst, jm = j_opt.apply(jc, jp, _j(g), jst)
        tp, tst, tm = t_opt.apply(tc, tp, _t(g), tst)
        _assert_tree(tp, jax.tree.map(np.asarray, jp), **TOL)
        _assert_tree(opt_state_to_numpy(tst), opt_tree(jst), **TOL)
        assert int(tst.step) == int(jst.step) == i + 1
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), **TOL)


def test_apply_writes_no_argument():
    """``apply`` is functional: params, grads and the state it was given
    are bit for bit what they were."""
    cfg = t_opt.OptimizerConfig(kind="adamw", lr=0.1, warmup_steps=0)
    p = _t(_params(np.random.default_rng(2)))
    g = _t(_params(np.random.default_rng(3)))
    st = t_opt.init(cfg, p)
    st = t_opt.apply(cfg, p, g, st)[1]
    snap = [x.clone() for x in t_opt.leaves(p) + t_opt.leaves(g)
            + t_opt.leaves(st.mu) + t_opt.leaves(st.nu)]
    t_opt.apply(cfg, p, g, st)
    now = t_opt.leaves(p) + t_opt.leaves(g) + t_opt.leaves(st.mu) + t_opt.leaves(st.nu)
    assert all(torch.equal(a, b) for a, b in zip(snap, now))


def test_opt_state_crosses_both_ways():
    cfg = j_opt.OptimizerConfig(kind="adafactor", factored_min_dim=8)
    jst = j_opt.init(cfg, _j(_params(np.random.default_rng(4))))
    tree = opt_tree(jst)
    st = opt_state_from_numpy(tree)
    assert st.mu is None and isinstance(st.nu["w"], tuple)
    assert st.step.dtype == torch.int32 and st.step.dim() == 0
    _assert_tree(opt_state_to_numpy(st), tree, rtol=0, atol=0)


# ---------------------------------------------- the reference's own tests
@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_optimizer_descends_quadratic(kind):
    cfg = t_opt.OptimizerConfig(kind=kind, lr=0.1, warmup_steps=0,
                                total_steps=100, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.full((4, 200), 5.0), "b": torch.full((200,), -3.0)}
    state = t_opt.init(cfg, params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(30):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = t_opt.apply(cfg, params, grads, state)
    assert float(loss(params)) < 0.5 * l0


def test_adafactor_state_is_factored():
    cfg = t_opt.OptimizerConfig(kind="adafactor", factored_min_dim=8)
    params = {"big": torch.zeros((64, 32)), "small": torch.zeros((4,))}
    state = t_opt.init(cfg, params)
    assert isinstance(state.nu["big"], tuple)
    assert state.nu["big"][0].shape == (64,)
    assert state.nu["big"][1].shape == (32,)
    assert state.nu["small"].shape == (4,)
    assert state.mu is None  # no first moment -> O(n+m) memory


def test_grad_clipping_bounds_norm():
    g = {"a": torch.full((100,), 10.0)}
    clipped, norm = t_opt.clip_by_global_norm(g, 1.0)
    assert float(norm) > 99.0
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in t_opt.leaves(clipped)))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)


def test_schedule_warmup_and_decay():
    cfg = t_opt.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step, want in ((5, 0.5), (10, 1.0), (100, 0.1)):
        got = t_opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert float(got) == pytest.approx(want)
