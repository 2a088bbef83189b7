"""The port's training path against the JAX reference at each recsys
arch's smoke config, from one state carried across by ``convert`` and on
the reference's own draws (``_torch_parity.recsys_draws``: MIND's sampled
negatives, BERT4Rec's mask uniforms and negatives, from the batch's
``rng``): the loss, then its gradients against ``jax.grad``, then one
``make_train_step`` against the reference's ``train_step``. Then FM with
``microbatches = 2`` against the reference's scan path, the trainer's
``grad_accum = 2`` against the reference trainer's scan, ``rms_norm``'s
gradient against the reference's custom VJP, six ``Trainer.fit`` steps of
MIND in both packages, and the trainer's resume, retry and rollback, and
an Adafactor checkpoint round trip.

Tolerance: the loss within rtol 1e-5; gradients (held before the
optimizer: AdamW's first step maps g to about g / (|g| + eps), so two
gradients that differ only in rounding near zero may move a param by
different amounts) within rtol 1e-5 / atol 1e-6; params after a step
within rtol 1e-5 / atol 1e-6. The packages sum in other orders (capsule
routing, attention, the GRU recurrences, the sampled softmax), so floats
are not bit-equal. Six trainer steps compound that: the loss history
within rtol 1e-4, the final params within rtol 1e-4 / atol 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import opt_tree, recsys_draws
from repro.models.api import get_arch as j_get_arch
from repro.models.layers import rms_norm as j_rms_norm
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch.convert import (params_from_numpy, params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels.counts import COUNTS
from repro_torch.models import layers as L
from repro_torch.models.api import TrainState, get_arch
from repro_torch.models.testing import dummy_batch
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ["mind", "bert4rec", "dien", "fm"]


def _np_batch(arch, B, seed):
    """A seeded numpy train batch: ids uniform over the vocabulary, a valid
    prefix of length uniform in [1, S], labels in {0, 1}, a key."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, B).astype(np.float32)
    if arch.name.startswith("fm"):
        return {"fields": rng.integers(0, arch.cfg.rows_per_field,
                                       (B, arch.cfg.n_fields)).astype(np.int32),
                "labels": labels}
    S, n = arch.hist_len, arch.cfg.n_items
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, B)[:, None]
    hist = np.where(mask, rng.integers(0, n, (B, S)), 0).astype(np.int32)
    return {"hist": hist, "hist_mask": mask, "target": rng.integers(0, n, B).astype(np.int32),
            "labels": labels, "rng": np.array([seed, 7 * seed + 1], np.uint32)}


def _both(arch, batch):
    """(reference batch, port batch carrying the reference's draws)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "rng" in batch:
        B, S = batch["hist"].shape
        for k, v in recsys_draws(arch.name, batch["rng"], B, S, arch.cfg.n_items).items():
            tb[k] = torch.from_numpy(np.array(v))
    return jb, tb


def _pair(name, **overrides):
    ja, ta = j_get_arch(name, smoke=True), get_arch(name, smoke=True)
    for k, v in overrides.items():
        setattr(ja, k, v)
        setattr(ta, k, v)
    jstate = ja.init_train_state(jax.random.key(0))
    tstate = train_state_from_numpy({"params": jax.tree.map(np.asarray, jstate.params),
                                     "opt": opt_tree(jstate.opt)})
    return ja, jstate, ta, tstate


def _assert_tree(got, want, where="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree(got[k], want[k], f"{where}.{k}", **tol)
    elif isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree(g, w, f"{where}[{i}]", **tol)
    elif want is None:
        assert got is None, where
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=where, **tol)


def test_every_arch_carries_its_configs_optimizer():
    from repro_torch.configs import bert4rec, dien, fm, mind

    for mod in (mind, bert4rec, dien, fm):
        name = mod.__name__.rsplit(".", 1)[1]
        for smoke in (False, True):
            arch = get_arch(name, smoke=smoke)
            assert arch.optimizer == mod.OPT, (name, smoke)
            assert vars(arch.optimizer) == vars(j_get_arch(name, smoke=smoke).optimizer)
            assert arch.optimizer.lr == 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_loss_gradients_and_one_step_match_reference(name):
    ja, jstate, ta, tstate = _pair(name)
    jb, tb = _both(ta, _np_batch(ta, 16, seed=len(name)))
    # the loss
    j_loss, j_ex = ja.loss(jstate.params, jb)
    t_loss, t_ex = ta.loss(tstate.params, tb)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    assert set(t_ex) == set(j_ex)
    # its gradients, before any optimizer
    j_grads = jax.grad(lambda p: ja.loss(p, jb)[0])(jstate.params)
    t_loss2, _, t_grads = ta.loss_and_grads(tstate.params, tb)
    assert t_loss2.item() == t_loss.item()
    _assert_tree(params_to_numpy(t_grads), jax.tree.map(np.asarray, j_grads), name, **TOL)
    # one train step through the StepSpec
    spec = ta.step("train_batch")
    assert spec.kind == "train"
    j_new, j_m = ja.make_train_step()(jstate, jb)
    t_new, t_m = spec.fn(tstate, tb)
    want = {"params": jax.tree.map(np.asarray, j_new.params), "opt": opt_tree(j_new.opt)}
    _assert_tree(train_state_to_numpy(t_new), want, name, **TOL)
    assert int(t_new.opt.step) == int(j_new.opt.step) == 1
    assert set(t_m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), rtol=1e-5, err_msg=k)


def test_fm_microbatches_match_reference_scan():
    ja, jstate, ta, tstate = _pair("fm", microbatches=2)
    b = _np_batch(ta, 32, seed=5)
    split = {k: v.reshape((2, 16) + v.shape[1:]) for k, v in b.items()}
    jb, tb = _both(ta, split)
    j_new, j_m = ja.make_train_step()(jstate, jb)
    t_new, t_m = ta.make_train_step()(tstate, tb)
    want = {"params": jax.tree.map(np.asarray, j_new.params), "opt": opt_tree(j_new.opt)}
    _assert_tree(train_state_to_numpy(t_new), want, "fm/M=2", **TOL)
    for k in j_m:
        np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["fm", "mind"])
def test_trainer_grad_accum_matches_reference_scan(tmp_path, name):
    """``grad_accum = 2``: each trainer step takes a batch with a leading
    axis of 2 and makes one optimizer update per slice, as the reference's
    scan does; two such steps through ``fit`` against two calls of the
    reference trainer's step (its own ``fit`` cannot log the scan's stacked
    metrics: ROADMAP C0f). The port logs their mean. Four updates compound
    rounding as the six-step fit does: params within rtol 1e-4 / atol 1e-5."""
    ja, jstate, ta, tstate = _pair(name)
    steps = []
    for i in range(2):
        pair = [_both(ta, _np_batch(ta, 16, seed=40 + 2 * i + j)) for j in range(2)]
        steps.append(({k: jnp.stack([p[0][k] for p in pair]) for k in pair[0][0]},
                      {k: torch.stack([p[1][k] for p in pair]) for k in pair[0][1]}))
    jtr = JTrainer(ja, JTrainerConfig(total_steps=2, ckpt_dir=str(tmp_path / "j"),
                                      grad_accum=2))
    j_losses = []
    for jb, _ in steps:
        jstate, j_m = jtr.step_fn(jstate, jb)
        assert np.asarray(j_m["loss"]).shape == (2,)
        j_losses.append(float(np.mean(np.asarray(j_m["loss"]))))
    ttr = Trainer(ta, TrainerConfig(total_steps=2, ckpt_dir=str(tmp_path / "t"),
                                    ckpt_interval=2, log_interval=1, grad_accum=2),
                  device="cpu")
    t_state, t_hist = ttr.fit(iter(tb for _, tb in steps), state=tstate)
    assert [s for s, _ in t_hist] == [1, 2]
    np.testing.assert_allclose([m["loss"] for _, m in t_hist], j_losses, rtol=1e-5)
    assert int(t_state.opt.step) == int(np.asarray(jstate.opt.step)) == 4
    want = {"params": jax.tree.map(np.asarray, jstate.params), "opt": opt_tree(jstate.opt)}
    _assert_tree(train_state_to_numpy(t_state), want, f"{name}/accum=2", rtol=1e-4, atol=1e-5)
    assert ttr.ckpt.all_steps() == [2]


def test_trainer_without_a_directory_checkpoints_into_a_fresh_one(tmp_path, monkeypatch):
    """No ``ckpt_dir``: each trainer writes to a new directory of its own
    under the temp dir, so a run never resumes another run's state."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    arch = get_arch("fm", smoke=True)
    a = Trainer(arch, TrainerConfig(total_steps=2, ckpt_interval=1, log_interval=1),
                device="cpu")
    a.fit(_fm_data(arch.step("train_batch")), state=a.init_state(0))
    assert a.ckpt.all_steps() == [1, 2]
    b = Trainer(arch, TrainerConfig(), device="cpu")
    assert a.cfg.ckpt_dir != b.cfg.ckpt_dir and b.ckpt.latest_step() is None
    for d in (a.cfg.ckpt_dir, b.cfg.ckpt_dir):
        assert os.path.dirname(d) == str(tmp_path)
    assert int(b.resume_or_init(0)[1]["step"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gradients_match_reference_vjp(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    g = rng.normal(size=(4, 5, 16)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    out_j, vjp = jax.vjp(j_rms_norm, jx, jnp.asarray(scale))
    dx_j, ds_j = vjp(jnp.asarray(g, dtype))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    out_t = L.rms_norm(tx, ts)
    dx_t, ds_t = torch.autograd.grad(out_t, (tx, ts), torch.from_numpy(g).to(tdt))
    assert out_t.dtype == dx_t.dtype == tdt and ds_t.dtype == torch.float32
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    if dtype == "float32":
        np.testing.assert_allclose(out_t.detach().numpy(), f32(out_j), **TOL)
        np.testing.assert_allclose(dx_t.numpy(), f32(dx_j), **TOL)
    else:
        # bf16 outputs and cotangents: the same fp32 math rounded once, so
        # equal or one bf16 ulp apart (2^-7 relative)
        for a, b in ((out_t.detach().float().numpy(), f32(out_j)),
                     (dx_t.float().numpy(), f32(dx_j))):
            assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-6)
    np.testing.assert_allclose(ds_t.numpy(), f32(ds_j), rtol=1e-5, atol=1e-5)


def _mind_batches(arch, n):
    return [_np_batch(arch, 32, seed=100 + i) for i in range(n)]


def test_trainer_fit_six_steps_matches_reference(tmp_path):
    """MIND smoke, one converted state, the same seeded batches (the port's
    carrying the reference's negatives): loss history, final params and the
    optimizer's step."""
    ja, jstate, ta, tstate = _pair("mind")
    batches = _mind_batches(ta, 6)
    pairs = [_both(ta, b) for b in batches]
    jtr = JTrainer(ja, JTrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "j"),
                                      ckpt_interval=3, log_interval=1))
    j_state, j_hist = jtr.fit(iter(p[0] for p in pairs), state=jstate)
    ttr = Trainer(ta, TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "t"),
                                    ckpt_interval=3, log_interval=1), device="cpu")
    t_state, t_hist = ttr.fit(iter(p[1] for p in pairs), state=tstate)
    assert [s for s, _ in t_hist] == [s for s, _ in j_hist] == list(range(1, 7))
    np.testing.assert_allclose([m["loss"] for _, m in t_hist],
                               [m["loss"] for _, m in j_hist], rtol=1e-4)
    _assert_tree(params_to_numpy(t_state.params),
                 jax.tree.map(np.asarray, j_state.params), "mind", rtol=1e-4, atol=1e-5)
    assert int(t_state.opt.step) == int(np.asarray(j_state.opt.step)) == 6
    assert ttr.ckpt.all_steps() == [3, 6]


def _fm_data(spec):
    while True:
        yield dummy_batch(spec.input_specs, device="cpu")


def test_trainer_runs_resumes_and_rolls_back(tmp_path):
    arch = get_arch("fm", smoke=True)
    spec = arch.step("train_batch")
    cfg = TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_interval=3,
                        log_interval=2)
    tr = Trainer(arch, cfg, device="cpu")
    state, hist = tr.fit(_fm_data(spec))
    assert tr.ckpt.latest_step() == 6
    assert hist and np.isfinite(hist[-1][1]["loss"])
    # resume continues from the checkpoint
    tr2 = Trainer(arch, TrainerConfig(total_steps=8, ckpt_dir=str(tmp_path),
                                      ckpt_interval=4, log_interval=2), device="cpu")
    state2, _ = tr2.fit(_fm_data(spec))
    assert int(state2.opt.step) == 8


class _Faults:
    """Raise on the next ``n`` calls of a function, then call through."""

    def __init__(self, fn, n):
        self.fn, self.n, self.calls = fn, n, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.n > 0:
            self.n -= 1
            raise RuntimeError("injected fault")
        return self.fn(*a, **kw)


def _fm_pair(tmp_path, tag):
    arch = get_arch("fm", smoke=True)
    return arch, Trainer(arch, TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path / tag),
                                             ckpt_interval=2, log_interval=1,
                                             max_retries=2), device="cpu")


@pytest.mark.parametrize("where", ["loss", "apply", "apply_half_way"])
def test_trainer_retries_a_failed_step_from_live_state(tmp_path, monkeypatch, where):
    """A step that fails up to ``max_retries`` times is re-run from the
    live state and ends where an unfaulted run does, bit for bit; a
    failure half way through ``apply`` (after some leaves' updates) leaves
    the live state whole."""
    arch, clean = _fm_pair(tmp_path, "clean")
    spec = arch.step("train_batch")
    want, _ = clean.fit(_fm_data(spec), state=clean.init_state(0))
    arch, tr = _fm_pair(tmp_path, "faulty")
    state0 = tr.init_state(0)
    snap = [t.clone() for t in t_opt.leaves(state0.params)]
    if where == "loss":
        monkeypatch.setattr(arch, "loss", _Faults(arch.loss, 2))
    elif where == "apply":
        monkeypatch.setattr(t_opt, "apply", _Faults(t_opt.apply, 2))
    else:
        real_map, seen = t_opt.tree_map, []

        def half_way(fn, *trees):
            out = real_map(fn, *trees)
            seen.append(1)
            if len(seen) in (3, 4):   # the first step's nu update, then its retry's clip
                raise RuntimeError("injected fault half way")
            return out

        monkeypatch.setattr(t_opt, "tree_map", half_way)
    got, hist = tr.fit(_fm_data(spec), state=state0)
    assert all(torch.equal(a, b) for a, b in zip(snap, t_opt.leaves(state0.params)))
    assert int(got.opt.step) == 4 and [s for s, _ in hist] == [1, 2, 3, 4]
    for a, b in zip(t_opt.leaves(got.params), t_opt.leaves(want.params)):
        assert torch.equal(a, b)


def test_trainer_rolls_back_past_max_retries_or_reraises(tmp_path, monkeypatch):
    arch, tr = _fm_pair(tmp_path, "rb")
    spec = arch.step("train_batch")
    # no checkpoint yet: the third failure re-raises
    monkeypatch.setattr(t_opt, "apply", _Faults(t_opt.apply, 3))
    with pytest.raises(RuntimeError, match="injected fault"):
        tr.fit(_fm_data(spec), state=tr.init_state(0))
    monkeypatch.undo()
    # with a checkpoint at step 2: step 3 fails 3 times, the trainer rolls
    # back to step 2 and goes on to 4
    arch, tr = _fm_pair(tmp_path, "rb2")
    real, calls = t_opt.apply, []

    def faulty(*a, **kw):
        calls.append(int(a[3].step))
        if int(a[3].step) == 2 and calls.count(2) <= 3:
            raise RuntimeError("injected fault at step 3")
        return real(*a, **kw)

    monkeypatch.setattr(t_opt, "apply", faulty)
    state, hist = tr.fit(_fm_data(spec), state=tr.init_state(0))
    assert calls.count(2) == 4 and int(state.opt.step) == 4
    assert [s for s, _ in hist] == [1, 2, 3, 4]


def test_adafactor_train_state_checkpoint_round_trip(tmp_path):
    """Adafactor's ``mu`` is None (no leaf saved, none restored) and its
    factored ``nu`` leaves are (row, col) tuples; the file loads without
    pickles."""
    arch = get_arch("fm", smoke=True)
    arch.optimizer = t_opt.OptimizerConfig(kind="adafactor", factored_min_dim=8)
    state = arch.init_train_state(0, "cpu")
    batch = dummy_batch(arch.step("train_batch").input_specs, device="cpu")
    state, _ = arch.make_train_step()(state, batch)
    assert state.opt.mu is None and isinstance(state.opt.nu["v"], tuple)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    files = np.load(tmp_path / "step_000000000001" / "arrays.npz")   # no pickles
    assert not any(".mu" in k for k in files.files) and len(files.files) == 8
    back, meta = mgr.restore(arch.abstract_train_state("cpu"))
    assert meta["step"] == 1 and back.opt.mu is None
    assert isinstance(back.opt.nu["v"], tuple) and isinstance(back, TrainState)
    flat_b, flat_s = ckpt_lib.flatten_tree(back), ckpt_lib.flatten_tree(state)
    assert sorted(flat_b) == sorted(flat_s) and len(flat_s) == 8
    for k in flat_s:
        assert torch.equal(flat_b[k], flat_s[k]), k


def test_mind_train_step_goes_through_the_bag_dispatch():
    """On the CPU the MIND train step runs the plain bag forward and its
    plain backward once each, and the plain gather backward once per row
    gather."""
    _, _, ta, tstate = _pair("mind")
    _, tb = _both(ta, _np_batch(ta, 8, seed=1))
    f, b, g = (COUNTS[n].plain for n in ("bag", "bag_backward", "gather_backward"))
    ta.step("train_batch").fn(tstate, tb)
    # the gathers' backward: history, target (twice) and the negatives
    assert (COUNTS["bag"].plain - f, COUNTS["bag_backward"].plain - b,
            COUNTS["gather_backward"].plain - g) == (1, 1, 4)


def test_loss_draws_from_the_batch_key_where_it_carries_none():
    """Without ``negatives`` / ``mask_u`` the losses draw from a generator
    seeded from ``batch['rng']``: the same key gives the same loss, and
    another key another."""
    for name in ("mind", "bert4rec"):
        ta = get_arch(name, smoke=True)
        p = params_from_numpy(params_to_numpy(ta.init(0, "cpu")))
        b = {k: torch.from_numpy(v) for k, v in _np_batch(ta, 8, seed=2).items()}
        l1, l2 = ta.loss(p, b)[0], ta.loss(p, dict(b))[0]
        other = dict(b, rng=torch.tensor([9, 9], dtype=torch.uint32))
        assert l1.item() == l2.item() and ta.loss(p, other)[0].item() != l1.item()
