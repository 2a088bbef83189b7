"""The ``Trainer`` on a mesh of CPU devices against the ``Trainer`` without
one, at the recsys archs' smoke configs.

A mesh places the train state by its specs and a step gathers it, runs
the step without a mesh and places the new state back, so every check
here is bit for bit (``torch.equal`` on every leaf): the state after N
steps, the loss history, the elastic restores (a checkpoint written
without a mesh onto a mesh, and back), the rollback past ``max_retries``
onto the mesh, gradient accumulation on it and a batch placed by
``shard_batch``. Each piece of the state has the shape its spec implies.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models.api import get_arch
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}


def _batch(arch, B, seed):
    """A seeded train batch: ids uniform over the vocabulary, a valid
    prefix of length uniform in [1, S], labels in {0, 1}, a key."""
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(0, 2, B).astype(np.float32))
    if arch.name.startswith("fm"):
        fields = rng.integers(0, arch.cfg.rows_per_field, (B, arch.cfg.n_fields))
        return {"fields": torch.from_numpy(fields.astype(np.int32)), "labels": labels}
    S_, n = arch.hist_len, arch.cfg.n_items
    mask = np.arange(S_)[None, :] < rng.integers(1, S_ + 1, B)[:, None]
    hist = np.where(mask, rng.integers(0, n, (B, S_)), 0).astype(np.int32)
    return {"hist": torch.from_numpy(hist), "hist_mask": torch.from_numpy(mask),
            "target": torch.from_numpy(rng.integers(0, n, B).astype(np.int32)),
            "labels": labels, "rng": torch.tensor([seed, 7 * seed + 1], dtype=torch.uint32)}


def _data(arch, start=0):
    i = start
    while True:
        yield _batch(arch, 32, 100 + i)
        i += 1


def _trainer(arch, tmp_path, tag, mesh=None, **kw):
    cfg = dict(total_steps=4, ckpt_dir=str(tmp_path / tag), ckpt_interval=2, log_interval=1)
    cfg.update(kw)
    m = None if mesh is None else make_debug_mesh(*MESHES[mesh], devices="cpu")
    return Trainer(arch, TrainerConfig(**cfg), mesh=m, device="cpu")


def _leaves(tree) -> list:
    out = []
    S.tree_map(out.append, tree)
    return out


def _assert_equal(got, want):
    a, b = _leaves(S.unshard(got, "cpu")), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(x, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)


def _assert_placed(tr, state):
    """Every leaf a ``Sharded`` whose pieces have its spec's shapes."""
    sizes = dict(zip(tr.mesh.axis_names, tr.mesh.shape))

    def check(x, sh):
        assert isinstance(x, S.Sharded) and x.sharding.spec == sh.spec
        want = tuple(n // int(np.prod([sizes[a] for a in sh.spec.mesh_axes(d)]))
                     for d, n in enumerate(x.shape))
        assert all(tuple(p.shape) == want for p in x.pieces.ravel())
        return x

    S.tree_map(check, state, tr.state_shardings)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ["fm", "mind"])
def test_mesh_trainer_state_equals_the_trainer_without_a_mesh(tmp_path, name, mesh):
    arch = get_arch(name, smoke=True)
    plain = _trainer(arch, tmp_path, "plain")
    want, want_hist = plain.fit(_data(arch), state=plain.init_state(0))
    tr = _trainer(arch, tmp_path, "mesh", mesh)
    state0 = tr.init_state(0)
    _assert_placed(tr, state0)
    got, hist = tr.fit(_data(arch), state=state0)
    _assert_placed(tr, got)
    _assert_equal(got, want)
    assert [m["loss"] for _, m in hist] == [m["loss"] for _, m in want_hist]
    assert int(S.gather(got.opt.step, "cpu")) == 4


def test_mind_item_table_splits_over_model_and_replicates_over_data(tmp_path):
    arch = get_arch("mind", smoke=True)
    tr = _trainer(arch, tmp_path, "m", "2x2")
    state = tr.init_state(0)
    emb = state.params["item_emb"]
    assert emb.spec == S.P("model")
    n = arch.cfg.n_items
    for d, m in np.ndindex(2, 2):
        assert emb.pieces[d, m].shape == (n // 2, arch.cfg.embed_dim)
        assert torch.equal(emb.pieces[d, m], emb.pieces[0, m])
    assert state.params["bilinear"].spec == S.P()


def test_elastic_restore_without_a_mesh_onto_a_mesh_and_back(tmp_path):
    """A checkpoint written without a mesh resumes on a mesh and ends where
    the run without a mesh ends; one written on the mesh resumes without."""
    arch = get_arch("mind", smoke=True)
    want, _ = _trainer(arch, tmp_path, "ref", total_steps=6).fit(_data(arch), state=None)
    # 4 steps without a mesh (checkpoints at 2 and 4), then 2 more on a mesh
    _trainer(arch, tmp_path, "a").fit(_data(arch), state=None)
    tr = _trainer(arch, tmp_path, "a", "2x2", total_steps=6)
    state, meta = tr.resume_or_init()
    assert meta["step"] == 4
    _assert_placed(tr, state)
    got, _ = tr.fit(_data(arch, start=4), state=state, start_step=4)
    _assert_equal(got, want)
    # 4 steps on a mesh, then 2 more without one
    _trainer(arch, tmp_path, "b", "2x1x2").fit(_data(arch), state=None)
    tr = _trainer(arch, tmp_path, "b", total_steps=6)
    state, meta = tr.resume_or_init()
    assert meta["step"] == 4 and isinstance(state.params["item_emb"], torch.Tensor)
    got, _ = tr.fit(_data(arch, start=4), state=state, start_step=4)
    _assert_equal(got, want)


def test_rollback_past_max_retries_restores_onto_the_mesh(tmp_path, monkeypatch):
    """Step 3 fails three times: the trainer rolls back to the checkpoint
    at step 2, on the mesh, and goes on to 4, equal to an unfaulted run."""
    arch = get_arch("fm", smoke=True)
    want, _ = _trainer(arch, tmp_path, "clean").fit(_data(arch), state=None)
    tr = _trainer(arch, tmp_path, "faulty", "2x2", max_retries=2)
    real, calls, restored = t_opt.apply, [], []

    def faulty(*a, **kw):
        calls.append(int(a[3].step))
        if int(a[3].step) == 2 and calls.count(2) <= 3:
            raise RuntimeError("injected fault at step 3")
        return real(*a, **kw)

    real_restore = tr.ckpt.restore

    def spy(*a, **kw):
        out = real_restore(*a, **kw)
        restored.append(out[0])
        return out

    monkeypatch.setattr(t_opt, "apply", faulty)
    monkeypatch.setattr(tr.ckpt, "restore", spy)
    # after the rollback the failed step's batch is taken again
    got, hist = tr.fit(_data(arch), state=tr.init_state(0))
    assert calls.count(2) == 4 and [s for s, _ in hist] == [1, 2, 3, 4]
    assert len(restored) == 1
    _assert_placed(tr, restored[0])
    _assert_equal(got, want)


def test_grad_accum_on_a_mesh_equals_it_without(tmp_path):
    arch = get_arch("fm", smoke=True)

    def data():
        i = 0
        while True:
            a, b = _batch(arch, 16, 200 + i), _batch(arch, 16, 300 + i)
            yield {k: torch.stack([a[k], b[k]]) for k in a}
            i += 1

    want, _ = _trainer(arch, tmp_path, "p", grad_accum=2).fit(data(), state=None)
    got, _ = _trainer(arch, tmp_path, "m", "2x2", grad_accum=2).fit(data(), state=None)
    _assert_equal(got, want)


def test_a_sharded_batch_trains_as_the_whole_batch(tmp_path):
    arch = get_arch("fm", smoke=True)
    want, _ = _trainer(arch, tmp_path, "p").fit(_data(arch), state=None)
    tr = _trainer(arch, tmp_path, "m", "2x2")
    got, _ = tr.fit((shard_batch(b, tr.mesh) for b in _data(arch)), state=None)
    _assert_equal(got, want)


def test_a_mesh_of_another_device_type_is_refused():
    """A CUDA mesh never runs its step on the CPU, nor a CPU mesh on a card."""
    arch = get_arch("fm", smoke=True)
    cuda = np.empty((2, 2), dtype=object)
    for ix in np.ndindex(2, 2):
        cuda[ix] = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="share a device type"):
        Trainer(arch, TrainerConfig(), mesh=Mesh(cuda), device="cpu")
