"""The port's recsys serving path (``repro_torch/models/recsys.py``)
against the JAX reference at each arch's smoke config: the reference's
params cross with ``convert.params_from_numpy``, the same seeded numpy
batch goes through both packages, and ``user_vectors``, ``score`` and
``retrieve`` are compared.

Tolerance: floats within rtol 1e-5 / atol 1e-6 (the packages sum in
other orders; capsule routing, attention and the GRU scans are not
bit-equal); retrieved ids exact, except where the reference's own scores
hold a near-tie (neighbours within 1e-5) at that position. Then every
serve/retrieval smoke cell of ``step()`` runs finite and shaped as the
reference's, and each arch's train cell is a train ``StepSpec`` with the
reference's input shapes (``test_torch_train.py`` holds the step itself).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.api import get_arch as j_get_arch
from repro.models.testing import dummy_batch as j_dummy_batch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.counts import COUNTS
from repro_torch.models.api import get_arch, list_archs
from repro_torch.models.testing import assert_finite, dummy_batch

TOL = dict(rtol=1e-5, atol=1e-6)
TIE = 1e-5
ARCHS = ["mind", "bert4rec", "dien", "fm"]


def _pair(name):
    ja, ta = j_get_arch(name, smoke=True), get_arch(name, smoke=True)
    jp = ja.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return ja, jp, ta, tp


def _batch(arch, B, seed=0):
    """A seeded numpy batch: item ids uniform over the vocabulary, a valid
    prefix of length uniform in [1, S] (padding at id 0)."""
    rng = np.random.default_rng(seed)
    if arch.name.startswith("fm"):
        return {"fields": rng.integers(0, arch.cfg.rows_per_field,
                                       (B, arch.cfg.n_fields)).astype(np.int32)}
    S, n = arch.hist_len, arch.cfg.n_items
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, B)[:, None]
    hist = np.where(mask, rng.integers(0, n, (B, S)), 0).astype(np.int32)
    return {"hist": hist, "hist_mask": mask,
            "target": rng.integers(0, n, B).astype(np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _hold_ids(ids_t, ids_j, scores_j):
    """Ids equal, except where the reference's score at that position ties
    a neighbour's within TIE."""
    s = np.asarray(scores_j)
    near = np.zeros(s.shape, bool)
    gap = np.abs(np.diff(s, axis=-1)) < TIE
    near[..., 1:] |= gap
    near[..., :-1] |= gap
    differ = np.asarray(ids_t) != np.asarray(ids_j)
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)


def test_params_cross_both_ways():
    _, jp, _, tp = _pair("bert4rec")
    back = params_to_numpy(tp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    # the stacked blocks keep their leading layer axis
    assert tp["blocks"]["wq"].shape[0] == 1


@pytest.mark.parametrize("name", ["mind", "bert4rec", "dien"])
def test_user_vectors_and_score_match_reference(name):
    ja, jp, ta, tp = _pair(name)
    jb, tb = _both(_batch(ta, 16, seed=len(name)))
    np.testing.assert_allclose(ta.user_vectors(tp, tb).numpy(),
                               np.asarray(ja.user_vectors(jp, jb)), **TOL)
    np.testing.assert_allclose(ta.score(tp, tb).numpy(),
                               np.asarray(ja.score(jp, jb)), **TOL)


def test_fm_score_matches_reference():
    ja, jp, ta, tp = _pair("fm")
    jb, tb = _both(_batch(ta, 16))
    np.testing.assert_allclose(ta.score(tp, tb).numpy(),
                               np.asarray(ja.score(jp, jb)), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_retrieve_matches_reference(name):
    """Top-100 over the smoke vocabulary. MIND's answer is the top k of the
    I*k interest winners, duplicates kept, as the reference returns it."""
    ja, jp, ta, tp = _pair(name)
    jb, tb = _both(_batch(ta, 1, seed=11))
    before = COUNTS["mips"].plain
    s_t, i_t = ta.retrieve(tp, tb)
    assert COUNTS["mips"].plain == before + 1
    s_j, i_j = ja.retrieve(jp, jb)
    assert s_t.shape == s_j.shape == (1, 100) and i_t.dtype == torch.int32
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    _hold_ids(i_t.numpy(), i_j, s_j)


def test_mind_profile_goes_through_the_bag_dispatch():
    _, _, ta, tp = _pair("mind")
    _, tb = _both(_batch(ta, 4))
    before = COUNTS["bag"].plain
    ta.user_vectors(tp, tb)
    assert COUNTS["bag"].plain == before + 1


def test_mind_profile_takes_the_sorted_bag_entry(monkeypatch):
    """MIND's profile bag goes through ``embedding_bag_sorted`` (its segment
    ids are arange(B) repeated S times: non-decreasing by construction, so
    the card skips the sort), with exactly those segments."""
    from repro_torch.models import recsys

    _, _, ta, tp = _pair("mind")
    _, tb = _both(_batch(ta, 4))
    seen = []
    real = recsys.embedding_bag_sorted

    def spy(table, idx, seg, num_bags, w, mode):
        seen.append((seg.clone(), num_bags, mode))
        return real(table, idx, seg, num_bags, w, mode)

    monkeypatch.setattr(recsys, "embedding_bag_sorted", spy)
    ta.user_vectors(tp, tb)
    (seg, B, mode), = seen
    S = tb["hist"].shape[1]
    assert mode == "mean" and B == 4
    assert torch.equal(seg, torch.arange(B, dtype=seg.dtype).repeat_interleave(S))


CELLS = [(n, s) for n in ARCHS for s in ("serve_p99", "serve_bulk", "retrieval_cand")]


@pytest.mark.parametrize("name,shape", CELLS)
def test_step_cells_finite_and_shaped(name, shape):
    ja, jp, ta, tp = _pair(name)
    jspec, tspec = ja.step(shape), ta.step(shape)
    assert tspec.kind == jspec.kind == "serve"
    assert {k: (tuple(v.shape)) for k, v in tspec.input_specs.items()} == \
        {k: tuple(v.shape) for k, v in jspec.input_specs.items()}
    out_t = tspec.fn(tp, dummy_batch(tspec.input_specs, device="cpu"))
    out_j = jspec.fn(jp, j_dummy_batch(jspec.input_specs))
    assert_finite(out_t, f"{name}/{shape}")
    shapes_t = [tuple(o.shape) for o in (out_t if isinstance(out_t, tuple) else (out_t,))]
    shapes_j = [tuple(o.shape) for o in (out_j if isinstance(out_j, tuple) else (out_j,))]
    assert shapes_t == shapes_j


def test_registry_and_train_cells():
    assert list_archs() == sorted(ARCHS)
    for name in ARCHS:
        spec = get_arch(name, smoke=True).step("train_batch")
        jspec = j_get_arch(name, smoke=True).step("train_batch")
        assert spec.kind == jspec.kind == "train" and callable(spec.fn)
        assert {k: tuple(v.shape) for k, v in spec.input_specs.items()} == \
            {k: tuple(v.shape) for k, v in jspec.input_specs.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("qwen2-1.5b")
