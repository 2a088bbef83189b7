"""The port's IVF-PQ index (``repro_torch.core.index``: ``ivfpq_train``,
``ivfpq_add``, ``ivfpq_search``) against the JAX package's on the CPU,
and the reference's own IVF-PQ invariants run on the port.

Training takes the reference's draws (``_torch_parity.ivfpq_train_draws``:
its coarse k-means++ rows and codeword choices). Tolerances: codes,
cells, ids, validity, the ring pointer and every returned row exact;
centroids, codebooks and scores within rtol 1e-5 / atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as JI
from repro_torch.core import index as TI
from repro_torch.kernels.common import l2_normalize

from _torch_parity import assert_trees, ivfpq_train_draws, jax_tree
from repro_torch import convert


def _cfgs(**kw):
    return JI.IVFPQConfig(**kw), TI.IVFPQConfig(**kw)


def _trained(jc, tc, base, seed=0):
    key = jax.random.key(seed)
    ji = JI.ivfpq_train(jc, key, jnp.asarray(base))
    draws = ivfpq_train_draws(key, base, jc.nlist, jc.m, jc.nbits)
    ti = TI.ivfpq_train(tc, torch.Generator().manual_seed(seed),
                        torch.from_numpy(base), draws)
    assert_trees(jax_tree(ji), convert.state_to_numpy(ti))
    return ji, ti


def _assert_search(jout, tout):
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=1e-5, atol=1e-6)
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("nprobe,m", [(2, 4), (8, 8), (1, 2)])
def test_ivfpq_matches_reference(nprobe, m):
    """Train on 160 rows, add five batches of 40 into a ring of 128 (it
    wraps), search 16 queries after each add at k = 10."""
    jc, tc = _cfgs(capacity=128, dim=32, nlist=8, m=m, nprobe=nprobe)
    rng = np.random.default_rng(nprobe)
    base = rng.normal(size=(160, 32)).astype(np.float32)
    ji, ti = _trained(jc, tc, base)
    for step in range(5):
        x = rng.normal(size=(40, 32)).astype(np.float32)
        ids = (step * 40 + np.arange(40)).astype(np.int32)
        ji = JI.ivfpq_add(jc, ji, jnp.asarray(x), jnp.asarray(ids))
        ti = TI.ivfpq_add(tc, ti, torch.from_numpy(x), torch.from_numpy(ids))
        assert_trees(jax_tree(ji), convert.state_to_numpy(ti), path=f"step {step}: ")
        q = rng.normal(size=(16, 32)).astype(np.float32)
        _assert_search(JI.ivfpq_search(jc, ji, jnp.asarray(q), 10),
                       TI.ivfpq_search(tc, ti, torch.from_numpy(q), 10))


def test_ivfpq_half_filled_matches_reference_tombstones():
    """Half the ring added: the never-added rows (cell -1) score NEG_INF in
    both packages, and k past the probed rows returns the same dead rows."""
    jc, tc = _cfgs(capacity=256, dim=32, nlist=8, m=4, nprobe=2)
    rng = np.random.default_rng(3)
    base = rng.normal(size=(256, 32)).astype(np.float32)
    ji, ti = _trained(jc, tc, base)
    ji = JI.ivfpq_add(jc, ji, jnp.asarray(base[:128]), jnp.arange(128, dtype=jnp.int32))
    ti = TI.ivfpq_add(tc, ti, torch.from_numpy(base[:128]), torch.arange(128))
    q = rng.normal(size=(16, 32)).astype(np.float32)
    for k in (10, 200):
        _assert_search(JI.ivfpq_search(jc, ji, jnp.asarray(q), k),
                       TI.ivfpq_search(tc, ti, torch.from_numpy(q), k))


def test_ivfpq_beats_random_guessing():
    """The reference's invariant on the port, its own draws: self-retrieval
    recall@10 of at least 60%."""
    cfg = TI.IVFPQConfig(capacity=512, dim=32, nlist=8, m=4, nprobe=4)
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.normal(size=(512, 32)).astype(np.float32))
    idx = TI.ivfpq_train(cfg, torch.Generator().manual_seed(0), base)
    idx = TI.ivfpq_add(cfg, idx, base, torch.arange(512))
    _, _, ids = TI.ivfpq_search(cfg, idx, base[:32], 10)
    hits = sum(i in set(ids[i].tolist()) for i in range(32))
    assert hits >= 20


def test_ivfpq_search_respects_nprobe_and_tombstones():
    """The reference's invariant on the port: rows outside the probed
    coarse cells, and rows never validly added, never surface."""
    cfg = TI.IVFPQConfig(capacity=256, dim=32, nlist=8, m=4, nprobe=2)
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    idx = TI.ivfpq_train(cfg, torch.Generator().manual_seed(0), base)
    idx = TI.ivfpq_add(cfg, idx, base[:128], torch.arange(128))
    assert int(idx.valid.sum()) == 128 and idx.write_ptr == 128
    q = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    scores, rows, ids = (t.numpy() for t in TI.ivfpq_search(cfg, idx, q, 10))
    live = scores > -1e29
    assert (rows[live] < 128).all() and (ids[live] >= 0).all()
    probe = np.argsort(-(l2_normalize(q) @ idx.coarse.T).numpy(), axis=1,
                       kind="stable")[:, :cfg.nprobe]
    cell = idx.cell.numpy()
    for i in range(q.shape[0]):
        assert all(cell[r] in probe[i] for r in rows[i][live[i]])
    cfg1 = dataclasses.replace(cfg, nprobe=1)
    s1, r1, _ = (t.numpy() for t in TI.ivfpq_search(cfg1, idx, q, 10))
    for i in range(q.shape[0]):
        assert (cell[r1[i][s1[i] > -1e29]] == probe[i, 0]).all()


def test_ivfpq_codes_are_uint8_and_add_refuses_an_overrun():
    cfg = TI.IVFPQConfig(capacity=16, dim=8, nlist=2, m=2, nprobe=1)
    base = torch.randn((32, 8), generator=torch.Generator().manual_seed(1))
    idx = TI.ivfpq_train(cfg, torch.Generator().manual_seed(0), base)
    assert idx.codes.dtype == torch.uint8 and idx.codebooks.shape == (2, 256, 4)
    with pytest.raises(ValueError, match="overruns"):
        TI.ivfpq_add(cfg, idx, base, torch.arange(32))
