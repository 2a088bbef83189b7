"""The plain PyTorch EmbeddingBag (``repro_torch/kernels/bag/ref.py``)
against the JAX reference's ``embedding_bag_pallas`` run in interpret
mode on the CPU and its ``embedding_bag_ref``, on the same numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-6 for every case, bf16 tables included:
both packages widen the bf16 rows to f32 exactly and sum in f32, only in
another order. On the card the same plain version is held against the
CUDA kernel by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bag.bag import embedding_bag_pallas
from repro.kernels.bag.ref import embedding_bag_ref as j_bag
from repro_torch.kernels.bag import ops as bag_ops
from repro_torch.kernels.bag.ref import embedding_bag_ref as t_bag
from repro_torch.kernels.counts import COUNTS

TOL = dict(rtol=1e-5, atol=1e-6)


def _tables(rng, V, d, bf16):
    """The same table for both packages: f32 numpy, rounded to bf16 by each
    (both round to nearest even, so the values agree exactly)."""
    a = rng.normal(size=(V, d)).astype(np.float32)
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("V,d,L,bags", [(50, 16, 64, 10), (200, 32, 31, 7),
                                        (10, 8, 128, 128)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_bag_matches_reference_kernel_and_oracle(V, d, L, bags, mode, bf16):
    rng = np.random.default_rng(V * 1000 + L)
    tj, tt = _tables(rng, V, d, bf16)
    idx = rng.integers(0, V, L).astype(np.int32)
    seg = np.sort(rng.integers(0, bags, L)).astype(np.int32)
    w = rng.random(L).astype(np.float32)
    before = COUNTS["bag"].plain
    got = t_bag(tt, torch.from_numpy(idx), torch.from_numpy(seg), bags,
                torch.from_numpy(w), mode)
    assert COUNTS["bag"].plain == before + 1
    assert got.dtype == torch.float32 and got.shape == (bags, d)
    want_k = np.asarray(embedding_bag_pallas(tj, jnp.asarray(idx), jnp.asarray(seg),
                                             bags, jnp.asarray(w), mode))
    want_r = np.asarray(j_bag(tj, jnp.asarray(idx), jnp.asarray(seg), bags,
                              jnp.asarray(w), mode))
    np.testing.assert_allclose(got.numpy(), want_k, **TOL)
    np.testing.assert_allclose(got.numpy(), want_r, **TOL)


def test_unsorted_segments_and_empty_bags():
    rng = np.random.default_rng(7)
    tj, tt = _tables(rng, 20, 8, False)
    idx = rng.integers(0, 20, 40).astype(np.int32)
    seg = rng.integers(0, 5, 40).astype(np.int32)            # unsorted
    for mode in ("sum", "mean"):
        got = bag_ops.embedding_bag(tt, torch.from_numpy(idx), torch.from_numpy(seg),
                                    8, None, mode).numpy()     # bags 5..7 empty
        want = np.asarray(embedding_bag_pallas(tj, jnp.asarray(idx),
                                               jnp.asarray(seg), 8, None, mode))
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, np.asarray(j_bag(
            tj, jnp.asarray(idx), jnp.asarray(seg), 8, None, mode)), **TOL)
        assert np.all(got[5:] == 0.0)


def test_mind_layout_means_over_the_whole_history():
    """MIND's profile bag: all B*S entries, masked ones at row 0 with weight
    0, mean mode. The mean divides by S (the entry count), not by the
    number of valid entries (the weights' sum)."""
    rng = np.random.default_rng(3)
    V, d, B, S = 300, 16, 6, 9
    tj, tt = _tables(rng, V, d, False)
    hist = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, B)[:, None]
    idx = np.where(mask, hist, 0).reshape(-1)
    seg = np.repeat(np.arange(B, dtype=np.int32), S)
    w = mask.astype(np.float32).reshape(-1)
    got = bag_ops.embedding_bag(tt, torch.from_numpy(idx), torch.from_numpy(seg), B,
                                torch.from_numpy(w), "mean").numpy()
    want = np.asarray(embedding_bag_pallas(tj, jnp.asarray(idx), jnp.asarray(seg), B,
                                           jnp.asarray(w), "mean"))
    np.testing.assert_allclose(got, want, **TOL)
    table = np.asarray(tj)
    by_s = np.stack([table[hist[b][mask[b]]].sum(0) / S for b in range(B)])
    np.testing.assert_allclose(got, by_s, **TOL)
    by_valid = np.stack([table[hist[b][mask[b]]].mean(0) for b in range(B)])
    partial = ~mask.all(1)
    assert partial.any()
    assert not np.allclose(got[partial], by_valid[partial], **TOL)


def test_dispatch_runs_plain_on_cpu_and_raises_elsewhere():
    t = torch.randn(4, 3)
    i = torch.tensor([0, 3], dtype=torch.int32)
    s = torch.tensor([1, 1], dtype=torch.int32)
    before = (COUNTS["bag"].kernel, COUNTS["bag"].plain)
    out = bag_ops.embedding_bag(t, i, s, 2)
    assert (COUNTS["bag"].kernel, COUNTS["bag"].plain) == (before[0], before[1] + 1)
    np.testing.assert_allclose(out[1].numpy(), (t[0] + t[3]).numpy(), **TOL)
    with pytest.raises(ValueError, match="device meta"):
        bag_ops.embedding_bag(t.to("meta"), i.to("meta"), s.to("meta"), 2)
    with pytest.raises(ValueError, match="mode"):
        bag_ops.embedding_bag(t, i, s, 2, mode="max")
