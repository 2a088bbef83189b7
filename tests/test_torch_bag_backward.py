"""The gradient of the port's EmbeddingBag on the CPU (``ops.embedding_bag``
and ``ops.embedding_bag_sorted`` as autograd nodes, whose backward there
is ``ref.embedding_bag_backward_ref``) against ``jax.grad`` of the
reference's ``embedding_bag_ref`` (the reference cannot differentiate its
Pallas kernel), on the same numpy inputs: ``d_table`` and ``d_w``, sum and
mean, weights None and given, empty bags, unsorted segments, int64 ids
and a bf16 table; and ``embedding_bag_backward_ref`` against PyTorch's own
autograd of ``embedding_bag_ref``; and ``ops.gather_rows`` (``table[ids]``,
whose backward is ``gather_backward``) against ``jax.grad`` of the
reference's ``table[ids]``; and the kernel wrapper's host-side plan
(``bag.backward_plan``: the sort's digit passes and the scratch regions
from V and L). The kernels themselves are held against their plain
versions on the card (``test_torch_kernels_gpu.py``).

Tolerance: rtol 1e-5 / atol 1e-6 in f32 (sums in another order). A bf16
table's gradient is bf16 in both packages, but the reference rounds each
entry's term to bf16 and sums in bf16 (the transpose of its f32 cast
comes before the scatter), where the port sums in f32 and rounds once:
held to one bf16 ulp per term the row sums, against the f32 gradient of
the same bf16 table rounded once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bag.ref import embedding_bag_ref as j_bag
from repro_torch.kernels.bag import bag as bag_kernel
from repro_torch.kernels.bag import ops as bag_ops
from repro_torch.kernels.bag.ref import (embedding_bag_backward_ref, embedding_bag_ref,
                                         gather_backward_ref)
from repro_torch.kernels.counts import COUNTS

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, V, d, L, bags, sorted_segments, with_empty):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, L).astype(np.int32)
    hi = bags - 3 if with_empty else bags       # the last bags get no entry
    seg = rng.integers(0, hi, L).astype(np.int32)
    if sorted_segments:
        seg = np.sort(seg)
    w = rng.random(L).astype(np.float32)
    g = rng.normal(size=(bags, d)).astype(np.float32)
    return table, idx, seg, w, g


def _jax_grads(table, idx, seg, bags, w, mode, g, dtype=jnp.float32):
    def f(t, ww):
        return jnp.sum(j_bag(t, jnp.asarray(idx), jnp.asarray(seg), bags, ww, mode)
                       * jnp.asarray(g))

    t = jnp.asarray(table, dtype)
    if w is None:
        return jax.grad(lambda tt: f(tt, None))(t), None
    return jax.grad(f, argnums=(0, 1))(t, jnp.asarray(w))


def _port_grads(table, idx, seg, bags, w, mode, g, is_sorted, w_grad, dtype=torch.float32,
                idx_dtype=torch.int32):
    t = torch.from_numpy(table).to(dtype).requires_grad_(True)
    ww = None if w is None else torch.from_numpy(w).requires_grad_(w_grad)
    fn = bag_ops.embedding_bag_sorted if is_sorted else bag_ops.embedding_bag
    out = fn(t, torch.from_numpy(idx).to(idx_dtype), torch.from_numpy(seg).to(idx_dtype),
             bags, ww, mode)
    before = COUNTS["bag_backward"].plain
    leaves = [t] + ([ww] if ww is not None and w_grad else [])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert COUNTS["bag_backward"].plain == before + 1
    return grads[0], (grads[1] if len(grads) > 1 else None)


CASES = [  # V, d, L, bags, sorted segments, empty bags
    (50, 16, 64, 10, True, False),
    (200, 32, 31, 7, False, True),
    (10, 8, 128, 128, True, True),      # many entries on few rows
    (30, 18, 97, 13, False, False),     # DIEN's width
]


@pytest.mark.parametrize("V,d,L,bags,is_sorted,empty", CASES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weights", ["given", "none"])
def test_bag_gradient_matches_jax_grad_of_the_reference(V, d, L, bags, is_sorted, empty,
                                                        mode, weights):
    table, idx, seg, w, g = _case(V * 31 + L, V, d, L, bags, is_sorted, empty)
    w = w if weights == "given" else None
    jt, jw = _jax_grads(table, idx, seg, bags, w, mode, g)
    tt, tw = _port_grads(table, idx, seg, bags, w, mode, g, is_sorted, w is not None)
    assert tt.dtype == torch.float32 and tt.shape == (V, d)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    if w is not None:
        assert tw.dtype == torch.float32 and tw.shape == (L,)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    untouched = np.setdiff1d(np.arange(V), idx)
    assert np.all(tt.numpy()[untouched] == 0)


def test_int64_ids_and_weights_without_grad():
    table, idx, seg, w, g = _case(5, 40, 8, 50, 6, False, True)
    jt, _ = _jax_grads(table, idx, seg, 6, w, "mean", g)
    tt, tw = _port_grads(table, idx, seg, 6, w, "mean", g, False, False,
                         idx_dtype=torch.int64)
    assert tw is None
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table_gradient(mode):
    table, idx, seg, w, g = _case(9, 20, 16, 60, 5, True, False)
    table = np.array(jnp.asarray(table, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    jt, _ = _jax_grads(table, idx, seg, 5, w, mode, g, dtype=jnp.bfloat16)
    j32, _ = _jax_grads(table, idx, seg, 5, w, mode, g)           # f32 sums, same values
    tt, _ = _port_grads(table, idx, seg, 5, w, mode, g, True, False, dtype=torch.bfloat16)
    assert tt.dtype == torch.bfloat16 and jt.dtype == jnp.bfloat16
    got = tt.float().numpy()
    # the port: the f32 sum rounded to bf16 once
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(j32).astype(jnp.bfloat16)
                                                  .astype(jnp.float32)))
    # the reference: each term rounded to bf16, summed in bf16; within one
    # bf16 ulp (2^-7 relative) of each term's magnitude, summed per row
    mag, _ = _jax_grads(np.abs(table), idx, seg, 5, w, mode, np.abs(g))
    assert np.all(np.abs(got - np.asarray(jt, np.float32)) <= 2.0 ** -7 * np.asarray(mag) * 2)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weights", ["given", "none"])
def test_backward_ref_matches_torch_autograd_of_the_forward(mode, weights):
    table, idx, seg, w, g = _case(11, 30, 12, 80, 9, False, True)
    t = torch.from_numpy(table).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True) if weights == "given" else None
    out = embedding_bag_ref(t, torch.from_numpy(idx), torch.from_numpy(seg), 9, ww, mode)
    leaves = [t] + ([ww] if ww is not None else [])
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    d_t, d_w = embedding_bag_backward_ref(
        t.detach(), torch.from_numpy(idx), torch.from_numpy(seg), 9, torch.from_numpy(g),
        None if ww is None else ww.detach(), mode, weights_grad=ww is not None)
    torch.testing.assert_close(d_t, want[0], **TOL)
    if ww is not None:
        torch.testing.assert_close(d_w, want[1], **TOL)
    else:
        assert d_w is None


def test_no_autograd_node_where_nothing_requires_grad():
    """The serving path: no grad required, the forward alone (no backward
    can run)."""
    table, idx, seg, w, _ = _case(2, 10, 4, 12, 3, True, False)
    out = bag_ops.embedding_bag_sorted(torch.from_numpy(table), torch.from_numpy(idx),
                                       torch.from_numpy(seg), 3, torch.from_numpy(w), "mean")
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_gather_rows_gradient_matches_jax_grad_of_take(ids_dtype):
    """Ids [B, S] with many repeats (row 0 as a history batch's padding),
    the gradient dense over the table."""
    rng = np.random.default_rng(4)
    V, d = 30, 12
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = np.where(rng.random((9, 7)) < 0.5, 0, rng.integers(0, V, (9, 7))).astype(np.int32)
    g = rng.normal(size=(9, 7, d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)] * jnp.asarray(g)))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    before = COUNTS["gather_backward"].plain
    rows = bag_ops.gather_rows(t, torch.from_numpy(ids).to(ids_dtype))
    assert torch.equal(rows.detach(), torch.from_numpy(table)[torch.from_numpy(ids).long()])
    got = torch.autograd.grad(rows, t, torch.from_numpy(g))[0]
    assert COUNTS["gather_backward"].plain == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    direct = gather_backward_ref(t.detach(), torch.from_numpy(ids), torch.from_numpy(g))
    assert torch.equal(direct, got)
    # no grad wanted: the plain indexing, no node
    assert bag_ops.gather_rows(t.detach(), torch.from_numpy(ids)).grad_fn is None


@pytest.mark.parametrize("V,widths", [(1, (1,)), (40, (6,)), (10**6, (10, 10)),
                                      (2**22 + 3, (8, 8, 7)), (39 * 10**6, (9, 9, 8))])
@pytest.mark.parametrize("L", [0, 1, 4097, 3_276_800])
def test_backward_plan_digit_passes_and_scratch(V, widths, L):
    """The sort covers a row id's bits (at least one) in as few passes of
    at most 11 bits as it can, split evenly, lowest digit first; each
    scratch region holds what bag_backward.cu's entry point says it
    takes, on a 256-byte boundary, none overlapping."""
    d, bags = 64, 65_536
    plan = bag_kernel.backward_plan(V, L, d, bags, weighted=True, mean=True)
    bits = max(1, (V - 1).bit_length())
    assert plan.widths == widths and sum(widths) == bits and max(widths) <= 11
    assert len(widths) == -(-bits // 11) and max(widths) - min(widths) <= 1
    assert V <= 1 << sum(widths)
    radix, tiles, chunks = 1 << max(widths), -(-L // 4096), -(-L // 256)
    want = {"keys_a": 4 * L, "keys_b": 4 * L, "bags_a": 4 * L, "bags_b": 4 * L,
            "w_a": 4 * L, "w_b": 4 * L, "counts_a": 4 * radix * tiles,
            "counts_b": 4 * radix * tiles if len(widths) > 1 else 0,
            "totals": 4 * radix, "touched": V, "row_start": 4 * V,
            "pieces": 8 * chunks * d, "level2": 4 * (L // (64 * 256)) * d,
            "cnt": 4 * bags, "gs": 4 * bags * d}
    assert dict(plan.regions) == want
    at = plan.offsets()
    ends = sorted((at[name], at[name] + nbytes) for name, nbytes in plan.regions)
    assert all(a % 256 == 0 for a, _ in ends)
    assert all(e <= a2 for (_, e), (a2, _) in zip(ends, ends[1:]))
    assert ends[-1][1] <= plan.scratch_bytes < ends[-1][1] + 256 * len(ends)


def test_backward_plan_without_weights_or_mean_takes_no_payload_or_counts():
    """A gather's transpose (no weights, sum mode) carries no weight
    through the sort and keeps no counts or divided rows."""
    plan = bag_kernel.backward_plan(10**6, 3_276_800, 64, 3_276_800, weighted=False,
                                    mean=False)
    sizes = dict(plan.regions)
    assert sizes["w_a"] == sizes["w_b"] == sizes["cnt"] == sizes["gs"] == 0
    assert plan.widths == (10, 10) and sizes["level2"] == 4 * 200 * 64
