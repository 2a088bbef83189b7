"""The port's int8 quantization and ring store against the JAX reference.

Tolerance: none where the input is the same fp32 tensor. Quantization and
the ring scatter have no reduction order to differ in, so int8 rows,
scales and every ring leaf written from given rows are bit-identical.
Where the store normalizes rows itself, the norm's sum differs in the last
ulp between frameworks; ``_assert_self_normalized`` states what that
allows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.store import docstore as jdoc, quant as jquant
from repro_torch.store import docstore as tdoc, quant as tquant

from _torch_parity import assert_trees, jax_tree


@pytest.mark.parametrize("dim", [-1, None])
def test_quantize_int8_bit_exact(dim):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 48)).astype(np.float32)
    x[3] = 0.0                                  # all-zero row: tiny scale
    x[5, :8] = np.float32(0.5) * x[5, 0]        # repeated values
    jq, js = jquant.quantize_int8(jnp.asarray(x), axis=dim)
    tq, ts = tquant.quantize_int8(torch.from_numpy(x), dim=dim)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    s = ts[:, None] if dim == -1 else ts
    np.testing.assert_array_equal(tquant.dequantize_int8(tq, s).numpy(),
                                  np.asarray(jquant.dequantize_int8(
                                      jq, js[:, None] if dim == -1 else js)))


def test_quantize_round_half_to_even():
    # 127 * 0.5/127 -> exact halves after the divide: both round to even
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    jq, _ = jquant.quantize_int8(jnp.asarray(x), axis=-1)
    tq, _ = tquant.quantize_int8(torch.from_numpy(x), dim=-1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("pre_quantized", [False, True])
def test_add_batch_ring_state_matches(store_dtype, pre_quantized):
    """A seeded sequence of ring writes, including more than ``depth``
    admits of one cluster in one batch (only the last ``depth`` survive)
    and wraparound, leaves identical state leaf for leaf."""
    k, depth, d, B = 6, 4, 16, 24
    jcfg = jdoc.StoreConfig(num_clusters=k, depth=depth, dim=d,
                            store_dtype=store_dtype)
    tcfg = tdoc.StoreConfig(num_clusters=k, depth=depth, dim=d,
                            store_dtype=store_dtype)
    js, ts = jdoc.init(jcfg), tdoc.init(tcfg, "cpu")
    rng = np.random.default_rng(1)
    rows_by_id = {}
    for step in range(6):
        x = rng.normal(size=(B, d)).astype(np.float32)
        labels = rng.integers(0, k, size=B).astype(np.int32)
        if step == 2:
            labels[:9] = 3                       # 9 > depth admits of one cluster
        admit = rng.random(B) < 0.7
        ids = np.arange(step * B, (step + 1) * B, dtype=np.int32)
        rows_by_id.update(zip(ids.tolist(), x))
        stamps = ids + 1000
        kw_j, kw_t = {}, {}
        if pre_quantized:
            xn = jnp.asarray(x) / jnp.maximum(
                jnp.linalg.norm(jnp.asarray(x), axis=1, keepdims=True), 1e-12)
            if store_dtype == "int8":
                v, s = jquant.quantize_int8(xn, axis=-1)
            else:
                v, s = xn, jnp.ones((B,), jnp.float32)
            kw_j = dict(v=v, vscale=s)
            kw_t = dict(v=torch.from_numpy(np.array(v)),
                        vscale=torch.from_numpy(np.array(s)))
        js = jdoc.add_batch(jcfg, js, jnp.asarray(x), jnp.asarray(labels),
                            jnp.asarray(admit), jnp.asarray(ids),
                            jnp.asarray(stamps), **kw_j)
        ts = tdoc.add_batch(tcfg, ts, torch.from_numpy(x),
                            torch.from_numpy(labels), torch.from_numpy(admit),
                            torch.from_numpy(ids), torch.from_numpy(stamps),
                            **kw_t)
        ref, got = jax_tree(js), {n: v.numpy() for n, v in zip(ts._fields, ts)}
        if pre_quantized:   # a pure scatter of the same rows: bit-exact
            assert_trees(ref, got, rtol=0, atol=0)
        else:
            _assert_self_normalized(ref, got, store_dtype, rows_by_id)
    assert int(tdoc.size(ts)) == int(jdoc.size(js))


def _assert_self_normalized(ref, got, store_dtype, rows_by_id):
    """Rows the store normalizes itself: the norm's sum runs in another
    order in each framework, so unit rows and scales may differ in the
    last ulp (rtol 1e-6), and an int8 value may round the other way —
    by exactly one, and only where v/scale sits within 1e-4 of a
    half-integer. Ids, stamps and write pointers are exact."""
    for name in ("ids", "stamps", "ptr"):
        np.testing.assert_array_equal(got[name], ref[name])
    np.testing.assert_allclose(got["scales"], ref["scales"], rtol=1e-6)
    if store_dtype == "fp32":
        np.testing.assert_allclose(got["embs"], ref["embs"], rtol=1e-6,
                                   atol=1e-7)
        return
    diff = got["embs"].astype(np.int32) - ref["embs"].astype(np.int32)
    assert np.abs(diff).max(initial=0) <= 1
    for c, s in zip(*np.nonzero(np.any(diff != 0, axis=-1))):
        x = rows_by_id[int(ref["ids"][c, s])].astype(np.float64)
        z = x / np.linalg.norm(x) / ref["scales"][c, s]
        off = diff[c, s] != 0
        assert np.all(np.abs(z - np.floor(z) - 0.5)[off] < 1e-4), (c, s)
