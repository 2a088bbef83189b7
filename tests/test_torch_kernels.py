"""The plain PyTorch versions of the port's three kernels (admit, serve,
mips) against the JAX reference's ``ref.py`` AND its Pallas kernels run in
interpret mode on the CPU, on the same numpy inputs.

Tolerances: floats within rtol 1e-5 / atol 1e-6 (the frameworks sum dot
products in other orders); decisions — keep, labels, ids, pos, routes —
exact: the inputs here carry no near-ties except the built-in exact ones
(duplicated centroids, index rows and ring entries), where both sides
must pick the lowest index. int8 rows are exact, except an element may
round the other way by one where v/scale lies within 1e-4 of a
half-integer (the row norms are summed in another order). On the card
the same functions are held against the CUDA kernels by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.admit.admit import admit_pallas
from repro.kernels.admit.ref import admit_ref as j_admit
from repro.kernels.mips.mips import mips_topk_pallas
from repro.kernels.mips.ref import mips_topk_ref as j_mips
from repro.kernels.serve.ref import serve_topk_ref as j_serve
from repro.kernels.serve.serve import serve_topk_pallas
from repro_torch.kernels.admit import ops as admit_ops
from repro_torch.kernels.admit.ref import admit_ref as t_admit
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.mips import ops as mips_ops
from repro_torch.kernels.mips.ref import mips_topk_ref as t_mips
from repro_torch.kernels.serve import ops as serve_ops
from repro_torch.kernels.serve.ref import serve_topk_ref as t_serve

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_int8_rows(got, ref, x):
    diff = got.astype(np.int32) - np.asarray(ref).astype(np.int32)
    assert np.abs(diff).max(initial=0) <= 1
    x64 = x.astype(np.float64)
    v = x64 / np.maximum(np.linalg.norm(x64, axis=1, keepdims=True), 1e-12)
    z = v / np.maximum(np.abs(v).max(axis=1, keepdims=True), 1e-12) * 127.0
    assert np.all(np.abs(z - np.floor(z) - 0.5)[diff != 0] < 1e-4)


# ------------------------------------------------------------------- admit
def _admit_inputs(B=40, K=24, d=48, n=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    basis = rng.normal(size=(n, d)).astype(np.float32)
    cent = rng.normal(size=(K, d)).astype(np.float32)
    cent[7] = cent[3]                 # exact tie: label 3 must win over 7
    x[:4] = 2.0 * cent[3]             # rows whose best centroids are 3 and 7
    live = np.ones(B, bool)
    live[-6:] = False                 # dead padding rows, zeroed
    x[-6:] = 0.0
    return x, basis, cent, live


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("normalize", [True, False])
def test_admit_plain_matches_reference_and_pallas(store_dtype, normalize):
    x, basis, cent, live = _admit_inputs()
    alpha = 0.02
    kw = dict(store_dtype=store_dtype, normalize=normalize)
    got = t_admit(_t(x), _t(basis), _t(cent), alpha, _t(live), **kw)
    jargs = (jnp.asarray(x), jnp.asarray(basis), jnp.asarray(cent), alpha,
             jnp.asarray(live))
    for ref in (j_admit(*jargs, **kw), admit_pallas(*jargs, **kw)):
        r, keep, lab, sim, v, s = (np.asarray(a) for a in ref)
        np.testing.assert_allclose(got[0].numpy(), r, **TOL)
        np.testing.assert_array_equal(got[1].numpy(), keep)
        np.testing.assert_array_equal(got[2].numpy(), lab)
        np.testing.assert_allclose(got[3].numpy(), sim, **TOL)
        np.testing.assert_allclose(got[5].numpy(), s, **TOL)
        if store_dtype == "int8":
            _assert_int8_rows(got[4].numpy(), v, x if normalize else
                              x / np.maximum(np.linalg.norm(x, axis=1,
                                                            keepdims=True), 1e-12))
        else:
            np.testing.assert_allclose(got[4].numpy(), v, **TOL)
    lab = got[2].numpy()
    assert np.all(lab[:4] == 3)                       # tie to the lowest index
    assert np.all(got[0].numpy()[-6:] == 0) and np.all(lab[-6:] == 0)
    assert not got[1].numpy()[-6:].any()              # dead rows never kept


def test_admit_without_rows_and_dispatch_counts_plain_calls():
    x, basis, cent, live = _admit_inputs(seed=1)
    before = COUNTS["admit"].plain
    out = admit_ops.admit(_t(x), _t(basis), _t(cent), 0.0, None,
                          emit_rows=False)
    assert out[4] is None and out[5] is None
    ref = j_admit(jnp.asarray(x), jnp.asarray(basis), jnp.asarray(cent), 0.0,
                  emit_rows=False)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert COUNTS["admit"].plain == before + 1


# -------------------------------------------------------------------- mips
@pytest.mark.parametrize("Q,N,d,k", [(7, 300, 32, 10), (3, 40, 64, 20),
                                     (1, 2100, 32, 5)])
def test_mips_plain_matches_reference_and_pallas(Q, N, d, k):
    rng = np.random.default_rng(N)
    index = rng.normal(size=(N, d)).astype(np.float32)
    index[N // 2] = index[1]               # exact tie: row 1 ranks first
    q = rng.normal(size=(Q, d)).astype(np.float32)
    q[0] = index[1]
    valid = rng.random(N) >= 0.2
    valid[1] = valid[N // 2] = True
    s, i = t_mips(_t(q), _t(index), _t(valid), k)
    jargs = (jnp.asarray(q), jnp.asarray(index), jnp.asarray(valid), k)
    for rs, ri in (j_mips(*jargs), mips_topk_pallas(*jargs)):
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i[0, 0] == 1 and i[0, 1] == N // 2
    live = s.numpy() > -1e29
    assert np.all(valid[i.numpy()[live]])


def test_mips_fewer_valid_rows_than_k():
    """Invalid rows tie at NEG_INF and fill the tail lowest index first."""
    rng = np.random.default_rng(3)
    index = rng.normal(size=(12, 16)).astype(np.float32)
    valid = np.zeros(12, bool)
    valid[[4, 9]] = True
    q = rng.normal(size=(2, 16)).astype(np.float32)
    s, i = mips_ops.mips_topk(_t(q), _t(index), _t(valid), 6)
    rs, ri = j_mips(jnp.asarray(q), jnp.asarray(index), jnp.asarray(valid), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    assert i[:, 2:].tolist() == [[0, 1, 2, 3]] * 2


# ------------------------------------------------------------------- serve
def _serve_inputs(Q, d, cap, C, D, quantized, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(cap, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    valid = rng.random(cap) >= 0.2
    labels = rng.integers(0, C, cap).astype(np.int32)
    labels[rng.random(cap) < 0.15] = -1          # dead routes
    q = rng.normal(size=(Q, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    live = rng.random((C, D)) < 0.8
    if quantized:
        embs = rng.integers(-127, 128, (C, D, d)).astype(np.int8)
        scales = (rng.random((C, D)) * 0.02 + 1e-4).astype(np.float32)
        scales[:, 1] = scales[:, 0]
    else:
        embs = rng.normal(size=(C, D, d)).astype(np.float32)
        scales = None
    embs[:, 1] = embs[:, 0]                      # exact ties inside each ring
    live[:, 0] = live[:, 1] = True
    live[1] = False                              # an empty ring
    return q, v, valid, labels, embs, live, scales


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("depth", [None, 3])
def test_serve_plain_matches_reference_and_pallas(quantized, depth):
    Q, d, cap, C, D, k, P = 9, 32, 40, 12, 6, 5, 4
    q, v, valid, labels, embs, live, scales = _serve_inputs(
        Q, d, cap, C, D, quantized, seed=11 + quantized)
    te, tl = _t(embs), _t(live)
    ts = None if scales is None else _t(scales)
    je, jl, js = embs, live, scales
    if depth is not None:
        # the port reads a view of the full store; the reference a slice
        te, tl = te[:, :depth], tl[:, :depth]
        ts = None if ts is None else ts[:, :depth]
        je, jl = embs[:, :depth], live[:, :depth]
        js = None if js is None else scales[:, :depth]
        assert not te.is_contiguous()
    got = t_serve(_t(q), _t(q), _t(v), _t(valid), _t(labels), te, tl, k, P, ts)
    jargs = (jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
             jnp.asarray(valid), jnp.asarray(labels), jnp.asarray(je),
             jnp.asarray(jl), k, P, None if js is None else jnp.asarray(js))
    for ref in (j_serve(*jargs), serve_topk_pallas(*jargs)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    routes = got[2].numpy()
    assert (routes == -1).any(), "the inputs must exercise dead routes"
    pos = got[1].numpy()
    # a ring's slot-0 and slot-1 entries tie exactly: slot 0 ranks first
    Dv = D if depth is None else depth
    for qi, ti in zip(*np.nonzero((pos >= 0) & (pos % Dv == 1))):
        assert (pos[qi] == pos[qi, ti] - 1).any()


def test_serve_dispatcher_all_dead_routes():
    """An index with no valid slot routes nowhere: every pos and route -1."""
    q, v, valid, labels, embs, live, scales = _serve_inputs(
        3, 16, 10, 4, 4, True, seed=5)
    valid[:] = False
    s, pos, routes = serve_ops.serve_topk(
        _t(q), _t(q), _t(v), _t(valid), _t(labels), _t(embs), _t(live), 3, 2,
        scales=_t(scales))
    assert (pos == -1).all() and (routes == -1).all()
    ref = j_serve(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
                  jnp.asarray(valid), jnp.asarray(labels), jnp.asarray(embs),
                  jnp.asarray(live), 3, 2, jnp.asarray(scales))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref[0]), **TOL)


def test_dispatchers_refuse_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        mips_ops.mips_topk(x, x, torch.ones(2, dtype=torch.bool, device="meta"), 1)
