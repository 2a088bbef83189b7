"""The plain PyTorch versions of the staged path's three kernels (rerank,
prefilter, assign) against the JAX reference's ``ref.py`` AND its Pallas
kernels run in interpret mode on the CPU, on the same numpy inputs, at
the shapes and edge cases of the reference's own kernel tests.

Tolerances: decisions (labels, pos) exact; floats within rtol 1e-5 with
atol 1e-4 (prefilter, rerank) or 1e-5 (assign), as the reference's tests
compare its kernels with its oracles (the Pallas kernels normalize with
an rsqrt, the oracles and the plain versions with a divide). On the card
the same plain versions are held against the CUDA kernels by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.assign.assign import assign_pallas
from repro.kernels.assign.ref import assign_ref as j_assign
from repro.kernels.common import normalize_basis_rows as j_normalize_basis_rows
from repro.kernels.prefilter.prefilter import prefilter_scores_pallas
from repro.kernels.prefilter.ref import prefilter_scores_ref as j_prefilter
from repro.kernels.rerank.ref import rerank_topk_ref as j_rerank
from repro.kernels.rerank.rerank import rerank_topk_pallas
from repro_torch.kernels.admit.ref import admit_ref
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.assign.ref import assign_ref as t_assign
from repro_torch.kernels.common import normalize_basis_rows
from repro_torch.kernels.counts import COUNTS, snapshot
from repro_torch.kernels.prefilter import ops as prefilter_ops
from repro_torch.kernels.prefilter.ref import prefilter_scores_ref as t_prefilter
from repro_torch.kernels.rerank import ops as rerank_ops
from repro_torch.kernels.rerank.ref import rerank_topk_ref as t_rerank
from repro_torch.kernels.serve.ref import serve_topk_ref

RERANK_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------ assign
@pytest.mark.parametrize("B,K,d", [(64, 32, 48), (300, 150, 96), (17, 5, 256),
                                   (1, 700, 64)])
def test_assign_plain_matches_reference_and_pallas(B, K, d):
    rng = np.random.default_rng(B * K)
    x, c = _normal(rng, (B, d)), _normal(rng, (K, d))
    i_t, s_t = t_assign(_t(x), _t(c))
    for i_r, s_r in (j_assign(jnp.asarray(x), jnp.asarray(c)),
                     assign_pallas(jnp.asarray(x), jnp.asarray(c))):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-5,
                                   atol=1e-5)
    assert i_t.dtype == torch.int32 and s_t.dtype == torch.float32


def test_assign_ties_go_to_the_lowest_centroid():
    """A centroid repeated at a higher index (and at another scale, which
    cosine ignores) never takes a row from its first copy."""
    rng = np.random.default_rng(2)
    c = _normal(rng, (40, 32))
    c[31] = 2.0 * c[6]
    x = _normal(rng, (9, 32))
    x[:5] = c[6] + 0.01 * _normal(rng, (5, 32))
    i_t, _ = t_assign(_t(x), _t(c))
    for i_r, _ in (j_assign(jnp.asarray(x), jnp.asarray(c)),
                   assign_pallas(jnp.asarray(x), jnp.asarray(c))):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    assert (i_t.numpy()[:5] == 6).all()


# --------------------------------------------------------------- prefilter
@pytest.mark.parametrize("B,n,d", [(64, 5, 48), (513, 1, 96), (40, 16, 384)])
def test_prefilter_plain_matches_reference_and_pallas(B, n, d):
    rng = np.random.default_rng(B + n)
    x, v = _normal(rng, (B, d)), _normal(rng, (n, d))
    r_t = t_prefilter(_t(x), _t(v))
    for r_r in (j_prefilter(jnp.asarray(x), jnp.asarray(v)),
                prefilter_scores_pallas(jnp.asarray(x), jnp.asarray(v))):
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_r), rtol=1e-5,
                                   atol=1e-4)
    r, keep = prefilter_ops.prefilter(_t(x), _t(v), 0.05)
    np.testing.assert_array_equal(r.numpy(), r_t.numpy())
    np.testing.assert_array_equal(keep.numpy(), r_t.numpy() >= 0.05)


def test_prefilter_zero_basis_row_and_scale_invariance():
    """An all-zero basis row adds exactly 0 (the mean still divides by the
    true n) on the plain version and on the Pallas kernel; scaling the
    basis by a power of two (exact in fp32) leaves the plain scores
    bit-identical; and the kernel contract's ``normalize_basis_rows``
    keeps zero rows zero, as the reference's does."""
    rng = np.random.default_rng(7)
    x, v = _normal(rng, (96, 64)), _normal(rng, (5, 64))
    r1 = t_prefilter(_t(x), _t(v))
    np.testing.assert_array_equal(t_prefilter(_t(x), _t(4.0 * v)).numpy(),
                                  r1.numpy())
    vz = v.copy()
    vz[2] = 0.0
    r_t = t_prefilter(_t(x), _t(vz))
    assert torch.isfinite(r_t).all()
    for r_r in (j_prefilter(jnp.asarray(x), jnp.asarray(vz)),
                prefilter_scores_pallas(jnp.asarray(x), jnp.asarray(vz))):
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_r), rtol=1e-5,
                                   atol=1e-6)
    # four of the five rows count, over a divisor of five
    four = t_prefilter(_t(x), _t(np.delete(vz, 2, axis=0)))
    np.testing.assert_allclose(r_t.numpy(), four.numpy() * 4 / 5, rtol=1e-5,
                               atol=1e-7)
    vn = normalize_basis_rows(_t(vz))
    assert (vn[2] == 0).all()
    np.testing.assert_allclose(vn.numpy(),
                               np.asarray(j_normalize_basis_rows(jnp.asarray(vz))),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(torch.linalg.norm(vn[[0, 1, 3, 4]], dim=1).numpy(),
                               1.0, rtol=1e-6)


# ------------------------------------------------------------------ rerank
def _rerank_both(q, embs, live, routes, k, scales=None, views=None):
    """Port plain version (on ``views`` of the arrays when given) vs the
    reference oracle and Pallas kernel on contiguous copies."""
    tv = views or (_t(embs), _t(live), None if scales is None else _t(scales))
    got = t_rerank(_t(q), tv[0], tv[1], _t(routes), k, tv[2])
    jargs = (jnp.asarray(q), jnp.asarray(embs), jnp.asarray(live),
             jnp.asarray(routes), k, None if scales is None else jnp.asarray(scales))
    for sc_r, id_r in (j_rerank(*jargs), rerank_topk_pallas(*jargs)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(sc_r), **RERANK_TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(id_r))
    return got


@pytest.mark.parametrize("Q,C,depth,P,k,live_frac",
                         [(4, 10, 8, 3, 5, 0.7),    # generic masked rows
                          (2, 6, 5, 4, 12, 0.5),    # odd depth
                          (7, 20, 16, 6, 10, 0.9),
                          (1, 3, 4, 2, 8, 0.25),    # k > live members
                          (3, 5, 8, 2, 1, 0.0)])    # nothing live at all
def test_rerank_plain_matches_reference_and_pallas(Q, C, depth, P, k, live_frac):
    rng = np.random.default_rng(Q * 100 + C)
    q, embs = _normal(rng, (Q, 32)), _normal(rng, (C, depth, 32))
    live = rng.random((C, depth)) < live_frac
    routes = rng.integers(-1, C, (Q, P)).astype(np.int32)
    s, pos = _rerank_both(q, embs, live, routes, k)
    assert pos.dtype == torch.int32
    assert (s.numpy()[pos.numpy() < 0] < -1e29).all()
    if live_frac == 0.0:
        assert (pos == -1).all()


def test_rerank_duplicate_routes_are_scored_twice_lowest_pos_first():
    """Identical candidates tie exactly and resolve to the lowest
    position; a route listed twice is scored at both of its positions."""
    C, depth, d = 4, 4, 8
    embs = np.zeros((C, depth, d), np.float32)
    embs[:, :, 0] = 1.0
    q = np.ones((2, d), np.float32)
    live = np.ones((C, depth), bool)
    routes = np.asarray([[0, 1], [2, 2]], np.int32)
    _, pos = _rerank_both(q, embs, live, routes, 5)
    np.testing.assert_array_equal(pos.numpy(), [[0, 1, 2, 3, 4]] * 2)
    _, pos = _rerank_both(q, embs, live, routes, 8)
    assert sorted(pos.numpy()[1].tolist()) == list(range(8))


def test_rerank_k_exceeds_live_members():
    """With fewer live docs than k, the tail is (NEG_INF, -1) and every
    live routed doc surfaces exactly once."""
    rng = np.random.default_rng(4)
    C, depth, d = 3, 4, 16
    embs = _normal(rng, (C, depth, d))
    live = np.zeros((C, depth), bool)
    live[0, 1] = live[2, 3] = True
    q = _normal(rng, (2, d))
    routes = np.asarray([[0, 2], [2, 0]], np.int32)
    s, pos = _rerank_both(q, embs, live, routes, 6)
    assert ((pos.numpy() >= 0).sum(axis=1) == 2).all()
    assert (s.numpy()[:, 2:] < -1e29).all() and (pos.numpy()[:, 2:] == -1).all()


@pytest.mark.parametrize("depth", [None, 5])
def test_rerank_int8_with_scales_and_depth_clipped_view(depth):
    """int8 rings score (q . e) * scale; a depth-clipped view of the full
    rings (as ``stages.slice_rings`` hands it over, never copied) equals
    the reference on a sliced copy, with pos encoded at the clipped
    depth."""
    rng = np.random.default_rng(9)
    Q, C, D, P, d = 6, 12, 8, 4, 32
    embs = rng.integers(-127, 128, (C, D, d)).astype(np.int8)
    scales = (rng.random((C, D)) * 0.02 + 1e-4).astype(np.float32)
    embs[:, 1], scales[:, 1] = embs[:, 0], scales[:, 0]   # exact ties
    live = rng.random((C, D)) < 0.8
    live[:, :2] = True
    q = _normal(rng, (Q, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    routes = rng.integers(-1, C, (Q, P)).astype(np.int32)
    routes[0, 1] = routes[0, 0] = 3                       # a duplicate route
    views = None
    if depth is not None:
        te, tl, ts = _t(embs), _t(live), _t(scales)
        views = (te[:, :depth], tl[:, :depth], ts[:, :depth])
        assert not views[0].is_contiguous()
        embs, live, scales = embs[:, :depth], live[:, :depth], scales[:, :depth]
    Dv = D if depth is None else depth
    s, pos = _rerank_both(q, embs, live, routes, 7, scales, views)
    p = pos.numpy()
    assert p.max() < P * Dv
    for qi, ti in zip(*np.nonzero((p >= 0) & (p % Dv == 1))):
        assert (p[qi] == p[qi, ti] - 1).any()             # slot 0 ranks first


# ---------------------------------------------------------------- dispatch
def test_dispatchers_count_plain_calls_and_refuse_other_devices():
    x = torch.randn(3, 8)
    before = snapshot()
    prefilter_ops.prefilter_scores(x, torch.randn(2, 8))
    assign_ops.assign(x, torch.randn(4, 8))
    rerank_ops.rerank_topk(x, torch.randn(4, 2, 8), torch.ones(4, 2, dtype=torch.bool),
                           torch.zeros(3, 2, dtype=torch.int32), 2)
    after = snapshot()
    for name in ("prefilter", "assign", "rerank"):
        assert after[name]["plain"] == before[name]["plain"] + 1
        assert after[name]["kernel"] == before[name]["kernel"]
    m = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        prefilter_ops.prefilter_scores(m, m)
    with pytest.raises(ValueError):
        assign_ops.assign(m, m)
    with pytest.raises(ValueError):
        rerank_ops.rerank_topk(m, torch.zeros((2, 1, 4), device="meta"),
                               torch.ones((2, 1), dtype=torch.bool, device="meta"),
                               torch.zeros((2, 1), dtype=torch.int32, device="meta"), 1)


def test_fused_plain_versions_do_not_count_as_staged_calls():
    """admit's and serve's plain versions reuse the staged bodies, but a
    call of theirs counts only as itself."""
    rng = np.random.default_rng(1)
    x, basis, cent = _t(_normal(rng, (6, 16))), _t(_normal(rng, (3, 16))), _t(_normal(rng, (5, 16)))
    before = snapshot()
    admit_ref(x, basis, cent, 0.0, store_dtype="int8")
    embs = torch.randn(5, 4, 16)
    serve_topk_ref(x, x, cent, torch.ones(5, dtype=torch.bool),
                   torch.arange(5, dtype=torch.int32), embs,
                   torch.ones(5, 4, dtype=torch.bool), 3, 2)
    after = snapshot()
    for name in ("prefilter", "assign", "rerank"):
        assert after[name] == before[name], name
    assert COUNTS["admit"].plain == before["admit"]["plain"] + 1
    assert COUNTS["serve"].plain == before["serve"]["plain"] + 1
