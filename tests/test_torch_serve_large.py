"""Serving past one block's shared memory: the two-stage query at the
4 GB budget's cap (112,501 prototypes) and nprobe 16, where the card's
serve kernel cuts each query's route keys by reduction passes before it
selects (``kernels/serve/serve.py::serve_plan``'s levels).

On the CPU: the port's two-stage query and its route-only entry (their
plain versions, through the dispatchers) against the JAX package's
``serve_topk_ref`` on the same numpy inputs, at that cap with a small ring
store; and the passes' arithmetic emulated in numpy over keys.cuh's key
order (larger score, then lower slot) at the plans' own sizes — 64-column
route tiles keeping their ``kt`` largest keys in order, each pass merging
32 such lists into one of nprobe, the selection — against the direct
top-nprobe, with exact ties placed in other route tiles and other merge
groups. The kernel itself is held
against the plain versions on the card (``test_torch_kernels_gpu.py``,
``chip_smoke.py`` 3d).

Tolerances as in ``test_torch_kernels.py``: scores within rtol 1e-5 /
atol 1e-6; routes, positions and ids exact: the inputs hold no near-tie
among a query's top nprobe + 1 route scores but the exact ones they
build in (asserted).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ring_ids
from repro.kernels.serve.ref import serve_topk_ref as j_serve
from repro_torch.kernels.common import NEG_INF, rowwise_dots
from repro_torch.kernels.serve import ops as serve_ops
from repro_torch.kernels.serve.serve import MERGE_WAYS, ROUTE_TILE_COLS, serve_plan

TOL = dict(rtol=1e-5, atol=1e-6)
CAP, NPROBE = 112_501, 16          # budget_to_config(4000.0)'s cap; the tables' nprobe


def _twins(cap):
    """Slot pairs made exact copies: other route tiles and merge groups
    (a group holds 32 tiles' lists), and two neighbours."""
    return (5, cap * 5 // 8), (64, 65), (1000, cap - 1)


def _inputs(Q, d, cap, C, depth, quantized, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(cap, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    valid = rng.random(cap) >= 0.1
    labels = rng.integers(0, C, cap).astype(np.int32)
    labels[rng.random(cap) < 0.1] = -1            # dead routes
    for a, b in _twins(cap):
        v[b], valid[a], valid[b], labels[a], labels[b] = v[a], True, True, a % C, b % C
    q = rng.normal(size=(Q, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for i, (a, _) in enumerate(_twins(cap)[:Q]):
        q[i] = v[a]                                # a query whose best two tie exactly
    live = rng.random((C, depth)) < 0.7
    if quantized:
        embs = rng.integers(-127, 128, (C, depth, d)).astype(np.int8)
        scales = (rng.random((C, depth)) * 0.02 + 1e-4).astype(np.float32)
    else:
        embs = rng.normal(size=(C, depth, d)).astype(np.float32)
        scales = None
    return q, v, valid, labels, embs, live, scales


def _route_scores(q, v, valid):
    s = rowwise_dots(torch.from_numpy(q), torch.from_numpy(v))
    return torch.where(torch.from_numpy(valid)[None], s, NEG_INF).numpy()


def _no_near_ties(S, P):
    top = -np.sort(-S, axis=1)[:, :P + 1]
    gaps = top[:, :-1] - top[:, 1:]
    assert ((gaps == 0) | (gaps > 1e-5)).all(), "a near-tie among the top route scores"


@pytest.mark.parametrize("quantized", [True, False])
def test_two_stage_query_at_the_4gb_cap_matches_reference(quantized):
    Q, d, C, depth, k = 8, 32, 48, 8, 10
    q, v, valid, labels, embs, live, scales = _inputs(Q, d, CAP, C, depth, quantized, seed=3)
    _no_near_ties(_route_scores(q, v, valid), NPROBE)
    t = [torch.from_numpy(a) for a in (q, v, valid, labels, embs, ring_ids(live))]
    ts = None if scales is None else torch.from_numpy(scales)
    s, pos, routes = serve_ops.serve_topk(t[0], t[0], t[1], t[2], t[3], t[4], t[5], k, NPROBE,
                                          scales=ts)[:3]
    ref = j_serve(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid),
                  jnp.asarray(labels), jnp.asarray(embs), jnp.asarray(live), k, NPROBE,
                  None if scales is None else jnp.asarray(scales))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(routes.numpy(), np.asarray(ref[2]))
    only = serve_ops.serve_routes(t[0], t[1], t[2], t[3], NPROBE)
    np.testing.assert_array_equal(only.numpy(), np.asarray(ref[2]))
    for i, (a, b) in enumerate(_twins(CAP)):     # the tied pair, lowest slot first
        assert routes[i, :2].tolist() == [a % C, b % C]
    assert (routes == -1).any(), "the inputs must exercise dead routes"
    # the card's plan at the main path's width takes one pass here
    assert serve_plan(64, CAP, NPROBE, 64, 384, 10).levels == (880,)


def _keys(S):
    """keys.cuh's composite keys of scores S [Q, n]: ordered score bits,
    then 0xFFFFFFFF - slot, as uint64 (0 pads: below every real key)."""
    b = (S + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    ordered = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    slots = np.arange(S.shape[1], dtype=np.uint64)
    return (ordered << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - slots)


def _top_in_groups(keys, size, keep):
    """Each run of ``size`` keys (0-padded) cut to its ``keep`` largest,
    in order, concatenated: [Q, ceil(n / size) * keep]."""
    Q, n = keys.shape
    g = -(-n // size)
    padded = np.zeros((Q, g * size), np.uint64)
    padded[:, :n] = keys
    top = np.sort(padded.reshape(Q, g, size), axis=2)[:, :, ::-1][:, :, :keep]
    return top.reshape(Q, g * keep)


@pytest.mark.parametrize("nprobe,cap,Q", [(16, CAP, 4), (8, 450_007, 2), (64, 54_844, 2),
                                          (32, 225_003, 2), (64, 1_687_526, 1)])
def test_reduction_passes_keep_the_direct_selection(nprobe, cap, Q):
    """The route tiles' per-tile top-kt, then each of the plan's merge
    passes, then the selection give the direct top-nprobe of all the keys, exact
    ties included, for the fused plan (d 384, int8 depth 64, k 10) and the
    route-only entry's; their routes equal the plain version's."""
    d, C = 8, 97
    q, v, valid, labels, _, _, _ = _inputs(Q, d, cap, C, 1, False, seed=nprobe)
    S = _route_scores(q, v, valid)
    keys = _keys(S)
    want = np.sort(keys, axis=1)[:, ::-1][:, :nprobe]
    routes_plain = serve_ops.serve_routes(*(torch.from_numpy(a) for a in (q, v, valid, labels)),
                                          nprobe).numpy()
    plans = (serve_plan(64, cap, nprobe, 64, 384, 10), serve_plan(64, cap, nprobe, 1))
    assert any(p.levels for p in plans)
    for plan in plans:
        part = _top_in_groups(keys, ROUTE_TILE_COLS, plan.kt)
        assert part.shape[1] == plan.m
        length = plan.kt
        for n in plan.levels:   # a merge of 32 sorted lists: the top-nprobe of their union
            part = _top_in_groups(part, MERGE_WAYS * length, nprobe)
            length = nprobe
            assert part.shape[1] == n
        got = np.sort(part, axis=1)[:, ::-1][:, :nprobe]
        np.testing.assert_array_equal(got, want)
        slots = (np.uint64(0xFFFFFFFF) - (got & np.uint64(0xFFFFFFFF))).astype(np.int64)
        score = np.take_along_axis(S, slots, axis=1)
        lab = labels[slots]
        routes = np.where((score > NEG_INF / 2) & (lab >= 0), lab, -1)
        np.testing.assert_array_equal(routes, routes_plain)
