"""The port's staged decomposition of Algorithm 1 — ``screen`` ->
``assign_update`` on ingest, ``route`` -> ``rerank`` on query — against
the JAX reference's ``engine/stages.py`` on state carried over from the
same JAX state, and against the port's own fused composition (``admit``,
``serve_topk``), on the CPU. The staged ingest is
``engine.staged_ingest_impl`` (``ingest_impl`` with admission staged),
the composition ``chip_smoke.py`` drives on the card.

Tolerances: decisions (keep, labels, routes, pos, rows, doc ids, int8
ring rows, counter state) exact; float leaves within rtol 1e-5 / atol
1e-6 against the reference (the frameworks sum in other orders). Staged
against fused inside the port, float leaves agree within 2 ulp (rtol
2.4e-7, atol 1e-7: the reference itself is only that stable, ROADMAP
C0a); here both compose the same plain versions, so they come out equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as jpipe
from repro.engine import stages as jstages
from repro.kernels.common import l2_normalize as j_l2_normalize
from repro_torch import convert
from repro_torch.configs.streaming_rag import paper_pipeline_config as t_config
from repro_torch.core import heavy_hitter
from repro_torch.core import pipeline as tpipe
from repro_torch.engine import stages
from repro_torch.engine.engine import staged_ingest_impl
from repro_torch.kernels.common import l2_normalize
from repro_torch.kernels.counts import snapshot

from _torch_parity import assert_trees, ingest_draws, jax_tree

D, B = 32, 48
KW = dict(dim=D, k=16, capacity=16, store_depth=6, update_interval=100,
          alpha=0.05, admit_prob=0.5)
ULP2 = dict(rtol=2.4e-7, atol=1e-7)


def _configs(store_dtype, basis="fixed"):
    jc = j_config(store_dtype=store_dtype, basis=basis, **KW)
    tc = t_config(store_dtype=store_dtype, basis=basis, **KW)
    if basis == "adaptive":
        # a window the test wraps; no PCA refresh, whose eigenvectors of
        # random rows the two frameworks resolve differently
        jc = dataclasses.replace(jc, pre=dataclasses.replace(jc.pre, window=64))
        tc = dataclasses.replace(tc, pre=dataclasses.replace(tc.pre, window=64))
    return jc, tc


def _batch(rng, step, ragged=True):
    x = rng.normal(size=(B, D)).astype(np.float32)
    ids = np.arange(step * B, (step + 1) * B, dtype=np.int32)
    if ragged and step % 2 == 1:
        ids[-9:] = -1
        x[-9:] = 0.0
    return x, ids


def _ingested(store_dtype, n_batches, seed, basis="fixed"):
    """A JAX state after ``n_batches`` of reference ingest, the configs,
    and the numpy rng to continue the stream with."""
    jc, tc = _configs(store_dtype, basis)
    rng = np.random.default_rng(seed)
    warm = rng.normal(size=(64, D)).astype(np.float32)
    js = jpipe.init(jc, jax.random.key(seed), jnp.asarray(warm))
    for step in range(n_batches):
        x, ids = _batch(rng, step)
        js, _ = jpipe.ingest_batch(jc, js, jnp.asarray(x), jnp.asarray(ids))
    return jc, tc, js, rng


# ------------------------------------------------- stages vs the reference
@pytest.mark.parametrize("basis", ["fixed", "adaptive"])
def test_screen_and_assign_update_match_reference(basis):
    jc, tc, js, rng = _ingested("fp32", 3, seed=0, basis=basis)
    ts = convert.state_from_numpy(jax_tree(js), "cpu")
    for step in range(3, 5):
        x, ids = _batch(rng, step)
        live = ids >= 0
        jpre, jr, jkeep = jstages.screen(jc.pre, js.pre, jnp.asarray(x),
                                         jnp.asarray(live))
        tpre, tr, tkeep = stages.screen(tc.pre, ts.pre, torch.from_numpy(x),
                                        live)
        assert_trees(jax_tree(jpre), convert.state_to_numpy(tpre))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        assert not tkeep.numpy()[~live].any()
        jclus, jlab, jsim = jstages.assign_update(jc.clus, js.clus,
                                                  jnp.asarray(x), jkeep)
        tclus, tlab, tsim = stages.assign_update(tc.clus, ts.clus,
                                                 torch.from_numpy(x), tkeep)
        assert_trees(jax_tree(jclus), convert.state_to_numpy(tclus))
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        np.testing.assert_allclose(tsim.numpy(), np.asarray(jsim), rtol=1e-5,
                                   atol=1e-6)
        js = js._replace(pre=jpre, clus=jclus)
        ts = ts._replace(pre=tpre, clus=tclus)
    if basis == "adaptive":
        assert ts.pre.fill == 64 and ts.pre.write_ptr > 0


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("depth", [None, 3])
def test_route_and_rerank_match_reference(store_dtype, depth):
    jc, tc, js, rng = _ingested(store_dtype, 6, seed=1)
    ts = convert.state_from_numpy(jax_tree(js), "cpu")
    assert int(ts.index.valid.sum()) > 0 and int(ts.store.ids.ge(0).sum()) > 0
    q = rng.normal(size=(9, D)).astype(np.float32)
    jroutes = jstages.route(jc.index, js.index, js.route_labels,
                            jnp.asarray(q), 4)
    troutes = stages.route(tc.index, ts.index, ts.route_labels,
                           torch.from_numpy(q), 4)
    np.testing.assert_array_equal(troutes.numpy(), np.asarray(jroutes))
    assert troutes.dtype == torch.int32 and (troutes.numpy() >= 0).any()
    js_, jp = jstages.rerank(js.store, j_l2_normalize(jnp.asarray(q)),
                             jroutes, 5, False, depth=depth)
    ts_, tp = stages.rerank(ts.store, l2_normalize(torch.from_numpy(q)),
                            troutes, 5, depth=depth)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    dv = tc.store_depth if depth is None else depth
    jdec = jstages.decode_rerank(js.store.ids, jroutes, js_, jp, dv, 4,
                                 store_depth=tc.store_depth)
    tdec = stages.decode_rerank(ts.store.ids, troutes, ts_, tp, dv, 4,
                                store_depth=tc.store_depth)
    for a, b in zip(jdec[1:], tdec[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# -------------------------------------------- staged == fused in the port
@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_staged_composition_equals_fused_leaf_for_leaf(store_dtype):
    """Two separate port states from one reference state (ingest writes
    the window, store and index in place, so they share nothing) take the
    same batches and counter draws, one through ``ingest_impl`` (fused
    ``admit``), one through ``staged_ingest_impl``; every leaf agrees after
    every batch, and the staged query answers like the fused one."""
    jc, tc, js, rng = _ingested(store_dtype, 0, seed=2)
    tree = jax_tree(js)
    fused = convert.state_from_numpy(tree, "cpu")
    staged = convert.state_from_numpy(tree, "cpu")
    gen = torch.Generator().manual_seed(2)
    for step in range(7):
        x, ids = _batch(rng, step)
        draws = heavy_hitter.draw(tc.hh, B, gen, "cpu")
        fused, info = tpipe.ingest_batch(tc, fused, x, ids, draws=draws)
        staged, s_info = staged_ingest_impl(tc, staged, x, ids, draws)
        for key in ("keep", "labels", "stored"):
            np.testing.assert_array_equal(s_info[key].numpy(), info[key].numpy())
        assert_trees(convert.state_to_numpy(fused),
                     convert.state_to_numpy(staged), **ULP2)
    assert staged.upserts >= 2 and int(staged.store.ids.ge(0).sum()) > 0

    q = torch.from_numpy(rng.normal(size=(11, D)).astype(np.float32))
    for depth in (None, 2):
        dv = tc.store_depth if depth is None else depth
        sc_f, pos_f, rt_f, *dec_op = stages.serve_topk(
            tc.index, fused.index, fused.route_labels, fused.store, q, 5, 4,
            depth=depth)
        routes = stages.route(tc.index, staged.index, staged.route_labels, q, 4)
        sc_s, pos_s = stages.rerank(staged.store, l2_normalize(q), routes, 5,
                                    depth=depth)
        np.testing.assert_array_equal(routes.numpy(), rt_f.numpy())
        np.testing.assert_array_equal(pos_s.numpy(), pos_f.numpy())
        np.testing.assert_allclose(sc_s.numpy(), sc_f.numpy(), **ULP2)
        dec_f = stages.decode_rerank(fused.store.ids, rt_f, sc_f, pos_f, dv, 4,
                                     store_depth=tc.store_depth)
        dec_s = stages.decode_rerank(staged.store.ids, routes, sc_s, pos_s, dv,
                                     4, store_depth=tc.store_depth)
        for a, b, c in zip(dec_f[1:], dec_s[1:], dec_op):
            np.testing.assert_array_equal(b.numpy(), a.numpy())
            np.testing.assert_array_equal(c.numpy(), a.numpy())


def test_staged_ingest_matches_reference_ingest():
    """The staged composition against the reference's own ingest over a
    ragged stream (the reference's engine composes the equivalent fused
    ``admit``, pinned to the staged oracle on the CPU), the port fed the
    reference's counter draws."""
    jc, tc, js, rng = _ingested("int8", 0, seed=3)
    ts = convert.state_from_numpy(jax_tree(js), "cpu")
    before = snapshot()
    for step in range(6):
        x, ids = _batch(rng, step)
        draws = ingest_draws(js, B, jc.hh.bmax())
        js, _ = jpipe.ingest_batch(jc, js, jnp.asarray(x), jnp.asarray(ids))
        ts, _ = staged_ingest_impl(tc, ts, x, ids, draws)
        tree = convert.state_to_numpy(ts)
        assert_trees(jax_tree(js), tree)
    after = snapshot()
    assert after["prefilter"]["plain"] == before["prefilter"]["plain"] + 6
    assert after["assign"]["plain"] == before["assign"]["plain"] + 6
    assert after["admit"] == before["admit"]
