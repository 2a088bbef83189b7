"""The port's heavy-hitter counter against the JAX reference.

MIN_EVICT, SPACE_SAVING and COUNT_MIN are deterministic given the gate
uniforms, so the port is fed exactly the uniforms the reference draws
(``split(key, B)`` then ``split(., 3)`` then ``uniform``) and every state
leaf and info entry must match exactly (integer state; the one float,
``admit_prob``, is only ever copied or scaled by the same constants).
RANDOM_EVICT and Morris counting draw Gumbel and Morris noise; the port's
own ``torch.Generator`` draws are checked by distribution instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heavy_hitter as jhh
from repro_torch.core import heavy_hitter as thh

from _torch_parity import assert_trees, hh_draws, jax_tree


def _cfgs(policy, **kw):
    return (jhh.HHConfig(policy=jhh.Policy(int(policy)), **kw),
            thh.HHConfig(policy=policy, **kw))


def _as_np(state):
    return {n: v.numpy() for n, v in zip(state._fields, state)}


@pytest.mark.parametrize("policy", [thh.Policy.MIN_EVICT,
                                    thh.Policy.SPACE_SAVING,
                                    thh.Policy.COUNT_MIN])
@pytest.mark.parametrize("extra", [{}, {"gate_below_capacity": True},
                                   {"adaptive": True, "max_capacity": 24,
                                    "window": 16}])
def test_update_batch_exact_with_reference_uniforms(policy, extra):
    jc, tc = _cfgs(policy, capacity=8, admit_prob=0.4, cms_width=32, **extra)
    js, ts = jhh.init(jc), thh.init(tc, "cpu")
    rng = np.random.default_rng(int(policy))
    key = jax.random.key(7)
    for step in range(4):
        # a skewed label stream with dropped (-1) arrivals
        labels = rng.zipf(1.5, size=48).astype(np.int32) % 20
        labels[rng.random(48) < 0.2] = -1
        key, sub = jax.random.split(key)
        js, jinfo = jhh.update_batch(jc, js, jnp.asarray(labels), sub)
        ts, tinfo = thh.update_batch(tc, ts, torch.from_numpy(labels),
                                     draws=hh_draws(sub, 48, jc.bmax()))
        assert_trees(jax_tree(js), _as_np(ts), rtol=0, atol=0)
        assert_trees({k: np.asarray(v) for k, v in jinfo.items()},
                     {k: v.numpy() for k, v in tinfo.items()}, rtol=0, atol=0)
    assert int(ts.total_evictions) > 0 or policy == thh.Policy.COUNT_MIN


def test_update_one_single_arrival_exact():
    jc, tc = _cfgs(thh.Policy.MIN_EVICT, capacity=4, admit_prob=1.0)
    js, ts = jhh.init(jc), thh.init(tc, "cpu")
    for lbl in [3, 3, 5, 7, 9, 11, 3, -1]:
        key = jax.random.key(lbl + 100)
        js, jinfo = jhh.update_one(jc, js, jnp.int32(lbl), key)
        d = hh_draws(key, 1, jc.bmax())   # not the same split; gate is u<=1
        ts, tinfo = thh.update_one(tc, ts, torch.tensor(lbl, dtype=torch.int32),
                                   d["uniforms"][0])
        assert_trees(jax_tree(js), _as_np(ts), rtol=0, atol=0)
        assert int(tinfo["slot"]) == int(jinfo["slot"])
        assert bool(tinfo["admitted"]) == bool(jinfo["admitted"])


def test_random_evict_victims_uniform_over_slots():
    """Gumbel-max eviction picks each occupied slot about equally often
    (chi-square against uniform over 8 slots, 2000 evictions)."""
    cfg = thh.HHConfig(capacity=8, admit_prob=1.0,
                       policy=thh.Policy.RANDOM_EVICT)
    gen = torch.Generator().manual_seed(0)
    state = thh.init(cfg, "cpu")
    state, _ = thh.update_batch(cfg, state, torch.arange(8, dtype=torch.int32),
                                gen=gen)
    hits = np.zeros(8)
    new = torch.arange(100, 2100, dtype=torch.int32)   # every arrival novel
    state, info = thh.update_batch(cfg, state, new, gen=gen)
    np.add.at(hits, info["slot"].numpy(), 1)
    expected = len(new) / 8
    chi2 = float(np.sum((hits - expected) ** 2 / expected))
    assert chi2 < 24.3, hits          # p = 0.001 at 7 degrees of freedom
    assert int(state.total_evictions) == len(new)


def test_morris_counter_estimate_unbiased():
    """Morris counting: after n arrivals of one label the estimate 2^c - 1
    has mean n; 160 independent counters of n=64 arrivals, mean within 4
    standard errors."""
    cfg = thh.HHConfig(capacity=1, admit_prob=1.0, morris=True)
    gen = torch.Generator().manual_seed(1)
    est = []
    for _ in range(160):
        st = thh.init(cfg, "cpu")
        st, _ = thh.update_batch(cfg, st, torch.zeros(64, dtype=torch.int32),
                                 gen=gen)
        est.append(float(thh.estimated_counts(cfg, st)[0]))
    est = np.asarray(est)
    # first arrival inserts with count 1, the other 63 increment w.p. 2^-c
    sem = est.std() / np.sqrt(len(est))
    assert abs(est.mean() - 64.0) < 4 * sem, (est.mean(), sem)


def test_config_validation_matches_reference():
    for bad in ({"capacity": 0}, {"cms_depth": 0}, {"window": -1},
                {"max_capacity": 0}):
        with pytest.raises(ValueError):
            thh.HHConfig(**bad)
        with pytest.raises(ValueError):
            jhh.HHConfig(**bad)
