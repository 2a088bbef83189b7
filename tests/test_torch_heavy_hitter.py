"""The port's heavy-hitter counter against the JAX reference, through
the ``kernels/heavy_hitter`` dispatcher (a CPU tensor runs the plain
loop, ``ref.py``), and the kernel wrapper's plan and argument checks.

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
from repro_torch.kernels import build
from repro_torch.kernels.counts import COUNTS
from repro_torch.kernels.heavy_hitter import ops as hh_ops
from repro_torch.kernels.heavy_hitter.heavy_hitter import (heavy_hitter_plan,
                                                          update_batch_cuda)

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
    COUNTS["heavy_hitter"].reset()
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
    # the CPU path is the plain loop, once per batch
    assert (COUNTS["heavy_hitter"].plain, COUNTS["heavy_hitter"].kernel) == (4, 0)


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


@pytest.mark.parametrize("bmax,cells,threads", [(100, 0, 32), (200, 0, 32),
                                                (4218, 0, 544), (4218, 1024, 544),
                                                (8436, 0, 1024), (20000, 0, 1024)])
def test_heavy_hitter_plan_sizes_one_block(bmax, cells, threads):
    """One block of at most 1024 threads, about 8 slots a thread; shared
    memory holds labels and counts, the sketch and a chunk of staged
    arrivals (33.7 KB of slots at bmax 4218, 67.5 KB adaptive at 8436,
    past the 48 KB that needs the opt-in)."""
    plan = heavy_hitter_plan(bmax, cells)
    assert plan.threads == threads and plan.threads % 32 == 0
    assert plan.smem == 4 * (2 * bmax + cells + 3 * threads)
    assert plan.smem + 1024 <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("bmax,cells", [(28000, 0), (27000, 4 * 256 * 8)])
def test_heavy_hitter_plan_refuses_past_shared_memory(bmax, cells):
    with pytest.raises(ValueError, match="shared memory"):
        heavy_hitter_plan(bmax, cells)


def _hh_inputs(policy=thh.Policy.MIN_EVICT, morris=False, B=6):
    cfg = thh.HHConfig(capacity=8, policy=policy, morris=morris)
    labels = torch.arange(B, dtype=torch.int32)
    draws = thh.draw(cfg, B, torch.Generator().manual_seed(0), "cpu")
    return cfg, thh.init(cfg, "cpu"), labels, draws


@pytest.mark.parametrize("case", ["cpu_tensors", "f64_uniforms", "i64_labels",
                                  "short_uniforms", "no_gumbel", "no_morris"])
def test_heavy_hitter_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The wrapper checks dtypes, shapes, devices and the draws the config
    needs before it builds or launches anything (so this runs here)."""
    policy = thh.Policy.RANDOM_EVICT if case == "no_gumbel" else thh.Policy.MIN_EVICT
    cfg, state, labels, draws = _hh_inputs(policy, morris=case == "no_morris")
    if case == "f64_uniforms":
        draws["uniforms"] = draws["uniforms"].double()
    elif case == "i64_labels":
        labels = labels.long()
    elif case == "short_uniforms":
        draws["uniforms"] = draws["uniforms"][:-1]
    elif case == "no_gumbel":
        del draws["gumbel"]
    elif case == "no_morris":
        del draws["morris"]
    with pytest.raises(ValueError, match="heavy_hitter|needs draws"):
        update_batch_cuda(cfg, state, labels, draws)


def test_heavy_hitter_dispatch_refuses_other_and_mixed_devices():
    cfg, state, labels, draws = _hh_inputs()
    with pytest.raises(ValueError, match="no kernel or plain version"):
        hh_ops.update_batch(cfg, thh.init(cfg, "meta"), labels.to("meta"),
                            {k: v.to("meta") for k, v in draws.items()})
    with pytest.raises(ValueError, match="tensors on"):
        hh_ops.update_batch(cfg, state, labels,
                            {k: v.to("meta") for k, v in draws.items()})
