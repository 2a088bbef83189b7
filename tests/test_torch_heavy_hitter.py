"""The port's heavy-hitter counter against the JAX reference, through
the ``kernels/heavy_hitter`` dispatcher (a CPU tensor runs the plain
loop, ``ref.py``), and the kernel wrapper's plan and argument checks.

The port is fed exactly the draws the reference makes (``split(key, B)``
then ``split(., 3)`` then the gate uniform, the Gumbel row and the Morris
uniform), and every state leaf and info entry must match exactly (integer
state; the one float, ``admit_prob``, is only ever copied or scaled by the
same constants), for every policy, and for counters past the one-block
kernel's ceiling (bmax 28,125, the 1 GB budget's, which the card runs on
its large path) from a full state. The port's own ``torch.Generator``
draws are checked by distribution.
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
from repro_torch.kernels.heavy_hitter import heavy_hitter as hh_kernel
from repro_torch.kernels.heavy_hitter import ops as hh_ops
from repro_torch.kernels.heavy_hitter.heavy_hitter import (MAX_BMAX, call_bytes,
                                                          heavy_hitter_plan, large_plan,
                                                          update_batch_cuda, update_plan)

from _torch_parity import assert_trees, foreign, hh_draws, jax_tree


def _cfgs(policy, **kw):
    return (jhh.HHConfig(policy=jhh.Policy(int(policy)), **kw),
            thh.HHConfig(policy=policy, **kw))


def _as_np(state):
    return {n: v.numpy() for n, v in zip(state._fields, state)}


LARGE = 28_125   # budget_to_config(1000.0, dim=384, int8 depth 64)'s bmax


def _full(jc, rng):
    """Labels 0..3 * capacity - 1 shuffled into every active slot (small
    counts), the rest empty: a full counter, so misses evict."""
    cap, bmax = jc.capacity, jc.bmax()
    labels = np.full(bmax, -1, np.int32)
    labels[:cap] = rng.permutation(3 * cap)[:cap]
    counts = np.zeros(bmax, np.int32)
    counts[:cap] = rng.integers(0, 4 if jc.morris else 9, cap)
    return labels, counts


@pytest.mark.parametrize("policy", [thh.Policy.MIN_EVICT,
                                    thh.Policy.SPACE_SAVING,
                                    thh.Policy.COUNT_MIN,
                                    thh.Policy.RANDOM_EVICT])
@pytest.mark.parametrize("extra", [{}, {"gate_below_capacity": True},
                                   {"adaptive": True, "max_capacity": 24,
                                    "window": 16},
                                   {"capacity": LARGE},
                                   {"capacity": LARGE, "morris": True},
                                   {"capacity": MAX_BMAX + 1, "adaptive": True,
                                    "max_capacity": LARGE, "window": 16}])
def test_update_batch_exact_with_reference_uniforms(policy, extra):
    """Four batches of 48 (a fifth dropped) through the reference's scan
    and the port's plain loop; a counter past the one-block kernel starts
    full, fed Zipf labels over three times its capacity."""
    jc, tc = _cfgs(policy, **{"capacity": 8, "admit_prob": 0.4, "cms_width": 32, **extra})
    js, ts = jhh.init(jc), thh.init(tc, "cpu")
    rng = np.random.default_rng(int(policy))
    large = jc.bmax() > MAX_BMAX
    if large:
        lab0, cnt0 = _full(jc, rng)
        js = js._replace(labels=jnp.asarray(lab0), counts=jnp.asarray(cnt0))
        ts = ts._replace(labels=torch.from_numpy(lab0), counts=torch.from_numpy(cnt0))
    key = jax.random.key(7)
    COUNTS["heavy_hitter"].reset()
    for step in range(4):
        # a skewed label stream with dropped (-1) arrivals
        if large:
            labels = ((rng.zipf(1.3, size=48) - 1) % (3 * jc.capacity)).astype(np.int32)
        else:
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


@pytest.mark.parametrize("bmax,cells,threads", [(100, 0, 256), (200, 0, 256),
                                                (4218, 0, 512), (4218, 1024, 512),
                                                (8436, 0, 512), (20000, 0, 512),
                                                (21392, 0, 512)])
def test_heavy_hitter_plan_sizes_one_block(bmax, cells, threads):
    """One block of 256 to 512 threads (about 8 slots a thread; at least
    the 256-arrival chunk); shared memory holds labels and counts, the
    sketch, the empty-slot bitmap, the chunk and the label -> slot table
    of 16-bit entries at load factor 0.5, rising to at most 0.8 where
    shared memory runs short (at bmax 20000 and at the ceiling, 21392)."""
    plan = heavy_hitter_plan(bmax, cells)
    assert plan.threads == threads and plan.threads % 32 == 0
    assert plan.smem == hh_kernel.smem_layout(bmax, cells, plan.table, False)["end"]
    assert plan.smem + hh_kernel.STATIC_SMEM <= build.SMEM_PER_BLOCK
    pref, least = hh_kernel.table_size(bmax)
    assert least <= plan.table <= pref and plan.table % 8 == 0
    assert plan.table == pref or plan.smem + hh_kernel.STATIC_SMEM + 16 > build.SMEM_PER_BLOCK
    assert (plan.table == pref) == (bmax <= 8436)
    assert not plan.stage


def test_heavy_hitter_plan_ceiling():
    """The largest bmax the plan takes: 21392 slots with no sketch (the
    table at load 0.8), less beside a sketch; the refusal names it."""
    assert hh_kernel.MAX_BMAX == hh_kernel.max_bmax(0) == 21392
    assert hh_kernel.max_bmax(4 * 256) == 21008
    assert hh_kernel.max_bmax(4 * 256 * 8) == 18308
    with pytest.raises(ValueError, match="largest bmax with no sketch is 21392"):
        heavy_hitter_plan(21393, 0)


@pytest.mark.parametrize("bmax,cells", [(21393, 0), (18309, 4 * 256 * 8)])
def test_heavy_hitter_plan_refuses_past_shared_memory(bmax, cells):
    with pytest.raises(ValueError, match="shared memory"):
        heavy_hitter_plan(bmax, cells)


@pytest.mark.parametrize("bmax,cells,path", [
    (4218, 0, "block"), (4218, 1024, "block"), (21392, 0, "block"),
    (21393, 0, "large"), (28125, 0, "large"), (112501, 0, "large"),
    (18308, 8192, "block"), (18309, 8192, "large"), (28125, 1024, "large"),
    (112501, 8192, "large")])
def test_update_plan_picks_the_path_from_the_shape(bmax, cells, path):
    """The one-block kernel wherever its plan takes bmax beside the sketch
    (21,392 with none, 18,308 beside 8,192 cells: its plan unchanged),
    else the large path, whatever the sketch (it lives in device memory)."""
    plan = update_plan(bmax, cells)
    assert plan.path == path
    assert plan == (heavy_hitter_plan(bmax, cells) if path == "block" else large_plan(bmax))


@pytest.mark.parametrize("bmax", [21393, 28125, 112501, 2_250_035])
def test_large_plan_sizes(bmax):
    """The large path: one block of 512 threads for the chain, its dynamic
    shared memory the chunk (4 KB), a minimum a group of 64 slots and a
    dirty bit a group; the table at load 0.5 in 4-byte entries; a prep
    warp a word of 32 slots; the scratch split on 16 bytes, the table, the
    minima and the four counts end to end (one memset) before the bitmap."""
    p = large_plan(bmax)
    groups = -(-bmax // 64)
    assert (p.threads, p.gshift, p.stage) == (512, 6, False)
    assert p.smem == 16 * 256 + 4 * (-(-groups // 4) * 4) + 4 * (-(-(-(-groups // 32)) // 4) * 4)
    assert p.smem + hh_kernel.STATIC_SMEM <= build.SMEM_PER_BLOCK
    assert p.table == hh_kernel.table_size(bmax)[0] and p.table >= 2 * bmax
    assert p.prep_blocks == min(-(-bmax // 256), 8 * 132)
    split = p.scratch_split(bmax)
    assert split[0] == p.table and split[2] == 4 and split[3] >= -(-bmax // 32)
    assert split[1] >= groups and all(n % 4 == 0 for n in split)
    assert sum(split) == p.scratch_ints


def test_large_plan_groups_grow_past_shared_memory():
    """Group minima and dirty bits fit shared memory beside the chunk up to
    about 3.3 M slots at 64 slots a group; past that a group doubles."""
    assert large_plan(3_000_000).gshift == 6
    assert large_plan(4_000_000).gshift == 7
    p = large_plan(hh_kernel.MAX_LARGE_BMAX)
    assert p.gshift > 6 and p.smem + hh_kernel.STATIC_SMEM <= build.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="int32"):
        large_plan(hh_kernel.MAX_LARGE_BMAX + 1)


def test_update_plan_refuses_only_past_device_memory():
    """No refusal for a bmax past shared memory; a refusal where the call
    (state in and out, draws, info, scratch) would not fit the card's
    memory: RANDOM_EVICT's Gumbel rows at 2^29 slots, or a card given too
    little; the exact need is accepted."""
    card = 80 * 10**9
    for bmax in (28125, 112501, 2_250_035, 1 << 29):
        assert update_plan(bmax, 0, B=256, card_bytes=card).path == "large"
    with pytest.raises(ValueError, match="device memory"):
        update_plan(1 << 29, 0, gumbel=True, B=256, card_bytes=card)
    need = call_bytes(large_plan(28125), 256, 28125, 0, False, False)
    assert need > 24 * 28125   # 8 B a slot in, 8 out, 8 of table
    assert update_plan(28125, 0, B=256, card_bytes=need).path == "large"
    with pytest.raises(ValueError, match="device memory"):
        update_plan(28125, 0, B=256, card_bytes=need - 1)


@pytest.mark.parametrize("policy", list(thh.Policy))
def test_heavy_hitter_large_launch_layout(policy):
    """The wrapper's launch data at the 1 GB budget's bmax: the large plan,
    its table and group shift in the kernel's config, no staged rows."""
    cfg = thh.HHConfig(capacity=LARGE, policy=policy)
    L = hh_kernel._launch_for(cfg, 256, LARGE)
    assert L.large and L.plan == large_plan(LARGE)
    assert (L.conf.table, L.conf.stage, L.conf.gshift) == (L.plan.table, 0, 6)
    assert L.split[0] == L.split[2] == LARGE and L.conf.bmax == LARGE


@pytest.mark.parametrize("bmax", [1, 7, 100, 4218, 8436, 21392])
@pytest.mark.parametrize("cells", [0, 4 * 64])
def test_heavy_hitter_smem_layout(bmax, cells):
    """The kernel's shared-memory arrays in its order, each on 16 bytes
    (16-byte vector moves, TMA's bulk copy into the Gumbel rows); the
    table's preferred and least sizes (load 0.5, 0.8) in multiples of 8."""
    pref, least = hh_kernel.table_size(bmax)
    assert pref == -(-2 * bmax // 8) * 8 and least >= 1.25 * bmax and least % 8 == 0
    assert least <= pref and bmax < least
    for stage in (False, True):
        lay = hh_kernel.smem_layout(bmax, cells, pref, stage)
        names = ["labels", "counts", "sketch", "empty_bits", "chunk", "gumbel_rows",
                 "table", "end"]
        assert list(lay) == names
        assert all(lay[n] % 16 == 0 for n in names)
        assert lay["counts"] - lay["labels"] >= 4 * bmax
        assert lay["empty_bits"] - lay["sketch"] >= 4 * cells
        assert lay["chunk"] - lay["empty_bits"] >= 4 * -(-bmax // 32)
        assert lay["gumbel_rows"] - lay["chunk"] == 16 * hh_kernel.CHUNK
        assert lay["table"] - lay["gumbel_rows"] == (8 * -(-bmax // 4) * 4 if stage else 0)
        assert lay["end"] - lay["table"] == 2 * pref


@pytest.mark.parametrize("bmax,policy,staged", [
    (100, thh.Policy.RANDOM_EVICT, True), (4218, thh.Policy.RANDOM_EVICT, True),
    (8436, thh.Policy.RANDOM_EVICT, True), (20000, thh.Policy.RANDOM_EVICT, False),
    (4218, thh.Policy.MIN_EVICT, False), (4218, thh.Policy.COUNT_MIN, False)])
def test_heavy_hitter_plan_stages_gumbel_rows_where_they_fit(bmax, policy, staged):
    """RANDOM_EVICT's two staged Gumbel rows take 8 * bmax bytes; the plan
    stages them only where they fit beside the preferred table (the
    kernel reads the rows from device memory otherwise), and never for
    another policy."""
    cells = 4 * 256 if policy == thh.Policy.COUNT_MIN else 0
    plan = heavy_hitter_plan(bmax, cells, gumbel=policy == thh.Policy.RANDOM_EVICT)
    assert plan.stage == staged
    if staged:
        assert plan.table == hh_kernel.table_size(bmax)[0]
        assert plan.smem == hh_kernel.smem_layout(bmax, cells, plan.table, True)["end"]


def test_heavy_hitter_table_home():
    """The kernel's Fibonacci hash of a label into the table: in range,
    the uint32 product scaled by the table's size (labels near 0 and
    INT32_MAX), and dense cluster ids spread over the table (no home holds
    more than 4 of 4218 labels in a table of 8440)."""
    T = 8440
    for label in (0, 1, 2, 2**31 - 2, 2**31 - 1):
        h = hh_kernel.table_home(label, T)
        assert 0 <= h < T
        assert h == (((label * 2654435761) % 2**32) * T) // 2**32
    assert hh_kernel.table_home(0, T) == 0
    homes = np.bincount([hh_kernel.table_home(x, T) for x in range(4218)], minlength=T)
    assert homes.max() <= 4 and homes.sum() == 4218


@pytest.mark.parametrize("policy", list(thh.Policy))
@pytest.mark.parametrize("B", [1, 256, 1025])
def test_heavy_hitter_output_layout(policy, B):
    """The wrapper's one int32 output buffer: labels, counts, the sketch
    and the scalars each on 16 bytes (the kernel stores 16-byte
    vectors), then the evicted labels and the slots; the per-call launch
    data is built once per (config, B, bmax)."""
    cfg = thh.HHConfig(capacity=4218, policy=policy)
    L = hh_kernel._launch_for(cfg, B, 4218)
    assert hh_kernel._launch_for(cfg, B, 4218) is L
    cells = 4 * 256 if policy == thh.Policy.COUNT_MIN else 0
    assert L.size == sum(L.split) and L.split[0] == L.split[2] == 4218
    assert L.split[4] == cells and L.split[-2:] == [B, B]
    assert all(o % 16 == 0 for o in (L.o_lab, L.o_cnt, L.o_cms, L.o_sc))
    assert L.o_slot - L.o_ev == 4 * B and L.o_ev == L.o_sc + 32
    assert (L.conf.table, bool(L.conf.stage)) == (L.plan.table, L.plan.stage)
    assert L.conf.B == B and L.conf.bmax == 4218 and L.conf.policy == int(policy)


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
        hh_ops.update_batch(cfg, type(state)(*map(foreign, state)), foreign(labels),
                            {k: foreign(v) for k, v in draws.items()})
    with pytest.raises(ValueError, match="tensors on"):
        hh_ops.update_batch(cfg, state, labels,
                            {k: v.to("meta") for k, v in draws.items()})
