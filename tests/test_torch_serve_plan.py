"""The serve and rerank wrappers' sizing (``kernels/serve/serve.py::
serve_plan`` and ``kernels/rerank/rerank.py::ring_cluster``), which run in
Python on any device: the route tile height and the rerank's cluster size
each of the port's shapes gets, and the shared-memory layout the CUDA
kernels are handed. The kernels themselves are tested on the card
(``test_torch_kernels_gpu.py``)."""
import pytest

from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.core import pipeline
from repro_torch.kernels.build import SMEM_PER_BLOCK
from repro_torch.kernels.common import SMS, cdiv
from repro_torch.kernels.rerank.rerank import (RING_MAX_CLUSTER, RING_MIN_SHARE, ring_cluster,
                                               ring_smem_bytes)
from repro_torch.kernels.serve.serve import (MAX_CAP, MERGE_WAYS, ROUTE_TILE_COLS, SELECT_KEYS,
                                             select_bytes, serve_plan)

# the main path's flush: 64 queries, int8 rings of depth 64, d 384, top-10
Q, DEPTH, D, K = 64, 64, 384, 10
BUDGETS_MB = (150.0, 1000.0, 4000.0, 8000.0, 16000.0, 60000.0)


def _cap(mb: float) -> int:
    cfg = pipeline.budget_to_config(mb, dim=D, base=paper_pipeline_config(
        dim=D, store_depth=DEPTH, store_dtype="int8"))
    assert cfg.clus.num_clusters == cfg.hh.bmax()
    return cfg.clus.num_clusters


@pytest.mark.parametrize("Q,cap,nprobe,depth,rm,cluster", [
    (64, 4218, 8, 64, 4, 2),      # the streaming-RAG flush, int8 depth 64
    (64, 4306, 8, 16, 4, 2),      # the fp32 config, depth 16
    (64, 4218, 8, 32, 4, 2),      # a depth-clipped plan
    (4, 64, 4, 8, 2, 1),          # the engine test's toy store
    (33, 500, 8, 16, 2, 2),
    (1, 4218, 8, 64, 2, 8),       # one query: eight blocks keep 64 slots each
    (256, 4218, 8, 64, 8, 1),     # enough queries to cover the card alone
    (64, 100, 80, 4, 2, 2),       # nprobe above a tile's 64 columns
])
def test_serve_plan_main_shapes(Q, cap, nprobe, depth, rm, cluster):
    p = serve_plan(Q, cap, nprobe, depth)
    assert (p.rm, p.cluster) == (rm, cluster)
    assert p.ntiles == cdiv(cap, ROUTE_TILE_COLS)
    assert p.kt == min(nprobe, ROUTE_TILE_COLS)
    assert p.m == p.ntiles * p.kt


@pytest.mark.parametrize("Q", [1, 7, 16, 33, 64, 65, 130, 1000])
@pytest.mark.parametrize("cap", [64, 700, 4218, 20_000])
def test_serve_plan_route_tiles(Q, cap):
    """The tallest route tile whose grid covers the SMs, else the shortest;
    every column tile keeps nprobe keys."""
    p = serve_plan(Q, cap, 8, 64)
    grids = {rm: p.ntiles * cdiv(Q, 8 * rm) for rm in (8, 4, 2)}
    if grids[p.rm] >= SMS:
        assert all(grids[rm] < SMS for rm in (8, 4, 2) if rm > p.rm)
    else:
        assert p.rm == 2 and grids[2] < SMS
    assert p.kt == 8 and p.m == 8 * p.ntiles


@pytest.mark.parametrize("Q", [1, 2, 3, 16, 33, 64, 66, 67, 132, 5000])
@pytest.mark.parametrize("ncand", [8, 64, 128, 512, 4096])
def test_ring_cluster_sizes(Q, ncand):
    """A power of two up to 8; the Q clusters fit one wave on the SMs (or
    the cluster is one block); a doubling is refused only for the wave,
    the cap of 8 or a share below RING_MIN_SHARE candidates."""
    cs = ring_cluster(Q, ncand)
    assert cs in (1, 2, 4, 8)
    assert cs == 1 or Q * cs <= SMS
    assert cs == 1 or ncand >= cs * RING_MIN_SHARE
    assert (cs == RING_MAX_CLUSTER or 2 * cs * Q > SMS
            or ncand < 2 * cs * RING_MIN_SHARE)


def test_serve_plan_refuses_nprobe_outside_the_index():
    with pytest.raises(ValueError):
        serve_plan(4, 10, 11, 8)
    with pytest.raises(ValueError):
        serve_plan(4, 10, 0, 8)


def _fits(base, nprobe):
    """The rule both entries select by: at most SELECT_KEYS keys, and the
    keys with their warp lists fit the block beside ``base`` bytes."""
    return lambda n: n <= SELECT_KEYS and base + select_bytes(n, nprobe) <= SMEM_PER_BLOCK


def _hold_levels(p, nprobe, fits):
    """Each pass merges every MERGE_WAYS sorted lists (the tiles' kt keys,
    then the last pass's nprobe) into one of nprobe and shrinks the keys;
    the last level fits, every earlier one does not; and a plan whose route
    tiles' keys fit has no pass."""
    assert p.m == p.ntiles * p.kt
    lists, length, chain = p.ntiles, p.kt, [p.m]
    for n in p.levels:
        assert not fits(chain[-1])
        lists, length = cdiv(lists, MERGE_WAYS), nprobe
        assert n == lists * length < chain[-1]
        chain.append(n)
    assert fits(p.msel)
    assert (p.levels == ()) == fits(p.m)


@pytest.mark.parametrize("nprobe", [8, 16, 32, 64])
@pytest.mark.parametrize("mb", BUDGETS_MB)
def test_serve_plan_selection_levels_at_every_budget(mb, nprobe):
    """At every budget's cap (150 MB to 60 GB) and nprobe 8-64 the fused
    call's selected keys fit one block beside the ring layout, the
    route-only entry's beside their warp lists, and both entries take the
    same passes (one rule: at most SELECT_KEYS keys); no pass where the
    parent's single selection fit at 150 MB and 1 GB (nprobe 8 to 32)."""
    cap = _cap(mb)
    p = serve_plan(Q, cap, nprobe, DEPTH, D, K)
    base = ring_smem_bytes(D, nprobe, DEPTH, K, p.cluster)
    _hold_levels(p, nprobe, _fits(base, nprobe))
    assert ring_smem_bytes(D, nprobe, DEPTH, K, p.cluster, p.msel) <= SMEM_PER_BLOCK
    r = serve_plan(Q, cap, nprobe, 1)
    _hold_levels(r, nprobe, _fits(0, nprobe))
    assert (p.rm, p.ntiles, p.kt, p.m, p.levels) == (r.rm, r.ntiles, r.kt, r.m, r.levels)
    if mb == 150.0 or (mb == 1000.0 and nprobe <= 32):
        assert p.levels == ()
    if mb >= 8000.0:
        assert p.levels


# the first cap each nprobe's single selection refused in the parent (a
# route tile more than fits: ring_smem at Q 64, int8 depth 64, d 384, k 10),
# and the first cap a pass runs at now: past SELECT_KEYS keys a query
@pytest.mark.parametrize("nprobe,first,refused", [(8, 131_073, 227_521),
                                                  (16, 65_537, 112_449),
                                                  (32, 32_769, 54_913), (64, 16_385, 26_113)])
def test_serve_plan_first_pass_past_select_keys(nprobe, first, refused):
    for cap, passes in ((first - 1, 0), (first, 1), (refused - 1, 1), (refused, 1)):
        p = serve_plan(Q, cap, nprobe, DEPTH, D, K)
        assert len(p.levels) == passes, (cap, p)
        assert (p.m > SELECT_KEYS) == bool(passes)
        assert ring_smem_bytes(D, nprobe, DEPTH, K, p.cluster, p.msel) <= SMEM_PER_BLOCK
    single = ring_smem_bytes(D, nprobe, DEPTH, K, p.cluster, p.m)
    assert single > SMEM_PER_BLOCK >= ring_smem_bytes(
        D, nprobe, DEPTH, K, p.cluster, (cdiv(refused - 1, ROUTE_TILE_COLS)) * p.kt)


def test_serve_plan_merges_further_beside_a_large_ring_layout():
    """Where the ring layout leaves less than SELECT_KEYS keys' room (nprobe
    64 over depth 512 int8 rings: 130 KB before any key), the fused plan
    merges until its keys fit beside it: one pass more than the route-only
    entry's plan, whose 12,800 keys it does not hold."""
    cap, nprobe, depth = 409_600, 64, 512
    p = serve_plan(Q, cap, nprobe, depth, D, K)
    base = ring_smem_bytes(D, nprobe, depth, K, p.cluster)
    assert base + select_bytes(SELECT_KEYS, nprobe) > SMEM_PER_BLOCK
    _hold_levels(p, nprobe, _fits(base, nprobe))
    r = serve_plan(Q, cap, nprobe, 1)
    _hold_levels(r, nprobe, _fits(0, nprobe))
    assert r.levels == (12_800,) and p.levels == (12_800, 448)


def test_serve_plan_at_the_4gb_main_path():
    """budget_to_config(4000.0) gives cap 112,501, whose 28,128 route keys
    a query need 232,544 B beside the ring layout at nprobe 16: one pass
    merges the 1,758 tiles' lists 32 at a time into 55 lists of 16."""
    cap = _cap(4000.0)
    assert cap == 112_501
    p = serve_plan(Q, cap, 16, DEPTH, D, K)
    assert (p.ntiles, p.kt, p.m, p.cluster) == (1758, 16, 28_128, 2)
    assert ring_smem_bytes(D, 16, DEPTH, K, 2, p.m) == 232_544
    assert p.levels == (880,)
    assert serve_plan(Q, cap, 8, DEPTH, D, K).levels == ()


def test_serve_plan_refuses_only_past_its_arithmetic():
    """A cap past 32-bit slots, a ring layout that does not fit one block
    before any route key, and an nprobe whose keys no pass brings into one
    block are refused; the largest cap is planned."""
    p = serve_plan(Q, MAX_CAP, 64, DEPTH, D, K)
    assert p.ntiles * ROUTE_TILE_COLS <= 2**31 and len(p.levels) >= 2
    with pytest.raises(ValueError, match="32-bit"):
        serve_plan(Q, MAX_CAP + 1, 8, DEPTH, D, K)
    with pytest.raises(ValueError, match="before any route key"):
        serve_plan(1, 10**6, 512, 512, D, K)
    with pytest.raises(ValueError, match="do not fit"):
        serve_plan(Q, 10**6, 20_000, 1)
