"""The mips wrapper's shape dispatch and sizing (``kernels/mips/mips.py::
mips_plan``), which run in Python on any device: which path each of the
port's shapes takes, and the block, merge and spill sizes the CUDA
kernel is handed. The kernel itself is tested on the card
(``test_torch_kernels_gpu.py``)."""
import pytest

from repro_torch.kernels import build
from repro_torch.kernels.mips.mips import (BLOCKED_MAX_K, BLOCKED_MAX_ROWS,
                                           MERGE_CAP, SELECT_SLOTS,
                                           SELECT_THREADS, THRESHOLD_MAX_K,
                                           TILE_ROWS, mips_plan, select_smem_bytes,
                                           spill_shape)


@pytest.mark.parametrize("Q,N,k,path", [
    (64, 4218, 10, "blocked"),         # streaming-RAG prototype-only flush
    (64, 4218, 8, "blocked"),          # staged route, nprobe 8
    (1, 7, 7, "blocked"),
    (4, 1_000_000, 100, "threshold"),  # MIND retrieve
    (1, 1_000_000, 100, "threshold"),  # DIEN, BERT4Rec, FM retrieve
    (3, 5000, 1000, "threshold"),      # k above the blocked path's passes
    (2, 100_000, 16, "threshold"),     # an index above the blocked path's rows
])
def test_mips_plan_path(Q, N, k, path):
    assert mips_plan(Q, N, k).path == path


@pytest.mark.parametrize("Q", [1, 2, 3, 4, 5, 8, 9, 64])
@pytest.mark.parametrize("N,k", [(1_000_000, 100), (5000, 1000), (2000, 64),
                                 (65_537, 1), (300_000, 4000)])
def test_mips_plan_threshold_sizes(Q, N, k):
    """Blocks are whole multiples of the select block's threads, hold at
    most one key slot set per thread and at least k rows, and tile N
    exactly; the merge's sort width is the power of two at or above k; a
    select block fits the card's shared memory; the spill list exists only
    where a query's keys exceed the merge's registers."""
    d = 64
    p = mips_plan(Q, N, k)
    assert p.path == "threshold"
    assert p.qb == min(b for b in (1, 2, 4, 8) if b >= min(Q, 8))
    assert p.bn % SELECT_THREADS == 0 and p.bn <= SELECT_THREADS * SELECT_SLOTS
    assert p.bn >= k
    assert (p.nblk - 1) * p.bn < N <= p.nblk * p.bn
    assert p.P >= k and p.P & (p.P - 1) == 0 and p.P < 2 * k + (k == 1)
    assert select_smem_bytes(p, d) <= build.SMEM_PER_BLOCK
    m = p.nblk * k
    assert spill_shape(p, Q, k) == ((Q, m) if m > MERGE_CAP else (1, 1))


def test_mips_plan_one_wave_at_the_retrieval_shapes():
    """MIND's 4 queries and the single-query retrieves cut the 10^6-row
    table into one select block per SM at most (one wave), and a query's
    keys fit the merge's registers (no spill)."""
    for Q in (1, 4):
        p = mips_plan(Q, 1_000_000, 100)
        assert (p.qb, p.bn, p.nblk, p.P) == (Q, 8192, 123, 128)
        assert spill_shape(p, Q, 100) == (1, 1)


@pytest.mark.parametrize("Q,N,k,qb,nblk,P", [
    (64, 4218, 10, 64, 132, 16),       # the flush: 132 tiles fill the 132 SMs
    (64, 4218, 8, 64, 132, 8),         # the staged route, k = nprobe
    (64, 28_125, 10, 64, 879, 16),     # the 1 GB budget's index
    (1, 7, 7, 16, 1, 8),
    (20, 1000, 32, 32, 32, 32),
    (100, 3000, 5, 64, 94, 8),         # two tile rows of queries
    (33, 65_536, 1, 64, 2048, 1)])
def test_mips_plan_blocked_sizes(Q, N, k, qb, nblk, P):
    """The blocked path's tiles: 16, 32 or 64 queries (the least that holds
    Q, at most 64) x TILE_ROWS = 32 index rows; each tile keeps k keys a
    query, so a query's merge takes nblk * k keys, in registers up to
    MERGE_CAP and spilled past it (2048 tiles x 32 keys)."""
    p = mips_plan(Q, N, k)
    assert (p.path, p.qb, p.bn, p.nblk, p.P) == ("blocked", qb, TILE_ROWS, nblk, P)
    assert (p.nblk - 1) * TILE_ROWS < N <= p.nblk * TILE_ROWS
    assert spill_shape(p, Q, k) == (1, 1)
    big = mips_plan(64, BLOCKED_MAX_ROWS, BLOCKED_MAX_K)
    assert big.nblk * BLOCKED_MAX_K > MERGE_CAP
    assert spill_shape(big, 64, BLOCKED_MAX_K) == (64, big.nblk * BLOCKED_MAX_K)


def test_mips_plan_limits():
    assert mips_plan(1, BLOCKED_MAX_ROWS, BLOCKED_MAX_K).path == "blocked"
    assert mips_plan(1, BLOCKED_MAX_ROWS + 1, BLOCKED_MAX_K).path == "threshold"
    assert mips_plan(1, BLOCKED_MAX_ROWS, BLOCKED_MAX_K + 1).path == "threshold"
    assert mips_plan(1, 10**6, THRESHOLD_MAX_K).path == "threshold"
    with pytest.raises(ValueError):
        mips_plan(1, 10**6, THRESHOLD_MAX_K + 1)
    with pytest.raises(ValueError):
        mips_plan(64, 10**6, 6000)     # above the 8-query blocks' rows
    with pytest.raises(ValueError):
        mips_plan(1, 10, 11)
    with pytest.raises(ValueError):
        mips_plan(1, 10, 0)
