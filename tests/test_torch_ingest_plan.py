"""The admit and prefilter wrappers' launch plans (``kernels/admit/admit.py::
admit_plan`` and ``kernels/prefilter/prefilter.py::prefilter_plan``), which
run in Python on any device: the grids, the shared memory each block is
given for the unit basis, the one scratch buffer of an admit call, and
the refusal of a basis past one block's shared memory. The kernels
themselves are tested on the card (``test_torch_kernels_gpu.py``)."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.admit.admit import (PROLOGUE_WARPS, SCRATCH_ALIGN, admit_cuda,
                                             admit_plan)
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.prefilter.prefilter import (PREFILTER_ROWS, prefilter_plan,
                                                     prefilter_scores_cuda)

# the largest n whose n x 384 fp32 basis fits one block: 151 x 1536 B
N_LIMIT_384 = build.SMEM_PER_BLOCK // (4 * 384)


def test_the_main_shapes():
    """The fused ingest batch (256 rows, 4218 centroids, 5 x 384 basis):
    560 prologue blocks, 7.5 KB of basis a block; the staged screen of the
    same batch at 8 rows a block (the fastest of 2, 4, 8 and 16 on the
    card: every block normalizes the basis, a warp a basis row), 32
    blocks."""
    p = admit_plan(256, 4218, 5, 384)
    assert (p.blocks, p.smem) == (560, 7680)
    f = prefilter_plan(256, 5, 384)
    assert (f.rows, f.blocks, f.smem) == (8, 32, 7680)
    assert N_LIMIT_384 == 151


@pytest.mark.parametrize("B,K,n,d", [(256, 4218, 5, 384), (250, 4218, 5, 384),
                                     (1, 5, 1, 64), (13, 70, 5, 383), (9, 33, 5, 18),
                                     (40, 300, 5, 701), (256, 4306, 151, 384)])
def test_admit_plan_covers_rows_and_centroids(B, K, n, d):
    """One warp per row and per centroid, PROLOGUE_WARPS a block; the
    scratch regions (unit rows, unit centroids, B keys + the done counter)
    start on SCRATCH_ALIGN boundaries, follow each other and do not
    overlap."""
    p = admit_plan(B, K, n, d)
    assert p.blocks * PROLOGUE_WARPS >= B + K > (p.blocks - 1) * PROLOGUE_WARPS
    assert p.smem == 4 * n * d <= build.SMEM_PER_BLOCK
    assert p.xn == 0
    for off in (p.xn, p.cn, p.keys):
        assert off % SCRATCH_ALIGN == 0
    assert p.xn + 4 * B * d <= p.cn < p.xn + 4 * B * d + SCRATCH_ALIGN
    assert p.cn + 4 * K * d <= p.keys < p.cn + 4 * K * d + SCRATCH_ALIGN
    assert p.nbytes == p.keys + 8 * (B + 1)


@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 250, 256, 513])
@pytest.mark.parametrize("d", [18, 383, 384, 701])
def test_prefilter_plan_grid(B, d):
    """PREFILTER_ROWS warps a block, enough blocks for every row and no
    block without one; the n unit basis rows in shared memory."""
    p = prefilter_plan(B, 5, d)
    assert p.rows == PREFILTER_ROWS
    assert p.blocks == cdiv(B, p.rows)
    assert p.blocks * p.rows >= B > (p.blocks - 1) * p.rows
    assert p.smem == 4 * 5 * d


@pytest.mark.parametrize("n,d", [(N_LIMIT_384, 384), (1, build.SMEM_PER_BLOCK // 4),
                                 (5, 11_622)])
def test_a_basis_at_the_shared_memory_limit_fits(n, d):
    assert admit_plan(256, 4218, n, d).smem <= build.SMEM_PER_BLOCK
    assert prefilter_plan(256, n, d).smem <= build.SMEM_PER_BLOCK


@pytest.mark.parametrize("n,d", [(N_LIMIT_384 + 1, 384), (1, build.SMEM_PER_BLOCK // 4 + 1),
                                 (5, 11_623)])
def test_a_basis_past_the_shared_memory_limit_is_refused(n, d):
    with pytest.raises(ValueError, match="shared memory"):
        admit_plan(256, 4218, n, d)
    with pytest.raises(ValueError, match="shared memory"):
        prefilter_plan(256, n, d)


def test_the_wrappers_refuse_before_any_launch():
    """The refusal comes from the plan, before the wrapper allocates or
    builds anything, so it holds for tensors on any device."""
    x = torch.zeros((8, 384))
    basis = torch.zeros((N_LIMIT_384 + 1, 384))
    with pytest.raises(ValueError, match="shared memory"):
        prefilter_scores_cuda(x, basis)
    with pytest.raises(ValueError, match="shared memory"):
        admit_cuda(x, basis, torch.zeros((10, 384)), 0.0)

