"""The serve and rerank wrappers' sizing (``kernels/serve/serve.py::
serve_plan`` and ``kernels/rerank/rerank.py::ring_cluster``), which run in
Python on any device: the route tile height and the rerank's cluster size
each of the port's shapes gets, and the shared-memory layout the CUDA
kernels are handed. The kernels themselves are tested on the card
(``test_torch_kernels_gpu.py``)."""
import pytest

from repro_torch.kernels.common import SMS, cdiv
from repro_torch.kernels.rerank.rerank import RING_MAX_CLUSTER, RING_MIN_SHARE, ring_cluster
from repro_torch.kernels.serve.serve import ROUTE_TILE_COLS, serve_plan


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
