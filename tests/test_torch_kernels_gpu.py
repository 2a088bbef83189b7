"""The port's CUDA kernels (admit, serve, mips, rerank, prefilter,
assign, bag and its backward's bag, gather and segment-sum entries,
heavy_hitter) against their plain PyTorch versions, on the card, and the
``AsyncServer`` and MeshGraphNet on the card. Run where there is one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

Elsewhere every test skips with its reason (the ``cuda`` fixture decides,
at run time). Tolerances, as in ``chip_smoke.py``: floats within rtol
1e-5 / atol 1e-6; decisions equal except at near-ties, where the plain
version's competing scores differ by under 1e-5 and the kernel's pick
must score within 1e-5 of the plain pick; int8 rows equal or off by one
where v/scale lies within 1e-4 of a half-integer; scales within 2 ulp.
The heavy-hitter kernel's state and info equal its plain loop's exactly
(integer decisions over the same floats and draws).
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import NEG_INF, l2_normalize
from repro_torch.kernels.counts import COUNTS

pytestmark = pytest.mark.gpu
TIE = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _close(a, b):
    return bool(((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all())


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("B,K,d", [(256, 4218, 384), (17, 700, 96), (1, 5, 64)])
def test_admit_kernel_matches_plain(cuda, store_dtype, B, K, d):
    from repro_torch.kernels.admit.admit import admit_cuda
    from repro_torch.kernels.admit.ref import admit_ref

    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, d), generator=g, device=cuda)
    basis = torch.randn((5, d), generator=g, device=cuda)
    cent = torch.randn((K, d), generator=g, device=cuda)
    if K > 3:
        cent[K - 1] = cent[2]            # exact tie: 2 must win
    live = torch.rand((B,), generator=g, device=cuda) < 0.8
    x[~live] = 0.0
    alpha = 0.01
    before = COUNTS["admit"].kernel
    k = admit_cuda(x, basis, cent, alpha, live, store_dtype=store_dtype)
    p = admit_ref(x, basis, cent, alpha, live, store_dtype=store_dtype)
    assert COUNTS["admit"].kernel == before + 1
    assert _close(k[0], p[0]) and _close(k[3], p[3])
    assert bool(((k[1] == p[1]) | ((p[0] - alpha).abs() < TIE)).all())
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pk = sims.gather(1, k[2].long()[:, None])[:, 0]
    pp = sims.gather(1, p[2].long()[:, None])[:, 0]
    assert bool(((k[2] == p[2]) | (pk >= pp - TIE)).all())
    if store_dtype == "int8":
        ulp = torch.nextafter(p[5], torch.full_like(p[5], np.inf)) - p[5]
        assert bool(((k[5] - p[5]).abs() <= 2 * ulp).all())
        z = l2_normalize(x) / p[5][:, None]
        half = (z - z.floor() - 0.5).abs() < 1e-4
        diff = k[4].int() - p[4].int()
        assert bool(((diff == 0) | ((diff.abs() == 1) & half)).all())
    else:
        assert _close(k[4], p[4])


@pytest.mark.parametrize("Q,N,k", [(64, 4218, 10), (3, 5000, 1000), (1, 7, 7)])
def test_mips_kernel_matches_plain(cuda, Q, N, k):
    from repro_torch.kernels.mips.mips import mips_topk_cuda
    from repro_torch.kernels.mips.ref import mips_topk_ref

    g = torch.Generator(device=cuda).manual_seed(N)
    d = 384
    index = l2_normalize(torch.randn((N, d), generator=g, device=cuda))
    index[N - 1] = index[0]
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    q[0] = index[0]                        # row 0 ties row N-1: 0 first
    valid = torch.rand((N,), generator=g, device=cuda) < 0.9
    valid[0] = valid[N - 1] = True
    s_k, i_k = mips_topk_cuda(q, index, valid, k)
    s_p, i_p = mips_topk_ref(q, index, valid, k)
    assert _close(s_k, s_p)
    S = torch.where(valid[None], q @ index.T, NEG_INF)
    got = S.gather(1, i_k.long())
    assert bool(((i_k == i_p) | ((got - s_p).abs() < TIE)).all())
    assert int(i_k[0, 0]) == 0 and (N == 1 or int(i_k[0, 1]) == N - 1)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("depth", [None, 5])
def test_serve_kernel_matches_plain(cuda, quantized, depth):
    from repro_torch.kernels.serve.ref import serve_topk_ref
    from repro_torch.kernels.serve.serve import serve_topk_cuda
    from repro_torch.store import quant

    g = torch.Generator(device=cuda).manual_seed(int(quantized))
    Q, d, cap, C, D, k, P = 33, 128, 500, 300, 16, 10, 8
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.9
    labels = torch.randint(0, C, (cap,), generator=g, device=cuda).int()
    labels[torch.rand((cap,), generator=g, device=cuda) < 0.2] = -1
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    rows = l2_normalize(torch.randn((C * D, d), generator=g, device=cuda))
    live = torch.rand((C, D), generator=g, device=cuda) < 0.7
    if quantized:
        e, s = quant.quantize_int8(rows, dim=-1)
        embs, scales = e.view(C, D, d), s.view(C, D)
    else:
        embs, scales = rows.view(C, D, d), None
    if depth is not None:    # a strided view of the full rings, never copied
        embs, live = embs[:, :depth], live[:, :depth]
        scales = None if scales is None else scales[:, :depth]
    out_k = serve_topk_cuda(q, q, v, valid, labels, embs, live, k, P, scales)
    out_p = serve_topk_ref(q, q, v, valid, labels, embs, live, k, P, scales)
    (s_k, p_k, r_k), (s_p, p_p, r_p) = out_k, out_p
    assert bool((r_k == -1).any())
    same = (r_k == r_p).all(dim=1)
    assert int(same.sum()) >= Q - 2          # route near-ties are rare
    assert _close(s_k[same], s_p[same])
    assert bool(((p_k == p_p) | ((s_k - s_p).abs() < TIE))[same].all())


def test_engine_on_card_launches_the_kernels(cuda):
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.engine.engine import Engine
    from repro_torch.kernels import counts

    cfg = paper_pipeline_config(dim=64, k=32, capacity=32, store_depth=8,
                                update_interval=64, alpha=0.0,
                                store_dtype="int8")
    rng = np.random.default_rng(0)
    eng = Engine(cfg, 0, rng.normal(size=(64, 64)).astype(np.float32))
    counts.reset_all()
    for step in range(3):
        eng.ingest(rng.normal(size=(32, 64)).astype(np.float32),
                   np.arange(step * 32, step * 32 + 32, dtype=np.int32))
    q = rng.normal(size=(4, 64)).astype(np.float32)
    for two in (True, False):
        s, rows, ids, cl = eng.query(q, 5, two_stage=two, nprobe=4)
        assert s.is_cuda and torch.isfinite(s).all()
    snap = counts.snapshot()
    assert all(snap[n]["kernel"] > 0 and snap[n]["plain"] == 0
               for n in ("admit", "heavy_hitter", "serve", "mips")), snap


@pytest.mark.parametrize("quantized,D,depth,k", [(True, 64, None, 10),
                                                 (True, 64, 32, 10),
                                                 (False, 16, None, 100)])
def test_rerank_kernel_matches_plain(cuda, quantized, D, depth, k):
    """int8 rings at the main path's depth, a depth-32 strided view, and
    fp32 rings with k above the live count; dead and duplicate routes."""
    from repro_torch.kernels.rerank.ref import rerank_topk_ref
    from repro_torch.kernels.rerank.rerank import rerank_topk_cuda
    from repro_torch.store import quant

    g = torch.Generator(device=cuda).manual_seed(D + k)
    Q, d, C, P = 64, 384, 4218, 8
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    rows = l2_normalize(torch.randn((C * D, d), generator=g, device=cuda))
    live = torch.rand((C, D), generator=g, device=cuda) < 0.6
    if quantized:
        e, s = quant.quantize_int8(rows, dim=-1)
        embs, scales = e.view(C, D, d), s.view(C, D)
    else:
        embs, scales = rows.view(C, D, d), None
    routes = torch.randint(0, C, (Q, P), generator=g, device=cuda).int()
    routes[torch.rand((Q, P), generator=g, device=cuda) < 0.1] = -1
    routes[:8, 1] = routes[:8, 0]                 # duplicate routes
    routes[8] = -1                                # a query routed nowhere
    if depth is not None:
        embs, live = embs[:, :depth], live[:, :depth]
        scales = None if scales is None else scales[:, :depth]
    before = COUNTS["rerank"].kernel
    s_k, p_k = rerank_topk_cuda(q, embs, live, routes, k, scales)
    s_p, p_p = rerank_topk_ref(q, embs, live, routes, k, scales)
    assert COUNTS["rerank"].kernel == before + 1
    assert _close(s_k, s_p)
    assert bool(((p_k == p_p) | ((s_k - s_p).abs() < TIE)).all())
    assert bool((p_k[8] == -1).all()) and bool((s_k[8] == NEG_INF).all())
    if k > P * embs.shape[1] * 0.6:
        assert bool((p_k == -1).any())            # k above the live count


@pytest.mark.parametrize("B,n,d", [(256, 5, 384), (37, 5, 384), (513, 1, 96)])
def test_prefilter_kernel_matches_plain(cuda, B, n, d):
    """B off the 8-row block; a zero basis row adds 0 over the true n."""
    from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda
    from repro_torch.kernels.prefilter.ref import prefilter_scores_ref

    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, d), generator=g, device=cuda)
    basis = torch.randn((n, d), generator=g, device=cuda)
    if n > 2:
        basis[2] = 0.0
    x[0] = 0.0                                    # a dead padding row
    before = COUNTS["prefilter"].kernel
    r_k = prefilter_scores_cuda(x, basis)
    r_p = prefilter_scores_ref(x, basis)
    assert COUNTS["prefilter"].kernel == before + 1
    assert bool(torch.isfinite(r_k).all()) and float(r_k[0]) == 0.0
    assert bool(((r_k - r_p).abs() <= 1e-6 + 1e-5 * r_p.abs()).all())


@pytest.mark.parametrize("B,K,d", [(256, 4218, 384), (1, 4218, 384),
                                   (1, 700, 64), (17, 5, 256), (70, 300, 18)])
def test_assign_kernel_matches_plain(cuda, B, K, d):
    """(70, 300, 18): rows of 18 floats take the tile kernel's 4-byte
    staging loads."""
    from repro_torch.kernels.assign.assign import assign_cuda
    from repro_torch.kernels.assign.ref import assign_ref

    g = torch.Generator(device=cuda).manual_seed(K + B)
    x = torch.randn((B, d), generator=g, device=cuda)
    cent = torch.randn((K, d), generator=g, device=cuda)
    if K > 3:
        cent[K - 1] = cent[2]                     # exact tie: 2 must win
        x[0] = cent[2]
    before = COUNTS["assign"].kernel
    i_k, s_k = assign_cuda(x, cent)
    i_p, s_p = assign_ref(x, cent)
    assert COUNTS["assign"].kernel == before + 1
    assert _close(s_k, s_p)
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pk = sims.gather(1, i_k.long()[:, None])[:, 0]
    pp = sims.gather(1, i_p.long()[:, None])[:, 0]
    assert bool(((i_k == i_p) | (pk >= pp - TIE)).all())
    assert int(i_k.max()) < K
    if K > 3:
        assert int(i_k[0]) == 2


def test_staged_stages_on_card_launch_their_kernels(cuda):
    """screen -> assign_update and route -> rerank on the card launch the
    prefilter, assign, mips and rerank kernels and call no plain version;
    they agree with the fused admit and serve kernels on the same state."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.core import pipeline
    from repro_torch.engine import stages
    from repro_torch.kernels import counts

    cfg = paper_pipeline_config(dim=64, k=32, capacity=32, store_depth=8,
                                update_interval=64, alpha=0.0,
                                store_dtype="int8")
    rng = np.random.default_rng(0)
    st = pipeline.init(cfg, 0, rng.normal(size=(64, 64)).astype(np.float32),
                       device=cuda)
    for step in range(3):
        st, _ = pipeline.ingest_batch(
            cfg, st, rng.normal(size=(32, 64)).astype(np.float32),
            np.arange(step * 32, step * 32 + 32, dtype=np.int32))
    x = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(cuda)
    counts.reset_all()
    _, r, keep = stages.screen(cfg.pre, st.pre, x)
    _, labels, _ = stages.assign_update(cfg.clus, st.clus, x, keep)
    routes = stages.route(cfg.index, st.index, st.route_labels, q, 4)
    scores, pos = stages.rerank(st.store, l2_normalize(q), routes, 5)
    snap = counts.snapshot()
    assert all(snap[n]["kernel"] == 1 for n in ("prefilter", "assign", "mips",
                                                "rerank")), snap
    assert all(c["plain"] == 0 for c in snap.values()), snap
    assert snap["admit"]["kernel"] == snap["serve"]["kernel"] == 0
    f_sc, f_pos, f_routes = stages.serve_topk(cfg.index, st.index,
                                              st.route_labels, st.store, q, 5, 4)
    # the staged and fused queries share the index scan and ring scoring
    assert torch.equal(routes, f_routes) and torch.equal(pos, f_pos)
    assert _close(scores, f_sc)
    _, _, a_keep, _, a_labels, _, _, _ = stages.admit(
        cfg.pre, cfg.clus, cfg.store, st.pre, st.clus, x)
    assert bool(((keep == a_keep) | ((r - cfg.pre.alpha).abs() < TIE)).all())
    sims = l2_normalize(x) @ l2_normalize(st.clus.centroids).T
    pick_s = sims.gather(1, labels.long()[:, None])[:, 0]
    pick_f = sims.gather(1, a_labels.long()[:, None])[:, 0]
    assert bool(((labels == a_labels) | ((pick_s - pick_f).abs() < TIE)).all())


@pytest.mark.parametrize("V,d,L,bags,case", [
    (1_000_000, 64, 25_600, 512, "mind"),     # MIND serve_p99: w = mask, mean
    (50, 16, 64, 10, "sum"),
    (20, 8, 40, 8, "unsorted"),               # unsorted segments, bags 5..7 empty
    (300, 18, 97, 13, "bf16"),
    (300, 18, 97, 13, "none"),                # weights=None
    (40, 200, 77, 9, "sum"),                  # d above one 128-column pass
    (10, 32, 1, 3, "one"),                    # a bag of one entry, two empty
])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_kernel_matches_plain(cuda, V, d, L, bags, case, mode):
    """Held against the plain version on the CPU copies of the inputs:
    there it sums each bag in index order, as the kernel does after its
    stable sort (on the card its ``index_add_`` sums with atomics, in an
    order that changes from run to run, and N(0, 1) rows cancel enough
    for that order to show beyond rtol 1e-5)."""
    from repro_torch.kernels.bag.bag import embedding_bag_cuda
    from repro_torch.kernels.bag.ref import embedding_bag_ref

    g = torch.Generator(device=cuda).manual_seed(V + L)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    table = torch.randn((V, d), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, V, (L,), generator=g, device=cuda, dtype=torch.int32)
    seg = torch.sort(torch.randint(0, bags, (L,), generator=g, device=cuda)).values.int()
    w = torch.rand((L,), generator=g, device=cuda)
    if case == "mind":
        S = L // bags
        mask = torch.arange(S, device=cuda)[None] < torch.randint(
            1, S + 1, (bags, 1), generator=g, device=cuda)
        idx = torch.where(mask, idx.view(bags, S), 0).reshape(-1)
        seg = torch.arange(bags, device=cuda, dtype=torch.int32).repeat_interleave(S)
        w = mask.float().reshape(-1)
    elif case == "unsorted":
        seg = torch.randint(0, 5, (L,), generator=g, device=cuda, dtype=torch.int32)
    elif case == "one":
        seg = torch.ones((1,), dtype=torch.int32, device=cuda)
    if case == "none":
        w = None
    before = COUNTS["bag"].kernel
    out_k = embedding_bag_cuda(table, idx, seg, bags, w, mode)
    out_p = embedding_bag_ref(table.cpu(), idx.cpu(), seg.cpu(), bags,
                              None if w is None else w.cpu(), mode).to(cuda)
    assert COUNTS["bag"].kernel == before + 1
    assert out_k.dtype == torch.float32 and out_k.shape == (bags, d)
    assert _close(out_k, out_p)
    empty = torch.bincount(seg.long(), minlength=bags) == 0
    assert bool((out_k[empty] == 0).all())
    if case == "one":
        assert bool(empty[0] & empty[2]) and not bool(empty[1])


def test_mips_kernel_at_the_retrieval_shape(cuda):
    """MIND's retrieve: 4 interest vectors against a 1,000,000 x 64 item
    table, k = 100."""
    from repro_torch.kernels.mips.mips import mips_topk_cuda
    from repro_torch.kernels.mips.ref import mips_topk_ref

    g = torch.Generator(device=cuda).manual_seed(4)
    index = torch.randn((1_000_000, 64), generator=g, device=cuda) * 0.02
    q = torch.randn((4, 64), generator=g, device=cuda)
    valid = torch.ones((1_000_000,), dtype=torch.bool, device=cuda)
    s_k, i_k = mips_topk_cuda(q, index, valid, 100)
    s_p, i_p = mips_topk_ref(q, index, valid, 100)
    assert _close(s_k, s_p)
    got = (q[:, None] * index[i_k.long()]).sum(-1)
    assert bool(((i_k == i_p) | ((got - s_p).abs() < TIE)).all())


def test_mind_on_card_launches_bag_and_mips(cuda):
    from repro_torch.kernels import counts
    from repro_torch.models.api import get_arch

    arch = get_arch("mind", smoke=True)
    params = arch.init()
    rng = np.random.default_rng(0)
    S = arch.hist_len
    mask = np.arange(S)[None] < rng.integers(1, S + 1, (8, 1))
    batch = {"hist": torch.from_numpy(np.where(mask, rng.integers(0, 1000, (8, S)), 0)
                                      .astype(np.int32)).to(cuda),
             "hist_mask": torch.from_numpy(mask).to(cuda),
             "target": torch.from_numpy(rng.integers(0, 1000, 8).astype(np.int32)).to(cuda)}
    counts.reset_all()
    s = arch.score(params, batch)
    top, ids = arch.retrieve(params, {k: v[:1] for k, v in batch.items()})
    snap = counts.snapshot()
    assert snap["bag"]["kernel"] == 2 and snap["mips"]["kernel"] == 1, snap
    assert all(c["plain"] == 0 for c in snap.values()), snap
    assert bool(torch.isfinite(s).all()) and top.shape == ids.shape == (1, 100)


def _hold_mips(q, index, valid, k):
    from repro_torch.kernels.mips.mips import mips_topk_cuda
    from repro_torch.kernels.mips.ref import mips_topk_ref

    before = COUNTS["mips"].kernel
    s_k, i_k = mips_topk_cuda(q, index, valid, k)
    s_p, i_p = mips_topk_ref(q, index, valid, k)
    assert COUNTS["mips"].kernel == before + 1
    assert _close(s_k, s_p)
    S = torch.where(valid[None], q @ index.T, NEG_INF)
    got = S.gather(1, i_k.long())
    assert bool(((i_k == i_p) | ((got - s_p).abs() < TIE)).all())
    return s_k, i_k


@pytest.mark.parametrize("d", [11, 18, 64])
def test_mips_kernel_one_query_over_a_million_rows(cuda, d):
    """DIEN's, FM's and BERT4Rec's retrieve: Q = 1 against 10^6 rows, k =
    100; at d = 11 and 18 the rows are not 16-byte aligned."""
    from repro_torch.kernels.mips.mips import mips_plan

    assert mips_plan(1, 1_000_000, 100).path == "threshold"
    g = torch.Generator(device=cuda).manual_seed(d)
    index = torch.randn((1_000_000, d), generator=g, device=cuda) * 0.02
    q = torch.randn((1, d), generator=g, device=cuda)
    valid = torch.rand((1_000_000,), generator=g, device=cuda) < 0.95
    _hold_mips(q, index, valid, 100)


def test_mips_kernel_ties_across_selection_blocks(cuda):
    """Exact ties whose rows lie in different select blocks: one row copied
    into block 5 (the copy comes second), and 120 copies of another row,
    one per block, straddling the k = 100 cut (the 100 lowest rows win)."""
    from repro_torch.kernels.mips.mips import mips_plan

    N, d, k = 1_000_000, 64, 100
    bn = mips_plan(4, N, k).bn
    g = torch.Generator(device=cuda).manual_seed(7)
    index = torch.randn((N, d), generator=g, device=cuda) * 0.02
    q = torch.randn((4, d), generator=g, device=cuda)
    index[3] = q[0] * 10.0                       # far above every other row
    index[5 * bn + 7] = index[3]
    copies = torch.arange(120, device=cuda) * bn + 11
    index[copies] = q[1] * 10.0
    valid = torch.ones((N,), dtype=torch.bool, device=cuda)
    s_k, i_k = _hold_mips(q, index, valid, k)
    assert i_k[0, :2].tolist() == [3, 5 * bn + 7]
    assert torch.equal(i_k[1].long(), copies[:k])


@pytest.mark.parametrize("N,n_valid,k", [(1_000_000, 50, 100), (2000, 30, 64),
                                         (500, 5, 10)])
def test_mips_kernel_k_above_the_valid_rows(cuda, N, n_valid, k):
    """Every row past n_valid invalid and k above the valid count: the
    valid rows come first by score, then invalid rows at NEG_INF in lowest
    row order; rows past N never surface. Both paths."""
    g = torch.Generator(device=cuda).manual_seed(N)
    d = 64
    index = l2_normalize(torch.randn((N, d), generator=g, device=cuda))
    q = l2_normalize(torch.randn((3, d), generator=g, device=cuda))
    valid = torch.arange(N, device=cuda) < n_valid
    s_k, i_k = _hold_mips(q, index, valid, k)
    assert bool((i_k[:, :n_valid] < n_valid).all())
    assert torch.equal(i_k[:, n_valid:].long(),
                       torch.arange(n_valid, k, device=cuda).expand(3, -1))
    assert bool((s_k[:, n_valid:] == NEG_INF).all())


def test_assign_kernel_ties_across_column_tiles(cuda):
    """Rows equal to a centroid that has exact copies in other 64-centroid
    column tiles (and rows in both 128-row tiles): the lowest index wins."""
    from repro_torch.kernels.assign.assign import assign_cuda
    from repro_torch.kernels.assign.ref import assign_ref

    g = torch.Generator(device=cuda).manual_seed(11)
    B, K, d = 256, 4218, 384
    x = torch.randn((B, d), generator=g, device=cuda)
    cent = torch.randn((K, d), generator=g, device=cuda)
    pairs = [(70, 4000), (5, 130), (64, 63 + 64 * 40), (1000, 4217)]
    for i, (lo, hi) in enumerate(pairs):
        cent[hi] = cent[lo]
        x[i] = cent[lo]
        x[200 + i] = cent[lo] * 3.0               # the second row tile
    i_k, s_k = assign_cuda(x, cent)
    i_p, s_p = assign_ref(x, cent)
    assert _close(s_k, s_p)
    for i, (lo, _) in enumerate(pairs):
        assert int(i_k[i]) == lo and int(i_k[200 + i]) == lo
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pk = sims.gather(1, i_k.long()[:, None])[:, 0]
    pp = sims.gather(1, i_p.long()[:, None])[:, 0]
    assert bool(((i_k == i_p) | (pk >= pp - TIE)).all())


def test_mips_kernel_many_queries_spill(cuda):
    """64 queries against 10^6 rows, k = 100: a query's 196 x 100 block
    keys exceed what a merge block holds in registers, so the merge counts
    its survivors in device memory."""
    from repro_torch.kernels.mips.mips import MERGE_CAP, mips_plan

    plan = mips_plan(64, 1_000_000, 100)
    assert plan.nblk * 100 > MERGE_CAP
    g = torch.Generator(device=cuda).manual_seed(64)
    index = torch.randn((1_000_000, 64), generator=g, device=cuda) * 0.02
    q = torch.randn((64, 64), generator=g, device=cuda)
    valid = torch.ones((1_000_000,), dtype=torch.bool, device=cuda)
    _hold_mips(q, index, valid, 100)


@pytest.mark.parametrize("Q", [2, 5])
def test_mips_kernel_query_groups(cuda, Q):
    """Two queries (a select block of 2) and five (a block of 8, three of
    them empty) over 300,000 rows, k = 100."""
    from repro_torch.kernels.mips.mips import mips_plan

    assert mips_plan(Q, 300_000, 100).qb == (2 if Q == 2 else 8)
    g = torch.Generator(device=cuda).manual_seed(Q)
    index = torch.randn((300_000, 64), generator=g, device=cuda) * 0.02
    q = torch.randn((Q, 64), generator=g, device=cuda)
    valid = torch.rand((300_000,), generator=g, device=cuda) < 0.8
    _hold_mips(q, index, valid, 100)


# ---- serve and rerank on rings.cuh: both paths, every cluster size, edge cases
def _ring_store(g, C, D, d, quantized, fill=0.6):
    from repro_torch.store import quant

    rows = l2_normalize(torch.randn((C * D, d), generator=g, device="cuda"))
    live = torch.rand((C, D), generator=g, device="cuda") < fill
    if quantized:
        e, s = quant.quantize_int8(rows, dim=-1)
        return e.view(C, D, d), live, s.view(C, D)
    return rows.view(C, D, d), live, None


def _hold_rerank(q, embs, live, routes, k, scales, cluster=None):
    from repro_torch.kernels.rerank.ref import rerank_topk_ref
    from repro_torch.kernels.rerank.rerank import rerank_topk_cuda

    s_k, p_k = rerank_topk_cuda(q, embs, live, routes, k, scales, cluster=cluster)
    s_p, p_p = rerank_topk_ref(q, embs, live, routes, k, scales)
    assert _close(s_k, s_p)
    assert bool(((p_k == p_p) | ((s_k - s_p).abs() < TIE)).all())
    return s_k, p_k


def _hold_serve(q, v, valid, labels, embs, live, k, P, scales, plan=None):
    """The kernel's (scores, pos, routes) against the plain version: routes
    equal except after a near-tie of the plain route scores, and where
    they agree, scores close and picks equal or scoring within TIE."""
    from repro_torch.kernels.serve.ref import serve_topk_ref
    from repro_torch.kernels.serve.serve import serve_launcher

    plan, s_k, p_k, r_k, run = serve_launcher(q, q, v, valid, labels, embs, live, k, P,
                                              scales, plan)
    run()
    s_p, p_p, r_p = serve_topk_ref(q, q, v, valid, labels, embs, live, k, P, scales)
    rs = torch.sort(torch.where(valid[None], q @ v.T, NEG_INF), dim=1,
                    descending=True).values[:, :P + 1]
    tie = ((rs[:, :-1] - rs[:, 1:]) < TIE).any(dim=1)
    same = (r_k == r_p).all(dim=1)
    assert bool((same | tie).all())
    assert _close(s_k[same], s_p[same])
    assert bool(((p_k == p_p) | ((s_k - s_p).abs() < TIE))[same].all())
    return s_k, p_k, r_k


@pytest.mark.parametrize("case", ["scalar_int8", "scalar_fp32", "dup_routes", "all_dead",
                                  "k_above_live", "view"])
def test_serve_kernel_edge_cases(cuda, case):
    """d % 16 != 0 int8 and d % 4 != 0 fp32 rows (the scalar path),
    duplicate routes (slots labelled with few clusters), every route dead,
    k above the live slots, and a depth-clipped strided view."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    d = {"scalar_int8": 100, "scalar_fp32": 102}.get(case, 384)
    quantized = case != "scalar_fp32"
    Q, cap, C, D, P = 40, 700, 300, 16, 8
    k = P * D if case == "k_above_live" else 10
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.9
    labels = torch.randint(0, C, (cap,), generator=g, device=cuda).int()
    if case == "dup_routes":
        labels = torch.randint(0, 3, (cap,), generator=g, device=cuda).int()
    if case == "all_dead":
        labels[:] = -1
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    embs, live, scales = _ring_store(g, C, 32 if case == "view" else D, d, quantized,
                                     0.05 if case == "k_above_live" else 0.6)
    if case == "view":
        embs, live, scales = embs[:, :D], live[:, :D], scales[:, :D]
        assert not embs.is_contiguous()
    s_k, p_k, r_k = _hold_serve(q, v, valid, labels, embs, live, k, P, scales)
    if case == "dup_routes":
        assert bool((r_k[:, :, None] == r_k[:, None, :]).sum((1, 2)).gt(P).all())
    if case == "all_dead":
        assert bool((r_k == -1).all() & (p_k == -1).all() & (s_k == NEG_INF).all())
    if case == "k_above_live":
        assert bool((p_k == -1).any(dim=1).all())


@pytest.mark.parametrize("rm", [8, 4, 2])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_serve_kernel_plans_agree(cuda, rm, cluster):
    """At the main path's shape, every route tile height and cluster size
    gives the default plan's answer bit for bit (each dot is one in-order
    sum whatever the tiling), and that answer holds against plain."""
    import dataclasses

    from repro_torch.kernels.serve.serve import serve_plan

    g = torch.Generator(device=cuda).manual_seed(15)
    Q, d, cap, D, P, k = 64, 384, 4218, 64, 8, 10
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.9
    labels = torch.randperm(cap, generator=g, device=cuda).int()
    labels[torch.rand((cap,), generator=g, device=cuda) < 0.1] = -1
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    embs, live, scales = _ring_store(g, cap, D, d, True)
    base = serve_plan(Q, cap, P, D)
    assert (base.rm, base.ntiles, base.m) == (4, 66, 528)
    want = _hold_serve(q, v, valid, labels, embs, live, k, P, scales)
    got = _hold_serve(q, v, valid, labels, embs, live, k, P, scales,
                      dataclasses.replace(base, rm=rm, cluster=cluster))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_serve_kernel_phases_apart(cuda):
    """run(1) then run(2) gives run(3)'s answer bit for bit, also where the
    kernel just before run(2) writes the rerank's queries (the rerank is a
    dependent launch and must read them only after its wait)."""
    from repro_torch.kernels.serve.serve import serve_launcher

    g = torch.Generator(device=cuda).manual_seed(16)
    Q, d, cap, D, P, k = 64, 384, 4218, 64, 8, 10
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.9
    labels = torch.randperm(cap, generator=g, device=cuda).int()
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    embs, live, scales = _ring_store(g, cap, D, d, True)
    qn = q.clone()
    _, s, p, r, run = serve_launcher(q, qn, v, valid, labels, embs, live, k, P, scales)
    run(3)
    want = [t.clone() for t in (s, p, r)]
    for _ in range(5):
        for t in (s, p, r, qn):
            t.zero_()
        run(1)
        qn.copy_(q)
        run(2)
        for a, b in zip((s, p, r), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("P", [8, 2])
def test_serve_route_ties_across_column_tiles(cuda, P):
    """Prototype 10 copied to slots 70 and 200 (other 64-column route
    tiles): a query equal to it routes to 10, 70, 200 in that order, and
    at nprobe 2 the cut keeps 10 and 70."""
    g = torch.Generator(device=cuda).manual_seed(P)
    Q, d, cap, C, D = 64, 384, 1000, 1000, 16
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    v[70] = v[10]
    v[200] = v[10]
    valid = torch.ones((cap,), dtype=torch.bool, device=cuda)
    labels = torch.arange(cap, device=cuda, dtype=torch.int32)
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    q[3] = v[10]
    q[60] = v[10]
    embs, live, scales = _ring_store(g, C, D, d, True)
    _, _, r_k = _hold_serve(q, v, valid, labels, embs, live, 10, P, scales)
    want = torch.tensor([10, 70, 200][:min(P, 3)], device=cuda, dtype=torch.int32)
    for i in (3, 60):
        assert torch.equal(r_k[i, :len(want)], want)


@pytest.mark.parametrize("case", ["scalar_int8", "scalar_fp32", "all_dead", "k_above_live"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_rerank_kernel_edge_cases(cuda, case, cluster):
    """The scalar path (d % 16 != 0 int8, d % 4 != 0 fp32), every route
    dead, and k above the live slots, at every cluster size."""
    g = torch.Generator(device=cuda).manual_seed(cluster)
    d = {"scalar_int8": 100, "scalar_fp32": 102}.get(case, 384)
    Q, C, D, P = 17, 500, 32, 8
    k = P * D if case == "k_above_live" else 10
    embs, live, scales = _ring_store(g, C, D, d, case != "scalar_fp32",
                                     0.03 if case == "k_above_live" else 0.6)
    routes = torch.randint(0, C, (Q, P), generator=g, device=cuda).int()
    routes[:4, 2] = routes[:4, 5]                 # duplicate routes
    if case == "all_dead":
        routes[:] = -1
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    s_k, p_k = _hold_rerank(q, embs, live, routes, k, scales, cluster)
    if case == "all_dead":
        assert bool((p_k == -1).all() & (s_k == NEG_INF).all())
    if case == "k_above_live":
        assert bool((p_k == -1).any(dim=1).all())
    s_1, p_1 = _hold_rerank(q, embs, live, routes, k, scales, 1)
    assert torch.equal(s_k, s_1) and torch.equal(p_k, p_1)


# ---- bag's sorted entry: one launch on the caller's tensors
@pytest.mark.parametrize("case,d", [("empty", 64), ("int64", 64), ("bf16", 64),
                                    ("mind", 18), ("mind", 200), ("mind", 64),
                                    ("many", 64)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_sorted_entry_matches_plain_and_sorting_path(cuda, case, d, mode):
    """Sorted segments with empty bags (leading, inner, trailing), int64
    indices and segments, a bf16 table, d = 18 and 200 (one and two column
    passes), and 9,000 bags (the kernel's many-bags regime: a binary search
    and 2 rows in flight): held against the plain version on CPU copies,
    and bit-equal to the sorting wrapper (a stable sort of sorted ids is
    the identity)."""
    from repro_torch.kernels.bag.bag import embedding_bag_cuda, embedding_bag_sorted_cuda
    from repro_torch.kernels.bag.ref import embedding_bag_ref

    g = torch.Generator(device=cuda).manual_seed(d)
    V, bags, S = (5000, 9000, 4) if case == "many" else (5000, 300, 20)
    table = torch.randn((V, d), generator=g, device=cuda)
    if case == "bf16":
        table = table.to(torch.bfloat16)
    mask = torch.arange(S, device=cuda)[None] < torch.randint(
        1, S + 1, (bags, 1), generator=g, device=cuda)
    idx = torch.where(mask, torch.randint(0, V, (bags, S), generator=g, device=cuda), 0)
    seg = torch.arange(bags, device=cuda)[:, None].expand(bags, S)
    w = mask.float()
    if case == "empty":   # drop bags 0, 1, 150 and the last 10
        keep = torch.ones((bags, S), dtype=torch.bool, device=cuda)
        keep[[0, 1, 150]] = False
        keep[-10:] = False
        idx, seg, w = idx[keep], seg[keep], w[keep]
    idx, seg, w = idx.reshape(-1), seg.reshape(-1), w.reshape(-1)
    if case != "int64":
        idx, seg = idx.int(), seg.int()
    before = COUNTS["bag"].kernel
    out_k = embedding_bag_sorted_cuda(table, idx, seg, bags, w, mode)
    assert COUNTS["bag"].kernel == before + 1
    out_p = embedding_bag_ref(table.cpu(), idx.cpu(), seg.cpu(), bags, w.cpu(), mode).to(cuda)
    assert _close(out_k, out_p)
    assert torch.equal(out_k, embedding_bag_cuda(table, idx, seg, bags, w, mode))
    empty = torch.bincount(seg.long(), minlength=bags) == 0
    assert bool((out_k[empty] == 0).all())
    if case == "empty":
        assert int(empty.sum()) == 13


def _hold_admit(x, basis, cent, alpha, live, store_dtype, normalize=True,
                live_plain="same"):
    """admit_cuda against admit_ref on the same inputs, by the near-tie
    rule; ``live_plain`` is the plain version's live where it differs
    (``live=None`` held against every row live). Returns the kernel's
    outputs."""
    from repro_torch.kernels.admit.admit import admit_cuda
    from repro_torch.kernels.admit.ref import admit_ref

    kw = dict(store_dtype=store_dtype, normalize=normalize)
    before = COUNTS["admit"].kernel
    k = admit_cuda(x, basis, cent, alpha, live, **kw)
    assert COUNTS["admit"].kernel == before + 1
    p = admit_ref(x, basis, cent, alpha, live if live_plain == "same" else live_plain, **kw)
    assert _close(k[0], p[0]) and _close(k[3], p[3])
    assert bool(((k[1] == p[1]) | ((p[0] - alpha).abs() < TIE)).all())
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pk = sims.gather(1, k[2].long()[:, None])[:, 0]
    pp = sims.gather(1, p[2].long()[:, None])[:, 0]
    assert bool(((k[2] == p[2]) | (pk >= pp - TIE)).all())
    if store_dtype == "int8":
        ulp = torch.nextafter(p[5], torch.full_like(p[5], np.inf)) - p[5]
        assert bool(((k[5] - p[5]).abs() <= 2 * ulp).all())
        v = l2_normalize(x) if normalize else x
        z = v / p[5][:, None]
        half = (z - z.floor() - 0.5).abs() < 1e-4
        diff = k[4].int() - p[4].int()
        assert bool(((diff == 0) | ((diff.abs() == 1) & half)).all())
    else:
        assert _close(k[4], p[4])
        assert bool((k[5] == 1.0).all())
    return k


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_admit_kernel_live_none(cuda, store_dtype):
    """live=None (a null pointer to the kernel) is every row live: the
    plain version with all live, and the kernel with an all-true live bit
    for bit."""
    from repro_torch.kernels.admit.admit import admit_cuda

    g = torch.Generator(device=cuda).manual_seed(7)
    B, K, d = 256, 4218, 384
    x = torch.randn((B, d), generator=g, device=cuda)
    basis = torch.randn((5, d), generator=g, device=cuda)
    cent = torch.randn((K, d), generator=g, device=cuda)
    ones = torch.ones((B,), dtype=torch.bool, device=cuda)
    got = _hold_admit(x, basis, cent, 0.0, None, store_dtype, live_plain=ones)
    want = admit_cuda(x, basis, cent, 0.0, ones, store_dtype=store_dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[1].any())


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("case,B,K,d", [
    ("zero_basis_row", 256, 4218, 384),
    ("ragged_B", 250, 4218, 384),     # B off the prologue's 8 rows a block
    ("ragged_B", 13, 70, 64),
    ("scalar_d", 61, 500, 383),       # d % 4 != 0: the 4-byte path
    ("scalar_d", 9, 33, 18),
    ("two_chunks", 70, 300, 200),     # 129..256 floats: 2 chunks a lane
    ("two_chunks", 70, 300, 201),     # ... on the 4-byte path
    ("four_chunks", 40, 300, 500),    # 385..512 floats: 4 chunks a lane
    ("four_chunks", 40, 300, 501),    # ... on the 4-byte path
    ("long_rows", 40, 300, 700),      # past the 512 floats a warp holds
    ("long_rows", 17, 300, 701),      # ... on the 4-byte path
    ("unaligned", 40, 300, 384),      # x a view off 16-byte alignment
    ("raw_rows", 64, 1000, 384),      # normalize=False
])
def test_admit_kernel_edge_cases(cuda, store_dtype, case, B, K, d):
    g = torch.Generator(device=cuda).manual_seed(B + d)
    x = torch.randn((B, d), generator=g, device=cuda)
    if case == "unaligned":
        x = torch.randn((B * d + 1,), generator=g, device=cuda)[1:].view(B, d)
    basis = torch.randn((5, d), generator=g, device=cuda)
    if case == "zero_basis_row":
        basis[2] = 0.0
    cent = torch.randn((K, d), generator=g, device=cuda)
    cent[K - 1] = cent[2]                           # exact tie: 2 must win
    x[0] = cent[2]
    live = torch.rand((B,), generator=g, device=cuda) < 0.8
    live[-1] = False
    x[-1] = 0.0                                     # a dead zero row
    k = _hold_admit(x, basis, cent, 0.01, live, store_dtype,
                    normalize=case != "raw_rows")
    assert int(k[2][0]) == 2
    assert not bool(k[1][-1]) and float(k[0][-1]) == 0.0


def test_admit_kernel_phases_apart(cuda):
    """A kernel just before admit writes its x; calls on two alternating
    batches, each right after that write, equal each batch's answer after
    a synchronize bit for bit. The tile kernel is a dependent launch and
    must read the prologue's unit rows (and touch the keys it zeroes) only
    after its wait: a read before it would see the other batch's rows."""
    from repro_torch.kernels.admit.admit import admit_cuda

    g = torch.Generator(device=cuda).manual_seed(16)
    B, K, d = 256, 4218, 384
    src = [torch.randn((B, d), generator=g, device=cuda) for _ in range(2)]
    basis = torch.randn((5, d), generator=g, device=cuda)
    cent = torch.randn((K, d), generator=g, device=cuda)
    x = torch.empty_like(src[0])
    want = []
    for s in src:
        x.copy_(s)
        torch.cuda.synchronize()
        want.append([t.clone() for t in admit_cuda(x, basis, cent, 0.0, None,
                                                   store_dtype="int8")])
        torch.cuda.synchronize()
    for i in range(10):
        x.copy_(src[i % 2])
        got = admit_cuda(x, basis, cent, 0.0, None, store_dtype="int8")
        for a, b in zip(got, want[i % 2]):
            assert torch.equal(a, b)
    assert not torch.equal(want[0][2], want[1][2])


@pytest.mark.parametrize("B,n,d", [(1, 5, 384), (250, 5, 384), (256, 5, 383),
                                   (3, 2, 18), (100, 5, 700),
                                   (70, 5, 200), (70, 5, 201),   # 2 chunks a lane
                                   (40, 5, 500), (40, 5, 501),   # 4 chunks a lane
                                   (256, 151, 384)])   # 151 x 384 floats: at the limit
def test_prefilter_kernel_edges(cuda, B, n, d):
    """One row; B off the rows a block takes; the 4-byte path (d % 4 !=
    0); every count of 4-float chunks a lane holds (1 to 4), and rows
    longer than a lane group holds; the largest basis that fits one
    block's shared memory."""
    from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda
    from repro_torch.kernels.prefilter.ref import prefilter_scores_ref

    g = torch.Generator(device=cuda).manual_seed(B + n + d)
    x = torch.randn((B, d), generator=g, device=cuda)
    basis = torch.randn((n, d), generator=g, device=cuda)
    basis[n - 1] = 0.0                            # a zero row adds 0 over the true n
    before = COUNTS["prefilter"].kernel
    r_k = prefilter_scores_cuda(x, basis)
    assert COUNTS["prefilter"].kernel == before + 1
    r_p = prefilter_scores_ref(x, basis)
    assert bool(torch.isfinite(r_k).all())
    assert _close(r_k, r_p)


def test_prefilter_and_admit_refuse_a_basis_past_shared_memory(cuda):
    from repro_torch.kernels.admit.admit import admit_cuda
    from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda

    x = torch.randn((8, 384), device=cuda)
    basis = torch.randn((152, 384), device=cuda)   # 233,472 B > 232,448
    with pytest.raises(ValueError, match="shared memory"):
        prefilter_scores_cuda(x, basis)
    with pytest.raises(ValueError, match="shared memory"):
        admit_cuda(x, basis, torch.randn((10, 384), device=cuda), 0.0)


def _device_ops(fn):
    """Names of the device operations (kernels, copies, fills) one warm
    call queues, as torch.profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("live", [None, "mask"])
def test_admit_and_prefilter_launches_a_call(cuda, live):
    """One admit call queues its two kernels (the prologue, then the tile
    kernel) and no other device work; one prefilter call queues one
    kernel."""
    from repro_torch.kernels.admit.admit import admit_cuda
    from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((256, 384), generator=g, device=cuda)
    basis = torch.randn((5, 384), generator=g, device=cuda)
    cent = torch.randn((4218, 384), generator=g, device=cuda)
    lv = None if live is None else torch.rand((256,), generator=g, device=cuda) < 0.9
    ops = _device_ops(lambda: admit_cuda(x, basis, cent, 0.2, lv, store_dtype="int8"))
    assert len(ops) == 2, ops
    assert sum("admit_prologue_kernel" in o for o in ops) == 1, ops
    assert sum("assign_tile_kernel" in o for o in ops) == 1, ops
    ops = _device_ops(lambda: prefilter_scores_cuda(x, basis))
    assert len(ops) == 1 and "prefilter_kernel" in ops[0], ops


# ------------------------------------------------------------ heavy hitter
def _hh_cfg(policy, option, bmax):
    from repro_torch.core import heavy_hitter as hh

    kw = dict(capacity=bmax, admit_prob=0.3, policy=hh.Policy(policy), cms_width=64)
    if option == "morris":
        kw["morris"] = True
    elif option == "gate":
        kw["gate_below_capacity"] = True
    elif option == "adaptive":
        kw.update(capacity=bmax // 2, max_capacity=bmax, adaptive=True, window=32,
                  b_step=16, novel_hi=0.5, novel_lo=0.2)
    return hh.HHConfig(**kw)


def _hh_state(cfg, dev, rng, fill):
    """A state whose first ``fill`` share of the active slots is occupied
    (distinct labels, small counts; Morris exponents), scalars as init's."""
    from repro_torch.core import heavy_hitter as hh

    st = hh.init(cfg, dev)
    cap = cfg.capacity
    n = int(cap * fill)
    labels = np.full(cfg.bmax(), -1, np.int32)
    labels[:n] = rng.permutation(3 * cap)[:n]
    counts = np.zeros(cfg.bmax(), np.int32)
    counts[:n] = rng.integers(0, 6 if cfg.morris else 9, n)
    holes = rng.random(cap) < 0.05            # empty slots among the occupied
    labels[:cap][holes] = -1
    counts[:cap][holes] = 0
    return st._replace(labels=torch.from_numpy(labels).to(dev),
                       counts=torch.from_numpy(counts).to(dev))


def _hh_labels(rng, B, cap, drop=0.2):
    """Zipf-skewed labels over 3 x capacity clusters, ``drop`` of them -1."""
    lab = (rng.zipf(1.3, size=B) - 1) % (3 * cap)
    lab[rng.random(B) < drop] = -1
    return torch.from_numpy(lab.astype(np.int32))


def _hh_equal(got, want):
    (s_k, i_k), (s_p, i_p) = got, want
    for name, a, b in zip(s_p._fields, s_k, s_p):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name in i_p:
        assert i_k[name].dtype == i_p[name].dtype, name
        assert torch.equal(i_k[name], i_p[name]), name


@pytest.mark.parametrize("B", [0, 1, 256])
@pytest.mark.parametrize("bmax", [4218, 8436])
@pytest.mark.parametrize("option", ["exact", "morris", "gate", "adaptive"])
@pytest.mark.parametrize("policy", [0, 1, 2, 3])
def test_heavy_hitter_kernel_matches_plain(cuda, policy, option, bmax, B):
    """Two batches in a row on a nearly full counter (so arrivals hit,
    insert and evict), the same draws into both: every state leaf and
    info entry equal, bit for bit."""
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda
    from repro_torch.kernels.heavy_hitter.ref import update_batch_ref

    cfg = _hh_cfg(policy, option, bmax)
    rng = np.random.default_rng(policy * 10 + B)
    g = torch.Generator(device=cuda).manual_seed(policy)
    st_k = st_p = _hh_state(cfg, cuda, rng, fill=0.97)
    for _ in range(2):
        labels = _hh_labels(rng, B, cfg.capacity).to(cuda)
        draws = hh.draw(cfg, B, g, cuda)
        before = COUNTS["heavy_hitter"].kernel
        got = update_batch_cuda(cfg, st_k, labels, draws)
        want = update_batch_ref(cfg, st_p, labels, draws)
        torch.cuda.synchronize()
        assert COUNTS["heavy_hitter"].kernel == before + (B > 0)
        _hh_equal(got, want)
        st_k, st_p = got[0], want[0]
    if B == 256 and option != "adaptive":
        assert int(st_k.total_writes) > 0


@pytest.mark.parametrize("policy", [0, 1, 2, 3])
def test_heavy_hitter_kernel_dropped_batch_closes_a_window(cuda, policy):
    """An all-dropped batch on a state whose window is already full (a
    merged state can arrive so): the adaptive step fires on the first
    dropped arrival and nothing else moves."""
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda
    from repro_torch.kernels.heavy_hitter.ref import update_batch_ref

    cfg = _hh_cfg(policy, "adaptive", 200)
    rng = np.random.default_rng(policy)
    for novel in (30, 2):                 # grow, then shrink
        st = _hh_state(cfg, cuda, rng, fill=0.5)._replace(
            seen_in_window=torch.tensor(cfg.window + 3, dtype=torch.int32, device=cuda),
            novel_in_window=torch.tensor(novel, dtype=torch.int32, device=cuda),
            admit_prob=torch.tensor(0.1, device=cuda),
            active_capacity=torch.tensor(cfg.capacity + 16, dtype=torch.int32,
                                         device=cuda))
        labels = torch.full((64,), -1, dtype=torch.int32, device=cuda)
        draws = hh.draw(cfg, 64, torch.Generator(device=cuda).manual_seed(1), cuda)
        got = update_batch_cuda(cfg, st, labels, draws)
        want = update_batch_ref(cfg, st, labels, draws)
        _hh_equal(got, want)
        assert int(got[0].seen_in_window) == 0
        assert int(got[0].active_capacity) != cfg.capacity + 16


def test_heavy_hitter_kernel_refuses_a_bmax_past_shared_memory(cuda):
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda

    cfg = hh.HHConfig(capacity=30_000)
    draws = hh.draw(cfg, 4, torch.Generator(device=cuda).manual_seed(0), cuda)
    with pytest.raises(ValueError, match="shared memory"):
        update_batch_cuda(cfg, hh.init(cfg, cuda),
                          torch.zeros((4,), dtype=torch.int32, device=cuda), draws)


def _hh_run(cfg, state, batches, dev, seed=0, draws_fn=None):
    """Each batch of labels through the kernel and the plain loop, from the
    same state and draws; every leaf held equal after each. Returns the
    last state and the info of every batch."""
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda
    from repro_torch.kernels.heavy_hitter.ref import update_batch_ref

    g = torch.Generator(device=dev).manual_seed(seed)
    st_k = st_p = state
    infos = []
    for labels in batches:
        labels = torch.as_tensor(np.asarray(labels, np.int32)).to(dev)
        draws = hh.draw(cfg, labels.shape[0], g, dev)
        if draws_fn is not None:
            draws = draws_fn(draws)
        got = update_batch_cuda(cfg, st_k, labels, draws)
        want = update_batch_ref(cfg, st_p, labels, draws)
        torch.cuda.synchronize()
        _hh_equal(got, want)
        st_k, st_p = got[0], want[0]
        infos.append(got[1])
    return st_k, infos


def _hh_with(state, dev, labels, counts, **scalars):
    st = state._replace(labels=torch.as_tensor(np.asarray(labels, np.int32)).to(dev),
                        counts=torch.as_tensor(np.asarray(counts, np.int32)).to(dev))
    for name, v in scalars.items():
        st = st._replace(**{name: torch.tensor(v, dtype=getattr(st, name).dtype,
                                               device=dev)})
    return st


@pytest.mark.parametrize("policy", [0, 1, 2, 3])
def test_heavy_hitter_kernel_label_duplicated_across_bt(cuda, policy):
    """A label held at or past B_t is a miss, so an insert below B_t
    duplicates it; a grow then exposes both copies (the lower one hits),
    and evicting the lower copy exposes the upper one. Adaptive, capacity
    16 of 48: slots 16..39 hold labels 0..23 (count 5); labels 0..15 are
    inserted below (count 1), the window grows B_t to 32, then novel
    labels evict (the lower copies hold the least counts) and labels
    0..15 arrive again."""
    from repro_torch.core import heavy_hitter as hh

    cfg = hh.HHConfig(capacity=16, max_capacity=48, adaptive=True, window=16, b_step=16,
                      novel_hi=0.5, novel_lo=0.1, admit_prob=1.0, u_max=1.0,
                      policy=hh.Policy(policy), cms_width=64)
    labels = np.full(48, -1)
    labels[16:40] = np.arange(24)
    counts = np.zeros(48)
    counts[16:40] = 5
    st = _hh_with(hh.init(cfg, cuda), cuda, labels, counts)
    rng = np.random.default_rng(policy)
    batches = [np.arange(16), np.concatenate([100 + np.arange(8), np.arange(16)]),
               rng.permutation(np.concatenate([np.arange(24), 200 + np.arange(24)]))]
    st, infos = _hh_run(cfg, st, batches, cuda, seed=policy)
    assert int(infos[0]["admitted"].sum()) == 16            # the duplicates went in
    if policy in (1, 2):   # the least count is the lower copy of label 0, at slot 0
        assert int(infos[1]["evicted_label"][0]) == 0
        assert int(infos[1]["slot"][8]) == 16               # label 0 hits its upper copy


@pytest.mark.parametrize("policy", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["same_home", "same_residue", "extremes"])
def test_heavy_hitter_kernel_table_collisions(cuda, policy, kind):
    """Labels that collide in the kernel's label -> slot table (the same
    home entry, or the same residue modulo its size), and labels near 0
    and INT32_MAX: hits, inserts and evictions through long probe chains."""
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import heavy_hitter_plan, table_home

    cfg = hh.HHConfig(capacity=64, admit_prob=0.5, policy=hh.Policy(policy), cms_width=64)
    T = heavy_hitter_plan(64, 256 if policy == 3 else 0, gumbel=policy == 0).table
    if kind == "same_home":
        pool = list(itertools.islice((x for x in range(1 << 20)
                                      if table_home(x, T) == T - 1), 100))
    elif kind == "same_residue":
        pool = [5 + T * k for k in range(100)]
    else:
        pool = list(range(50)) + [2**31 - 1 - k for k in range(50)]
    rng = np.random.default_rng(policy)
    batches = [np.asarray(pool)[rng.integers(0, len(pool), 256)] for _ in range(4)]
    st, _ = _hh_run(cfg, hh.init(cfg, cuda), batches, cuda, seed=policy)
    assert int(st.total_writes) > 0


@pytest.mark.parametrize("option", ["exact", "morris", "gate", "adaptive"])
@pytest.mark.parametrize("policy", [0, 1, 2, 3])
def test_heavy_hitter_kernel_one_label_repeated(cuda, policy, option):
    """One label through a whole batch: one insert, then hits only."""
    st_cfg = _hh_cfg(policy, option, 4218)
    rng = np.random.default_rng(policy)
    st = _hh_state(st_cfg, cuda, rng, fill=0.5)
    st, infos = _hh_run(st_cfg, st, [np.full(256, 77_777), np.full(300, 77_777)], cuda)
    assert bool(infos[1]["hit"].all()) or option == "gate"


@pytest.mark.parametrize("policy", [0, 1, 2, 3])
@pytest.mark.parametrize("gate", ["rejects", "admits"])
def test_heavy_hitter_kernel_full_counter_every_miss(cuda, policy, gate):
    """A full counter (bmax 4218) fed 256 novel labels: a gate that rejects
    every miss (every uniform above u_t) and one that admits every miss
    (u_t = 1), so MIN_EVICT and RANDOM_EVICT evict on no arrival or on
    every one (SPACE_SAVING always evicts; COUNT_MIN as its sketch says)."""
    from repro_torch.core import heavy_hitter as hh

    cfg = hh.HHConfig(capacity=4218, admit_prob=0.5 if gate == "rejects" else 1.0,
                      policy=hh.Policy(policy), cms_width=64)
    rng = np.random.default_rng(policy)
    st = _hh_with(hh.init(cfg, cuda), cuda, rng.permutation(10_000)[:4218],
                  rng.integers(0, 9, 4218))

    def draws_fn(d):
        if gate == "rejects":
            d["uniforms"] = 0.75 + 0.25 * d["uniforms"]
        return d

    novel = 20_000 + np.arange(512)
    st, infos = _hh_run(cfg, st, [novel[:256], novel[256:]], cuda, draws_fn=draws_fn)
    evictions = sum(int(i["admitted"].sum()) for i in infos)
    if policy in (0, 1):
        assert evictions == (0 if gate == "rejects" else 512)
    elif policy == 2:
        assert evictions == 512


@pytest.mark.parametrize("bmax", [4218, 8436, 20000])
@pytest.mark.parametrize("evict", ["none", "every"])
def test_heavy_hitter_kernel_random_evict_rows(cuda, bmax, evict):
    """RANDOM_EVICT with no eviction (a counter that never fills: no
    Gumbel row is read) and with an eviction on every arrival (a full
    counter, u_t = 1, novel labels: every arrival reads its row; staged
    through shared memory at 4218 and 8436, read from device memory at
    20000, where the rows do not fit beside the table)."""
    from repro_torch.core import heavy_hitter as hh

    cfg = hh.HHConfig(capacity=bmax, admit_prob=1.0, policy=hh.Policy.RANDOM_EVICT)
    rng = np.random.default_rng(bmax)
    st = hh.init(cfg, cuda)
    if evict == "every":
        st = _hh_with(st, cuda, rng.permutation(4 * bmax)[:bmax], rng.integers(0, 9, bmax))
        batches = [10 * bmax + np.arange(256 * k, 256 * (k + 1)) for k in range(2)]
    else:
        batches = [rng.integers(0, 3 * 256, 256) for _ in range(2)]
    st, infos = _hh_run(cfg, st, batches, cuda, seed=bmax)
    assert int(st.total_evictions) == (512 if evict == "every" else 0)


@pytest.mark.parametrize("B", [1025, 3000])
@pytest.mark.parametrize("option", ["exact", "adaptive"])
@pytest.mark.parametrize("policy", [0, 1, 2, 3])
def test_heavy_hitter_kernel_batches_past_one_chunk(cuda, policy, option, B):
    """B past the kernel's 256-arrival chunk: dropped runs that cross a
    chunk's edge, Gumbel rows staged across chunks."""
    cfg = _hh_cfg(policy, option, 4218)
    rng = np.random.default_rng(B + policy)
    st = _hh_state(cfg, cuda, rng, fill=0.97)
    lab = _hh_labels(rng, B, cfg.capacity, drop=0.3).numpy()
    lab[250:270] = -1                       # a dropped run across the first edge
    _hh_run(cfg, st, [lab, _hh_labels(rng, B, cfg.capacity).numpy()], cuda, seed=B)


@pytest.mark.parametrize("policy", [0, 1, 2, 3])
def test_heavy_hitter_kernel_largest_bmax_the_plan_takes(cuda, policy):
    """The plan's ceiling (the table at load 0.8 beside the slots): the
    kernel launches there and equals its loop."""
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import heavy_hitter_plan, max_bmax

    cells = 4 * 64 if policy == 3 else 0
    bmax = max_bmax(cells)
    assert bmax >= 20_000 and heavy_hitter_plan(bmax, cells).table < 1.3 * bmax
    cfg = hh.HHConfig(capacity=bmax, admit_prob=0.3, policy=hh.Policy(policy), cms_width=64)
    rng = np.random.default_rng(policy)
    st = _hh_state(cfg, cuda, rng, fill=0.99)
    _hh_run(cfg, st, [_hh_labels(rng, 256, bmax).numpy() for _ in range(2)], cuda)


def test_async_server_on_card_answers_from_published_snapshots(cuda):
    """An AsyncServer that publishes after every batch, so old snapshots
    are dropped (and their blocks freed to the ingest stream) while
    flushes run: every ticket answered once, every sampled answer equal,
    bit for bit, to the same query on a copy of the snapshot it names
    (each snapshot copied to the host as it is published)."""
    import threading

    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.engine.engine import Engine, ServingSnapshot
    from repro_torch.kernels import counts
    from repro_torch.serve.runtime import AsyncServer, ServerConfig

    class HostCopies(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.copies = {}

        def publish(self):
            snap = super().publish()
            self.copies[snap.version] = _to(snap, "cpu")
            return snap

    def _to(snap, dev):
        return ServingSnapshot(
            index=snap.index._replace(**{f: getattr(snap.index, f).to(dev)
                                         for f in ("vectors", "ids", "valid")}),
            route_labels=snap.route_labels.to(dev),
            store=type(snap.store)(*(t.to(dev) for t in snap.store)),
            version=snap.version, published_at=snap.published_at)

    cfg = paper_pipeline_config(dim=64, k=64, capacity=64, store_depth=8,
                                update_interval=32, alpha=0.0, store_dtype="int8")
    rng = np.random.default_rng(5)
    eng = HostCopies(cfg, 0, rng.normal(size=(128, 64)).astype(np.float32),
                     device=cuda)
    server = AsyncServer(cfg, ServerConfig(max_batch=16, max_wait_ms=0.0, topk=5,
                                           two_stage=True, nprobe=4),
                         engine=eng, publish_every=1, queue_max=4)
    qs = rng.normal(size=(600, 64)).astype(np.float32)
    tickets, lock = {}, threading.Lock()

    def submitter():
        for qv in qs:
            t = server.submit(qv)
            with lock:
                tickets[t] = qv

    counts.reset_all()
    sub = threading.Thread(target=submitter)
    sub.start()
    answers = []
    for step in range(40):
        b = rng.normal(size=(64, 64)).astype(np.float32)
        server.ingest(b, np.arange(step * 64, step * 64 + 64, dtype=np.int32))
        answers += server.flush()
    sub.join(60)
    assert not sub.is_alive()
    server.sync(timeout=60)
    answers += server.drain()
    server.close(timeout=60)
    snap = counts.snapshot()
    assert all(snap[n]["kernel"] > 0 for n in ("admit", "heavy_hitter", "serve")), snap
    assert all(c["plain"] == 0 for c in snap.values()), snap
    assert sorted(a["ticket"] for a in answers) == sorted(tickets) == list(range(600))
    assert len({a["snapshot_version"] for a in answers}) > 5
    assert server.freshness_stats()["lag_docs"] == 0
    for a in answers[::7]:
        ref = _to(eng.copies[a["snapshot_version"]], cuda)
        s, _, ids, _ = eng.query_snapshot(ref, tickets[a["ticket"]][None], 5,
                                          two_stage=True, nprobe=4)
        assert np.array_equal(a["doc_ids"], ids[0].cpu().numpy())
        assert np.array_equal(a["scores"], s[0].cpu().numpy())


# ------------------------------------------- the serving cache on the card
def _main_snapshot(cuda, store_dtype, C=4218, cap=4218, depth=64, d=384):
    """A snapshot at the main path's shapes: a unit prototype index with a
    few dead slots, route labels over C clusters, rings 70% live."""
    from repro_torch.core.index import FlatIndex
    from repro_torch.engine.engine import ServingSnapshot
    from repro_torch.store import docstore, quant

    g = torch.Generator(device=cuda).manual_seed(7)
    vec = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.97
    labels = torch.randperm(C, generator=g, device=cuda)[:cap].to(torch.int32)
    labels = torch.where(torch.rand((cap,), generator=g, device=cuda) < 0.02,
                         -1, labels)
    rows = l2_normalize(torch.randn((C, depth, d), generator=g, device=cuda))
    if store_dtype == "int8":
        embs, scales = quant.quantize_int8(rows, dim=-1)
    else:
        embs, scales = rows, torch.ones((C, depth), device=cuda)
    live = torch.rand((C, depth), generator=g, device=cuda) < 0.7
    ids = torch.where(live, torch.arange(C * depth, device=cuda,
                                         dtype=torch.int32).view(C, depth), -1)
    store = docstore.DocStore(embs.contiguous(), ids, ids.clone(),
                              torch.full((C,), depth, dtype=torch.int32,
                                         device=cuda), scales.contiguous())
    index = FlatIndex(vec, labels.clone(), valid, 1)
    return ServingSnapshot(index, torch.where(valid, labels, -1), store, 1)


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_serve_answer_independent_of_batch_and_ring_source(cuda, store_dtype):
    """The cache's contract on the card: a query's serve answer (scores,
    positions, routes) and its route pass (the mips kernel) do not depend
    on how many queries share the launch (Q = 1, 7, 64), and serving it
    over a 256-cluster hot tier with remapped labels equals serving it
    over the 4218-ring store, bit for bit."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.engine import stages
    from repro_torch.engine.engine import routed_query

    cfg = paper_pipeline_config(dim=384, k=4218, capacity=4218,
                                store_depth=64, store_dtype=store_dtype)
    snap = _main_snapshot(cuda, store_dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((64, 384), generator=g, device=cuda)
    full = routed_query(cfg, snap.index, snap.route_labels, snap.store, q,
                        10, 8)
    rfull = stages.route(cfg.index, snap.index, snap.route_labels, q, 8)
    for n in (1, 7, 64):
        for lo in range(0, 64, n):
            part = routed_query(cfg, snap.index, snap.route_labels,
                                snap.store, q[lo:lo + n].contiguous(), 10, 8)
            for a, b in zip(part, full):
                assert torch.equal(a, b[lo:lo + n])
            rp = stages.route(cfg.index, snap.index, snap.route_labels,
                              q[lo:lo + n].contiguous(), 8)
            assert torch.equal(rp, rfull[lo:lo + n])
    # the hot tier: the first queries' routed clusters, padded to 256 rings
    routes = full[4].cpu().numpy()
    pinned = []
    for row in routes:
        new = [c for c in row if c >= 0 and c not in pinned]
        if len(pinned) + len(new) > 256:
            break
        pinned += new
    covered = len([r for r in routes if set(r[r >= 0]) <= set(pinned)])
    assert covered >= 16
    clusters = np.zeros(256, np.int32)
    clusters[:len(pinned)] = pinned
    valid = np.arange(256) < len(pinned)
    tier = stages.gather_rings(snap.store, torch.from_numpy(clusters).to(cuda),
                               torch.from_numpy(valid).to(cuda))
    c2s = np.full(4218, -1, np.int32)
    c2s[pinned] = np.arange(len(pinned), dtype=np.int32)
    lab = snap.route_labels.cpu().numpy()
    hot = torch.from_numpy(np.where(lab >= 0, c2s[np.maximum(lab, 0)],
                                    -1).astype(np.int32)).to(cuda)
    qc = q[:covered].contiguous()
    got = routed_query(cfg, snap.index, hot, tier, qc, 10, 8)
    slot2c = torch.from_numpy(np.where(valid, clusters, -1)).to(cuda)
    assert torch.equal(got[0], full[0][:covered])
    assert torch.equal(got[2], full[2][:covered])
    assert torch.equal(torch.where(got[3] >= 0, slot2c[got[3].clamp(min=0).long()],
                                   -1), full[3][:covered])
    assert torch.equal(torch.where(got[4] >= 0, slot2c[got[4].clamp(min=0).long()],
                                   -1), full[4][:covered])


def _full_engine(cuda, store_dtype, seed=0):
    """The main path's engine: the 150 MB config, warmed up on the head of
    the NYT-like stream (so admission keeps rows); returns (engine, the
    stream, continued)."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.core import pipeline
    from repro_torch.data.streams import make_stream
    from repro_torch.engine.engine import Engine

    cfg = pipeline.budget_to_config(150.0, dim=384, base=paper_pipeline_config(
        dim=384, store_depth=64, store_dtype=store_dtype))
    stream = make_stream("nyt", dim=384)
    warm = np.concatenate([stream.next_batch(256)["embedding"]
                           for _ in range(-(-2 * cfg.clus.num_clusters // 256))])
    return Engine(cfg, seed, warm, device=cuda), stream


def _assert_states_equal(a, b):
    from repro_torch.train import checkpoint as ckpt

    fa, fb = ckpt.flatten_tree(a), ckpt.flatten_tree(b)
    assert fa.keys() == fb.keys()
    bad = [k for k in fa if not np.array_equal(ckpt.to_host(fa[k]),
                                               ckpt.to_host(fb[k]))]
    assert not bad, f"leaves differ: {bad}"


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_ingest_is_deterministic_on_card(cuda, store_dtype):
    """The precondition of bit-identical recovery: the same state and the
    same batches give bit-equal states — one engine on the default
    stream, one on a side stream (where an AsyncServer ingests)."""
    a, stream = _full_engine(cuda, store_dtype)
    b, _ = _full_engine(cuda, store_dtype)
    batches = [stream.next_batch(256) for _ in range(6)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    for bt in batches:
        a.ingest(bt["embedding"], bt["doc_id"])
        with torch.cuda.stream(side):
            b.ingest(bt["embedding"], bt["doc_id"])
    torch.cuda.synchronize()
    assert int(a.state.store.ptr.sum()) > 0
    _assert_states_equal(a.state, b.state)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Full then delta checkpoints of a card-resident state, copied on a
    side stream with no device sync, restore leaf for leaf onto the card;
    the restored generator lives on the card and continues the saved
    one's draws."""
    from repro_torch.serve.durability import CheckpointStore

    eng, stream = _full_engine(cuda, "int8")
    store = CheckpointStore(str(tmp_path))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    modes = []
    with torch.cuda.stream(side):
        for seq in range(3):
            for _ in range(2):
                bt = stream.next_batch(256)
                eng.ingest(bt["embedding"], bt["doc_id"])
            modes.append(store.save(seq, eng.state)["mode"])
        store.wait()
    assert modes == ["full", "delta", "delta"]
    assert store.last_save["copy_ms"] > 0.0
    assert int(eng.state.store.ptr.sum()) > 0
    fresh, _ = _full_engine(cuda, "int8", seed=9)
    restored, meta = store.restore(fresh.state)
    assert meta["seq"] == 2
    assert restored.gen.device.type == "cuda"
    assert restored.store.embs.device.type == "cuda"
    _assert_states_equal(eng.state, restored)
    a = torch.rand(4, generator=eng.state.gen, device=cuda)
    b = torch.rand(4, generator=restored.gen, device=cuda)
    assert torch.equal(a, b)


def test_query_side_heavy_hitter_matches_plain(cuda):
    """The hot set's counter (capacity 64, admit_prob 1, MIN_EVICT, B = 64
    route signatures: 31-bit crc labels, Zipf-repeated, padded with -1)
    against its plain loop, every leaf exact, over many flushes."""
    from repro_torch.core import heavy_hitter as hh
    from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda
    from repro_torch.kernels.heavy_hitter.ref import update_batch_ref

    cfg = hh.HHConfig(capacity=64, admit_prob=1.0, policy=hh.Policy.MIN_EVICT)
    rng = np.random.default_rng(2)
    sigs = rng.integers(0, 2**31 - 1, size=300).astype(np.int32)
    g = torch.Generator(device=cuda).manual_seed(0)
    st_k = st_p = hh.init(cfg, cuda)
    for flush in range(40):
        n = int(rng.integers(1, 65))
        lab = np.full(64, -1, np.int32)
        lab[:n] = sigs[np.minimum(rng.zipf(1.1, size=n) - 1, 299)]
        labels = torch.from_numpy(lab).to(cuda)
        draws = hh.draw(cfg, 64, g, cuda)
        got = update_batch_cuda(cfg, st_k, labels, draws)
        want = update_batch_ref(cfg, st_p, labels, draws)
        _hh_equal(got, want)
        st_k, st_p = got[0], want[0]
    assert int(st_k.total_evictions) > 0 and int(st_k.total_writes) > 0


def test_cached_async_server_on_card_is_exact(cuda):
    """A cached + hot AsyncServer on the card while ingest runs: every
    ticket answered once, every answer equal, bit for bit, to its query
    served alone on a copy of the snapshot it names, route-checked hits
    after a publish that moves no cluster included; the route pass (serve's
    route-only entry), the hot tier and the query-side counter ran on
    their kernels, and no route order was left unwitnessed."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.engine.engine import Engine, ServingSnapshot
    from repro_torch.kernels import counts
    from repro_torch.serve.runtime import AsyncServer, ServerConfig

    class HostCopies(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.copies = {}

        def publish(self):
            snap = super().publish()
            self.copies[snap.version] = _snap_to(snap, "cpu")
            return snap

    cfg = paper_pipeline_config(dim=64, k=64, capacity=64, store_depth=8,
                                update_interval=32, alpha=0.0, store_dtype="int8")
    rng = np.random.default_rng(6)
    eng = HostCopies(cfg, 0, rng.normal(size=(128, 64)).astype(np.float32),
                     device=cuda)
    server = AsyncServer(cfg, ServerConfig(
        max_batch=16, max_wait_ms=0.0, topk=5, two_stage=True, nprobe=4,
        cache_entries=48, hotset=True, pin_budget_mb=0.05, hotset_capacity=16,
        hotset_refresh=2, hotset_min_count=2),
        engine=eng, publish_every=2, queue_max=4)
    pool = rng.normal(size=(96, 64)).astype(np.float32)
    pick = np.minimum(rng.zipf(1.1, size=480) - 1, 95)
    counts.reset_all()
    answers, asked = [], {}
    for step in range(30):
        b = rng.normal(size=(64, 64)).astype(np.float32)
        server.ingest(b, np.arange(step * 64, step * 64 + 64, dtype=np.int32))
        for i in pick[step * 16:(step + 1) * 16]:
            asked[server.submit(pool[i])] = pool[i]
        answers += server.flush()
    server.sync(timeout=60)
    answers += server.drain()
    # a publish that moves no cluster (a batch of padding rows) keeps every
    # entry: the same queries asked again go through the route check
    again = pool[pick[-16:]]
    for rnd in range(2):
        if rnd:
            before = server._result_cache.stats()
            server.ingest(np.zeros((64, 64), np.float32), np.full((64,), -1, np.int32))
            server.sync(timeout=60)
            assert eng.last_publish_info["mode"] == "republish"
        for q in again:
            asked[server.submit(q)] = q
        answers += server.flush()
    rs = server._result_cache.stats()
    assert rs["rekeyed"] > before["rekeyed"]
    assert rs["hits"] - rs["hits_exact"] > before["hits"] - before["hits_exact"]
    server.close(timeout=60)
    snap = counts.snapshot()
    # the route pass is serve's route-only entry, so mips never launches
    assert all(snap[n]["kernel"] > 0 for n in ("serve_route", "serve", "heavy_hitter")), snap
    assert snap["mips"]["kernel"] == 0, snap
    assert all(c["plain"] == 0 for c in snap.values()), snap
    assert server.route_near_ties == 0 and server.route_mismatches == 0
    assert sorted(a["ticket"] for a in answers) == sorted(asked)
    cs = server.cache_stats()
    assert cs["hits"] > 0 and cs["hot_served"] > 0 and cs["tier_rebuilds"] > 0
    for a in answers:
        ref = _snap_to(eng.copies[a["snapshot_version"]], cuda)
        s, _, ids, cl = eng.query_snapshot(ref, asked[a["ticket"]][None], 5,
                                           two_stage=True, nprobe=4)
        assert np.array_equal(a["scores"], s[0].cpu().numpy())
        assert np.array_equal(a["doc_ids"], ids[0].cpu().numpy())
        assert np.array_equal(a["clusters"], cl[0].cpu().numpy())


def _snap_to(snap, dev):
    from repro_torch.engine.engine import ServingSnapshot

    return ServingSnapshot(
        index=snap.index._replace(**{f: getattr(snap.index, f).to(dev)
                                     for f in ("vectors", "ids", "valid")}),
        route_labels=snap.route_labels.to(dev),
        store=type(snap.store)(*(t.to(dev) for t in snap.store)),
        version=snap.version, published_at=snap.published_at)


# ------------------------------------------------------------ sharded
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("Q", [1, 64])
@pytest.mark.parametrize("M", [2, 4])
def test_serve_kernel_under_a_localized_label_table(cuda, M, Q, quantized):
    """The sharded engine's serve call: every shard m of M serves its kl
    rings under the label table localized to it — a valid slot whose
    cluster lies on another shard carries label -1 (1/2 and 3/4 of the
    table away). The kernel keeps such a slot as a dead route position,
    as the plain version does, never skipping to the next slot."""
    g = torch.Generator(device=cuda).manual_seed(M * 100 + Q)
    d, cap, C, D, P, k = 384, 4218, 4218, 64, 8, 10
    kl = C // M
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.9
    labels = torch.randperm(C, generator=g, device=cuda).int()
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    embs, live, scales = _ring_store(g, kl, D, d, quantized)
    routes = []
    for m in range(M):
        local = torch.where((labels >= m * kl) & (labels < (m + 1) * kl),
                            labels - m * kl, -1).int()
        assert float((local < 0).float().mean()) >= (M - 1) / M - 0.01
        s_k, p_k, r_k = _hold_serve(q, v, valid, local, embs, live, k, P, scales)
        assert r_k.shape == (Q, P)
        routes.append(torch.where(r_k >= 0, r_k + m * kl, -1))
    # each route position is live on exactly one shard: their max is the
    # global route list, the table's labels of the top-P valid slots
    glob = torch.stack(routes).max(dim=0).values
    assert bool(((torch.stack(routes) >= 0).sum(0) <= 1).all())
    top = torch.sort(torch.where(valid[None], q @ v.T, NEG_INF), dim=1,
                     descending=True, stable=True).indices[:, :P]
    want = labels[top]
    assert int((glob == want).all(dim=1).sum()) >= Q - 1   # a near-tie at most


@pytest.mark.parametrize("M", [2, 4])
def test_rerank_kernel_under_localized_routes(cuda, M):
    """The staged sharded stage 2: global routes localized to each shard
    (other shards' clusters -1), reranked over the shard's rings."""
    g = torch.Generator(device=cuda).manual_seed(M)
    Q, d, C, D, P, k = 64, 384, 4218, 64, 8, 10
    kl = C // M
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    embs, live, scales = _ring_store(g, kl, D, d, True)
    routes = torch.randint(0, C, (Q, P), generator=g, device=cuda).int()
    for m in range(M):
        local = torch.where((routes >= m * kl) & (routes < (m + 1) * kl),
                            routes - m * kl, -1).int()
        s_k, p_k = _hold_rerank(q, embs, live, local, k, scales)
        dead = (local < 0).all(dim=1)
        assert bool((p_k[dead] == -1).all())


@pytest.mark.parametrize("store_dtype", ["int8", "fp32"])
def test_sharded_engine_on_card_matches_single_device(cuda, store_dtype):
    """A 2 x 2 ShardedEngine on the card (every shard on one device):
    each data shard's state equals a single-device Engine replaying its
    sub-stream from ``shard_init_state``, bit for bit; the published
    snapshot equals ``reconcile_states``; fused and staged two-stage and
    prototype-only answers equal the single-device query over the merged
    snapshot (near-tie rule); admit and heavy_hitter launch twice a
    batch, serve twice a fused flush, rerank twice a staged one."""
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.engine.engine import Engine, snapshot_query_impl
    from repro_torch.engine.sharded import ShardedEngine, reconcile_states
    from repro_torch.kernels import counts
    from repro_torch.launch.mesh import make_streaming_mesh
    from repro_torch.store import docstore

    cfg = paper_pipeline_config(dim=64, k=64, capacity=48, store_depth=8,
                                update_interval=64, alpha=0.0,
                                store_dtype=store_dtype)
    rng = np.random.default_rng(0)
    warm = rng.normal(size=(64, 64)).astype(np.float32)
    eng = ShardedEngine(cfg, make_streaming_mesh(2, 2), 0, warmup=warm,
                        reconcile_every=10**9, reconcile_mode="delta")
    singles = [Engine(cfg, state=ShardedEngine.shard_init_state(
        cfg, 0, s, 2, warm)) for s in range(2)]
    sharded = {"admit": 0, "heavy_hitter": 0}
    for step in range(4):
        x = rng.normal(size=(64, 64)).astype(np.float32)
        ids = np.arange(step * 64, step * 64 + 64, dtype=np.int32)
        counts.reset_all()
        eng.ingest(x, ids)
        for name in sharded:
            sharded[name] += counts.COUNTS[name].kernel
        for s, single in enumerate(singles):
            single.ingest(x[s * 32:(s + 1) * 32], ids[s * 32:(s + 1) * 32])
        eng.reconcile()
    snap = eng.serving
    assert sharded == {"admit": 8, "heavy_hitter": 8}, sharded
    from repro_torch.train import checkpoint as ckpt_lib
    for s, single in enumerate(singles):
        fa = ckpt_lib.flatten_tree(single.state)
        fb = ckpt_lib.flatten_tree(eng.shards[s])
        assert [k for k in fa if not torch.equal(
            torch.as_tensor(ckpt_lib.to_host(fa[k])),
            torch.as_tensor(ckpt_lib.to_host(fb[k])))] == []
    oracle = reconcile_states(cfg, [single.state for single in singles])
    full = docstore.DocStore(*(torch.cat(ts) for ts in zip(*snap.store)))
    for a, b in zip((*oracle.index[:3], oracle.route_labels, *oracle.store),
                    (*snap.index[:3], snap.route_labels, *full)):
        assert torch.equal(a, b)
    q = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).cuda()
    for two, staged, name, n in ((True, False, "serve", 2), (True, True, "rerank", 2),
                                 (False, False, "mips", 1)):
        before = counts.COUNTS[name].kernel
        got = eng.query_snapshot(snap, q, 10, two_stage=two, nprobe=8,
                                 staged=staged)
        assert counts.COUNTS[name].kernel == before + n
        want = snapshot_query_impl(cfg, snap.index, snap.route_labels, full, q, 10,
                                   two_stage=two, nprobe=8)
        assert _close(got[0], want[0])
        gap = torch.cat([want[0][:, :-1] - want[0][:, 1:],
                         torch.full_like(want[0][:, :1], np.inf)], dim=1)
        tie = (gap < TIE) | torch.cat([torch.zeros_like(gap[:, :1], dtype=torch.bool),
                                       gap[:, :-1] < TIE], dim=1)
        assert bool(((got[2] == want[2]) | tie).all()), name


# ------------------------------------------------- serve's route-only entry
def _hold_routes(q, v, valid, labels, P, embs=None, live=None):
    """The route-only entry against the fused kernel's routes (bit for
    bit) and its plain version (equal but after a near-tie among the plain
    route scores). Returns its routes."""
    from repro_torch.kernels.serve.ref import serve_routes_ref
    from repro_torch.kernels.serve.serve import serve_routes_cuda, serve_topk_cuda

    if embs is None:
        C = int(labels.max()) + 1
        embs = torch.zeros((C, 2, q.shape[1]), device=q.device)
        live = torch.ones((C, 2), dtype=torch.bool, device=q.device)
    before = COUNTS["serve_route"].kernel
    r_k = serve_routes_cuda(q, v, valid, labels, P)
    assert COUNTS["serve_route"].kernel == before + 1
    fused = serve_topk_cuda(q, q, v, valid, labels, embs, live, 1, P)[2]
    assert torch.equal(r_k, fused)
    r_p = serve_routes_ref(q, v, valid, labels, P)
    rs = torch.sort(torch.where(valid[None], q @ v.T, NEG_INF), dim=1,
                    descending=True).values[:, :P + 1]
    tie = ((rs[:, :-1] - rs[:, 1:]) < TIE).any(dim=1)
    assert bool(((r_k == r_p).all(dim=1) | tie).all())
    return r_k


@pytest.mark.parametrize("Q,cap,P", [(64, 4218, 8), (1, 4218, 8), (50, 100, 16),
                                     (33, 500, 64), (7, 65, 3)])
def test_serve_route_entry_is_the_fused_kernels_stage_one(cuda, Q, cap, P):
    """At the main path's shape, one query, the two-stage comparison
    method's (100 prototypes, nprobe 16), nprobe 64 (one route tile's
    width) and a tile edge: 10% invalid slots, 10% dead labels."""
    g = torch.Generator(device=cuda).manual_seed(Q + cap)
    d = 384
    v = l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    valid = torch.rand((cap,), generator=g, device=cuda) < 0.9
    labels = torch.randperm(cap, generator=g, device=cuda).to(torch.int32)
    labels[torch.rand((cap,), generator=g, device=cuda) < 0.1] = -1
    q = l2_normalize(torch.randn((Q, d), generator=g, device=cuda))
    r = _hold_routes(q, v, valid, labels, P)
    assert r.shape == (Q, P) and r.dtype == torch.int32


def test_serve_route_entry_one_ulp_apart(cuda):
    """Two index rows whose dots with a query differ by one ulp (and a
    pair that ties exactly, lowest slot first): the route-only entry
    orders them as the fused kernel does, bit for bit."""
    d, cap, P = 64, 200, 4
    g = torch.Generator(device=cuda).manual_seed(7)
    v = 0.01 * l2_normalize(torch.randn((cap, d), generator=g, device=cuda))
    q = torch.zeros((2, d), device=cuda)
    q[:, 0] = 1.0
    one = torch.tensor(1.0, device=cuda)
    v[17], v[150] = 0.0, 0.0
    v[17, 0] = one                                   # dot 1
    v[150, 0] = torch.nextafter(one, torch.tensor(2.0, device=cuda))   # 1 + ulp
    v[90], v[30] = v[17], v[17]                      # exact ties with row 17
    valid = torch.ones((cap,), dtype=torch.bool, device=cuda)
    labels = torch.arange(cap, dtype=torch.int32, device=cuda)
    r = _hold_routes(q, v, valid, labels, P)
    assert r[0].tolist() == [150, 17, 30, 90]


@pytest.mark.parametrize("Q,N", [(50, 1024), (50, 100), (50, 256), (1, 1024), (1, 100)])
def test_mips_kernel_at_the_baselines_shapes(cuda, Q, N):
    """The comparison methods' flat indexes (static 1024, full rebuild and
    the counters 100, reservoir 256) at d = 384, k = 10: rounds of 50
    queries and the QA's single questions; a third of the rows invalid."""
    g = torch.Generator(device=cuda).manual_seed(N)
    index = l2_normalize(torch.randn((N, 384), generator=g, device=cuda))
    valid = torch.rand((N,), generator=g, device=cuda) < 0.66
    q = l2_normalize(torch.randn((Q, 384), generator=g, device=cuda))
    _hold_mips(q, index, valid, 10)


@pytest.mark.parametrize("n,K,alpha", [(1, 100, 0.0), (5, 150, 0.1)])
def test_admit_kernel_at_the_baselines_shapes(cuda, n, K, alpha):
    """SAKR's admission (one basis vector, K = 100, alpha 0) and the
    streaming methods' (5 vectors, K = 150, alpha 0.1), 256 rows of
    d = 384, fp32 rows (SAKR's depth-0 store asks for none) and int8."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((256, 384), generator=g, device=cuda) + 0.5
    basis = l2_normalize(torch.randn((n, 384), generator=g, device=cuda))
    cent = l2_normalize(torch.randn((K, 384), generator=g, device=cuda))
    for store_dtype in ("fp32", "int8"):
        _hold_admit(x, basis, cent, alpha, None, store_dtype)


@pytest.mark.parametrize("method", ["heap_only", "sakr", "streaming"])
def test_heavy_hitter_kernel_at_the_baselines_options(cuda, method):
    """Heap-only (MIN_EVICT, capacity 100, u 0.05, labels over 512
    anchors), SAKR (SPACE_SAVING, capacity 100, u 1.0, over 100 clusters)
    and the streaming method (MIN_EVICT, capacity 100, u 0.05, over 150
    clusters, a fifth dropped): six batches of 256 from an empty counter,
    every leaf and info entry equal to the plain loop's."""
    from repro_torch.core import heavy_hitter as hh

    policy, u, clusters, drop = {"heap_only": (1, 0.05, 512, 0.0),
                                 "sakr": (2, 1.0, 100, 0.0),
                                 "streaming": (1, 0.05, 150, 0.2)}[method]
    cfg = hh.HHConfig(capacity=100, admit_prob=u, policy=hh.Policy(policy))
    rng = np.random.default_rng(policy)
    batches = []
    for _ in range(6):
        lab = (rng.zipf(1.2, size=256) - 1) % clusters
        lab[rng.random(256) < drop] = -1
        batches.append(lab)
    st, infos = _hh_run(cfg, hh.init(cfg, cuda), batches, cuda)
    assert int(hh.active_mask(st).sum()) > 0


# ----------------------------------------------------------- bag backward
def _bwd_run_lengths(L):
    """Run lengths whose sorted runs end on, one before and one after each
    chunk boundary (256 entries) up to 8192, then one run over two whole
    level-2 groups (16,384 entries each) that starts and ends inside a
    chunk, then ends on and around sort-tile boundaries (4096)."""
    cuts = sorted({256 * m + o for m in range(1, 32) for o in (-1, 0, 1)} | {8193, 49153}
                  | {4096 * m + o for m in range(13, 17) for o in (-1, 0, 1)})
    return np.diff([0, *cuts, L])


def _bag_bwd_inputs(case, cuda):
    """(table, idx, seg, bags, w, grad_out): MIND's profile bag at a cut
    batch (Zipf-like ids, a valid prefix, padding at row 0 with weight 0),
    every id on row 0 (the train launcher's dummy batch), Zipf 1.2 ids over
    all of 10^6 rows (most rows untouched), runs crossing each chunk, tile
    and level-2 group boundary (in the caller's order, so runs cross the
    sort's tiles too; every other row untouched), V = 1, V = 2^22 + 3 at
    d = 8 (three digit passes; ids at V - 1), L = 0, or N(0, 1) rows with
    other shapes."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    V, d, L, bags = 5000, 64, 3000, 60
    if case in ("zipf_v", "runs", "v1", "three_pass", "empty"):
        rng = np.random.default_rng(1)
        if case == "zipf_v":
            V, bags = 1_000_000, 4096
            ids = (rng.zipf(1.2, bags * 50) - 1) % V
        elif case == "runs":
            lens = _bwd_run_lengths(70_000)
            ids = np.repeat(2 * np.arange(len(lens)), lens)
            V, bags = 2 * len(lens) + 1, 500
        elif case == "v1":
            V, ids = 1, np.zeros(L, np.int64)
        elif case == "three_pass":
            V, d = 2**22 + 3, 8
            ids = rng.integers(0, V, L)
            ids[rng.random(L) < 0.05] = V - 1
        else:
            ids = np.zeros(0, np.int64)
        L = len(ids)
        idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
        seg = torch.from_numpy(np.sort(rng.integers(0, bags, L)).astype(np.int32)).to(cuda)
        w = torch.from_numpy(rng.random(L).astype(np.float32)).to(cuda)
        table = torch.randn((V, d), generator=g, device=cuda)
    elif case in ("mind", "zeros"):
        V, bags, S = 1_000_000, 4096, 50
        rng = np.random.default_rng(0)
        mask = np.arange(S)[None] < rng.integers(1, S + 1, (bags, 1))
        ids = (rng.zipf(1.2, (bags, S)) - 1) % V
        idx = torch.from_numpy(np.where(mask, ids, 0).astype(np.int32)).to(cuda).reshape(-1)
        w = torch.from_numpy(mask.astype(np.float32)).to(cuda).reshape(-1)
        if case == "zeros":
            idx, w = torch.zeros_like(idx), torch.ones_like(w)
        seg = torch.arange(bags, dtype=torch.int32, device=cuda).repeat_interleave(S)
        table = torch.randn((V, 64), generator=g, device=cuda) * 0.02
    else:
        if case == "d18":
            d = 18
        if case == "d200":
            d = 200
        if case == "one_bag":
            bags = 1
        table = torch.randn((V, d), generator=g, device=cuda)
        idx = torch.randint(0, 40, (L,), generator=g, device=cuda, dtype=torch.int32)
        seg = torch.sort(torch.randint(0, bags, (L,), generator=g, device=cuda)).values.int()
        w = torch.rand((L,), generator=g, device=cuda)
        if case == "unsorted":   # any order, the last 5 bags empty
            seg = torch.randint(0, bags - 5, (L,), generator=g, device=cuda, dtype=torch.int32)
        if case == "int64":
            idx, seg = idx.long(), seg.long()
        if case == "bf16":
            table = table.to(torch.bfloat16)
        if case == "none":
            w = None
    grad = torch.randn((bags, table.shape[1]), generator=g, device=cuda)
    return table, idx, seg, bags, w, grad


def _hold_bag_bwd(table, idx, seg, bags, w, grad, mode, d_t, d_w):
    """Against the plain version on CPU copies (in entry order): each
    element within 1e-5 of the sum of its own terms' magnitudes, + 1e-6;
    a bf16 gradient (the kernel's f32 sum rounded once) within half a
    bf16 ulp more; d_w within rtol 1e-5 + 1e-5 of its terms'
    magnitudes."""
    from repro_torch.kernels.bag.ref import embedding_bag_backward_ref

    cpu = [t.cpu() if t is not None else None for t in (table, idx, seg, w, grad)]
    t32 = cpu[0].float()
    want_t, want_w = embedding_bag_backward_ref(t32, cpu[1], cpu[2], bags, cpu[4], cpu[3],
                                                mode, weights_grad=d_w is not None)
    mag_t, mag_w = embedding_bag_backward_ref(
        t32.abs(), cpu[1], cpu[2], bags, cpu[4].abs(), None if w is None else cpu[3].abs(),
        mode, weights_grad=d_w is not None)
    got = d_t.cpu().float()
    tol = 1e-5 * mag_t + 1e-6
    if table.dtype == torch.bfloat16:   # the kernel's f32 sum rounded once
        tol = tol + torch.maximum(got.abs(), want_t.abs()) * 2.0 ** -8
    assert bool(((got - want_t).abs() <= tol).all())
    if d_w is not None:
        assert bool(((d_w.cpu() - want_w).abs()
                     <= 1e-5 * want_w.abs() + 1e-5 * mag_w + 1e-6).all())
    untouched = torch.ones(table.shape[0], dtype=torch.bool)
    untouched[cpu[1].long()] = False
    assert bool((got[untouched] == 0).all())


@pytest.mark.parametrize("case", ["mind", "zeros", "unsorted", "bf16", "int64", "none", "dw",
                                  "d18", "d200", "one_bag", "zipf_v", "runs", "v1",
                                  "three_pass", "empty"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_backward_kernel_matches_plain_and_is_deterministic(cuda, case, mode):
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda

    table, idx, seg, bags, w, grad = _bag_bwd_inputs(case, cuda)
    before = COUNTS["bag_backward"].kernel
    d_t, d_w = embedding_bag_backward_cuda(table, idx, seg, bags, grad, w, mode,
                                           weights_grad=case == "dw")
    d_t2, d_w2 = embedding_bag_backward_cuda(table, idx, seg, bags, grad, w, mode,
                                             weights_grad=case == "dw")
    torch.cuda.synchronize()
    assert COUNTS["bag_backward"].kernel == before + 2
    assert d_t.dtype == table.dtype and d_t.shape == table.shape
    assert torch.equal(d_t, d_t2)          # the same bits from call to call
    if case == "dw":
        assert d_w.shape == idx.shape and torch.equal(d_w, d_w2)
    else:
        assert d_w is None
    _hold_bag_bwd(table, idx, seg, bags, w, grad, mode, d_t, d_w)


def test_bag_autograd_on_card_launches_forward_and_backward(cuda):
    from repro_torch.kernels.bag import ops as bag_ops

    table, idx, seg, bags, w, grad = _bag_bwd_inputs("mind", cuda)
    t = table.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    f, b = COUNTS["bag"].kernel, COUNTS["bag_backward"].kernel
    out = bag_ops.embedding_bag_sorted(t, idx, seg, bags, ww, "mean")
    d_t, d_w = torch.autograd.grad(out, (t, ww), grad)
    assert (COUNTS["bag"].kernel - f, COUNTS["bag_backward"].kernel - b) == (1, 1)
    _hold_bag_bwd(table, idx, seg, bags, w, grad, "mean", d_t, d_w)


@pytest.mark.parametrize("name", ["mind", "fm"])
def test_train_step_on_card(cuda, name):
    """A smoke train step on the card: MIND's launches the bag forward and
    backward kernels once each, the gather backward once per row gather,
    and no plain version; the loss is finite and the params move."""
    from repro_torch.kernels import counts
    from repro_torch.models.api import get_arch
    from repro_torch.models.testing import dummy_batch

    arch = get_arch(name, smoke=True)
    state = arch.init_train_state(0)
    batch = dummy_batch(arch.step("train_batch").input_specs, seed=1)
    counts.reset_all()
    new, m = arch.step("train_batch").fn(state, batch)
    torch.cuda.synchronize()
    snap = counts.snapshot()
    if name == "mind":
        assert snap["bag"]["kernel"] == snap["bag_backward"]["kernel"] == 1, snap
        assert snap["gather_backward"]["kernel"] == 4, snap   # hist, target x2, negatives
    assert all(c["plain"] == 0 for c in snap.values()), snap
    assert np.isfinite(float(m["loss"])) and int(new.opt.step) == 1
    key = "item_emb" if name == "mind" else "v"
    assert not torch.equal(new.params[key], state.params[key])


@pytest.mark.parametrize("case", ["mind", "zeros", "d18", "int64", "zipf_v", "runs", "v1",
                                  "three_pass", "empty"])
def test_gather_backward_kernel_matches_plain_and_is_deterministic(cuda, case):
    """The gradient of ``table[ids]`` (one entry a bag): MIND's history
    gather at a cut batch, every id on row 0, DIEN's width, int64 ids, and
    the bag's new edge cases (``_bag_bwd_inputs``); rows no id touches
    exactly zero."""
    from repro_torch.kernels.bag.bag import gather_backward_cuda
    from repro_torch.kernels.bag.ref import gather_backward_ref

    table, idx, _, _, _, _ = _bag_bwd_inputs("mind" if case in ("d18", "int64") else case,
                                             cuda)
    if case == "d18":
        table = torch.randn((table.shape[0], 18), device=cuda)
    if case == "int64":
        idx = idx.long()
    ids = idx.view(-1, 50)
    g = torch.Generator(device=cuda).manual_seed(3)
    grad = torch.randn((*ids.shape, table.shape[1]), generator=g, device=cuda) * 1e-3
    before = COUNTS["gather_backward"].kernel
    got, again = (gather_backward_cuda(table, ids, grad) for _ in range(2))
    torch.cuda.synchronize()
    assert COUNTS["gather_backward"].kernel == before + 2 and torch.equal(got, again)
    want = gather_backward_ref(table.cpu(), ids.cpu(), grad.cpu())
    mag = gather_backward_ref(table.cpu(), ids.cpu(), grad.abs().cpu())
    assert bool(((got.cpu() - want).abs() <= 1e-5 * mag + 1e-6).all())
    untouched = torch.ones(table.shape[0], dtype=torch.bool)
    untouched[ids.reshape(-1).long().cpu()] = False
    assert bool((got.cpu()[untouched] == 0).all())


def _segment_inputs(case, dev):
    """(data [E, d], ids [E], num_segments): MeshGraphNet's aggregation at
    minibatch_lg's padded shape with ids from a sampled batch, every id 0
    at that size (a dummy batch's one hot row), int64 ids, bf16 data, two
    segments of three empty, DIEN's width, one segment, no entries."""
    from repro_torch.models.gnn import NeighborSampler, random_csr_graph

    g = torch.Generator(device=dev).manual_seed(5)
    N, E, d = 169_984, 168_960, 128
    if case in ("sampled", "int64", "bf16"):
        indptr, indices = random_csr_graph(20_000, 40, seed=1)
        sub = NeighborSampler(indptr, indices, (15, 10), seed=2).sample(
            np.random.default_rng(3).choice(20_000, 1024, replace=False), N, E)
        ids = torch.from_numpy(sub["edge_dst"]).to(dev)
        if case == "int64":
            ids = ids.long()
    elif case == "zeros":
        ids = torch.zeros(E, dtype=torch.int32, device=dev)
    elif case == "empty":
        ids = torch.randint(0, 1000, (E,), generator=g, device=dev, dtype=torch.int32) * 3
        N = 3000
    elif case == "d18":
        E, N, d = 65_536, 4096, 18
        ids = torch.randint(0, N, (E,), generator=g, device=dev, dtype=torch.int32)
    elif case == "one_segment":
        N, E = 1, 4097
        ids = torch.zeros(E, dtype=torch.int32, device=dev)
    else:    # no entries
        E, N = 0, 17
        ids = torch.zeros(0, dtype=torch.int32, device=dev)
    data = torch.randn((E, d), generator=g, device=dev)
    if case == "bf16":
        data = data.to(torch.bfloat16)
    return data, ids, N


@pytest.mark.parametrize("case", ["sampled", "zeros", "int64", "bf16", "empty", "d18",
                                  "one_segment", "no_entries"])
def test_segment_sum_kernel_matches_plain_and_is_deterministic(cuda, case):
    """``bag_backward.cu``'s gather entry run forward as a segment sum,
    against ``segment_sum_ref``: each element within 1e-5 of the sum of
    its terms' magnitudes + 1e-6 (a bf16 result, the f32 sum rounded once:
    half a bf16 ulp more), empty segments exactly zero, two calls
    bit-equal."""
    from repro_torch.kernels.bag.bag import segment_sum_cuda
    from repro_torch.kernels.bag.ref import segment_sum_ref

    data, ids, N = _segment_inputs(case, cuda)
    before = COUNTS["segment_sum"].kernel
    got, again = (segment_sum_cuda(data, ids, N) for _ in range(2))
    torch.cuda.synchronize()
    assert COUNTS["segment_sum"].kernel == before + 2 and torch.equal(got, again)
    assert got.dtype == data.dtype and got.shape == (N, data.shape[1])
    want = segment_sum_ref(data.float(), ids, N)
    mag = segment_sum_ref(data.float().abs(), ids, N)
    tol = 1e-5 * mag + 1e-6
    if data.dtype == torch.bfloat16:
        tol = tol + torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -8
    assert bool(((got.float() - want).abs() <= tol).all())
    untouched = torch.ones(N, dtype=torch.bool, device=cuda)
    untouched[ids.long()] = False
    assert bool((got[untouched] == 0).all())


def test_segment_sum_autograd_on_card(cuda):
    """``ops.segment_sum`` as an autograd node on the card: the forward is
    the kernel (one launch), the gradient the row gather ``grad[ids]``
    (no launch of the port's kernels)."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.bag import ops as bag_ops

    data, ids, N = _segment_inputs("d18", cuda)
    x = data.clone().requires_grad_(True)
    g = torch.randn((N, data.shape[1]), device=cuda)
    before = counts.snapshot()
    out = bag_ops.segment_sum(x, ids, N)
    (dx,) = torch.autograd.grad(out, x, g)
    after = counts.snapshot()
    assert after["segment_sum"]["kernel"] - before["segment_sum"]["kernel"] == 1
    assert all(after[k] == before[k] for k in after if k != "segment_sum")
    assert torch.equal(dx, g[ids.long()])


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"])
def test_gnn_train_step_on_card(cuda, shape):
    """A smoke MeshGraphNet train step on the card (remat on): the segment
    sum twice a layer (forward, recompute), the gather backward twice a
    layer, no plain version; two steps from one state bit-equal; the
    card's loss within 1e-5 of the CPU's on the same params and batch."""
    import dataclasses

    from repro_torch.kernels import counts
    from repro_torch.models.api import get_arch
    from repro_torch.models.testing import dummy_batch
    from repro_torch.train import optimizer as opt_lib

    arch = get_arch("meshgraphnet", smoke=True)
    arch.cfg = dataclasses.replace(arch.cfg, remat=True)
    spec = arch.step(shape)
    state = arch.init_train_state(0)
    batch = dummy_batch(spec.input_specs, seed=1)
    n = batch["edge_src"].numel()
    batch["edge_src"] = torch.randint(0, batch["node_feat"].shape[0], (n,), device=cuda,
                                      dtype=torch.int32)
    batch["edge_dst"] = torch.randint(0, batch["node_feat"].shape[0], (n,), device=cuda,
                                      dtype=torch.int32)
    counts.reset_all()
    new, m = spec.fn(state, batch)
    torch.cuda.synchronize()
    snap = counts.snapshot()
    L = arch.cfg.n_layers
    assert snap["segment_sum"] == {"kernel": 2 * L, "plain": 0}, snap
    assert snap["gather_backward"] == {"kernel": 2 * L, "plain": 0}, snap
    again, m2 = spec.fn(state, batch)
    for a, b in zip(opt_lib.leaves(new.params), opt_lib.leaves(again.params)):
        assert torch.equal(a, b)
    assert torch.equal(m["loss"], m2["loss"])
    cpu_loss = arch.loss(opt_lib.tree_map(lambda t: t.cpu(), state.params),
                         {k: v.cpu() for k, v in batch.items()})[0]
    assert abs(float(m["loss"]) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
