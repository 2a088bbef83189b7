"""The port's CUDA kernels (admit, serve, mips, rerank, prefilter,
assign, bag) against their plain PyTorch versions, on the card. Run where
there is one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

Elsewhere every test skips with its reason (the ``cuda`` fixture decides,
at run time). Tolerances, as in ``chip_smoke.py``: floats within rtol
1e-5 / atol 1e-6; decisions equal except at near-ties, where the plain
version's competing scores differ by under 1e-5 and the kernel's pick
must score within 1e-5 of the plain pick; int8 rows equal or off by one
where v/scale lies within 1e-4 of a half-integer; scales within 2 ulp.
"""
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
               for n in ("admit", "serve", "mips")), snap


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
