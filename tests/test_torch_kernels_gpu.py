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
                                   (1, 700, 64), (17, 5, 256)])
def test_assign_kernel_matches_plain(cuda, B, K, d):
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
