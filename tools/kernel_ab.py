#!/usr/bin/env python3
"""Device times of the port's kernels in two checkouts of this
repository, measured in turns on one CUDA card.

    python3 tools/kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT [--kernel NAME ...] [--split]

NAME is one of ``serve`` (the default: the two-stage flush, 64 queries
against 4218 x 384 prototypes, nprobe 8, int8 rings of depth 64, k = 10;
where the checkout's wrapper exposes them, its two launches are timed
apart too, as ``serve.stage1`` and ``serve.stage2``, and its route-only
entry, the serving cache's route witness, as ``serve.route``; a checkout whose
serve starts with ``topk.cuh``'s rows_topk_kernel times that launch as
``serve.stage1``, through mips's blocked select at k = nprobe, which is
the same launch), ``mips10`` (the
streaming-RAG flush: 64 queries against 4218 x 384 prototypes, k = 10;
its two launches apart as ``mips10.select`` and ``mips10.merge``; the
staged route's k = nprobe = 8 as ``mips8``; the 1 GB budget's index, 64
queries against 28,125 x 384 prototypes, k = 10, as ``mips10.lg``),
``mips100`` (MIND's retrieve: 4 queries against a 1,000,000 x 64 item
table, k = 100), ``rerank`` (the staged flush: the same queries, their
top-8 routes with 10% dead labels, int8 rings of depth 64, k = 10),
``bag`` (MIND's profile bag through the entry its user_vectors calls in
that checkout, at serve_p99, 512 x 50, and serve_bulk, 262,144 x 50, Zipf
ids over 1,000,000 x 64, beside ``F.embedding_bag`` + divide as
``bag.*.library``; and, where the checkout has it, the bag's backward
kernel at MIND's train shape, 65,536 x 50, as ``bag.bwd``, a stable
``torch.sort`` of its ids as ``bag.bwd.sort`` (the library yardstick of
the kernel's own sort), and the row gathers' backward of a MIND step: the
history gather, the same ids as [65,536, 50], as ``bag.gather``, a target
gather, 65,536 Zipf ids, as ``bag.gather.small``, the 512 negatives as
``bag.gather.neg``), ``assign`` and ``admit`` (a 256-row batch against
4218 x 384 centroids; admit with int8 rows, with 10% of the rows dead and
with ``live=None`` as ``admit.live_none``), ``prefilter`` (the same
256 x 384 rows against a 5 x 384 basis), ``serve4gb`` (the 4 GB
budget's index, 112,501 x 384 prototypes, at nprobe 16 over the serve
case's ring store: ``serve.4gb`` and ``serve.route.4gb`` where the
checkout serves them, the fused call's launches apart as
``serve.4gb.stage1``, ``.merge`` (its merge pass) and ``.stage2``, and
the whole two-stage query a flush runs, ``engine.routed_query`` (the
normalization, serve and, in a checkout whose serve returns no decoded
answer, the ring mask and the decode's torch ops), as
``serve.4gb.flush``; both with the host ms a call, ``.host``; each
checkout's serve and rerank called by their own signatures, a liveness
mask or the ring doc ids),
``segsum`` (MeshGraphNet's
aggregation at minibatch_lg's padded shape, 168,960 x 128 into 169,984
rows, a sampled batch's edge_dst: ``segsum``, every id 0 as
``segsum.hot``, the gather entry at hn[src]'s shape as ``bag.gather.hn``,
each given its ids' order where the checkout can sort once
(``segment_order_cuda``), the sorts alone as ``segsum.sort`` and
``segsum.hot.sort``; the sum without an order as ``segsum.bare``, a
stable ``torch.sort`` of the ids as ``segsum.library_sort``; a checkout
without the order sorts in every call), ``heavy_hitter`` (the counter's
batch update: ``heavy_hitter.main``, MIN_EVICT at bmax 4218 on a batch
shaped as the main path's, 256 labels of which 26 valid; ``.zipf``,
MIN_EVICT at capacity 100 on 256 valid Zipf labels over 4218 clusters on
a filled counter; ``.valid256``, MIN_EVICT at bmax 4218 on 256 valid Zipf
labels on a counter filled by three such batches; ``.random``,
RANDOM_EVICT at bmax 4218 on 256 valid Zipf labels (a counter that never
fills, so no arrival evicts); ``.evict_min`` and ``.evict_random``,
MIN_EVICT and RANDOM_EVICT at bmax 4218 with u_t = 1 on a full counter fed
256 novel labels, so every arrival evicts (the minimum, or its Gumbel
row); ``.lg`` and ``.lg_evict_min``, the same two shapes as ``.main`` and
``.evict_min`` at the 1 GB budget's bmax 28,125, past one block: the large
path, where the checkout has it (a checkout that refuses the bmax times
the loop alone); each with the wrapper's host ms a call,
``.host`` (``cuda_ms``'s second number: the same calls with the card
idle), and beside its plain loop, ``.plain``, timed on the host clock
between synchronizes, since it is host-bound; a checkout without the
kernel times its loop alone, so ``tools/kernel_ab.py . . --kernel
heavy_hitter`` compares the kernel with the loop); several may be
given. ``--split`` also prints, for every timed call in every turn, its
launches under torch.profiler (one warm call: each kernel's name and
device ms, in launch order). Each
turn (A B B A, twice) is a fresh process that imports that checkout's
``chip_smoke.py`` (and with it that checkout's
``src/repro_torch``), builds the kernels from its sources into the
checkout's own ``build/``, and times each kernel's public wrapper with
``chip_smoke.cuda_ms`` (CUDA events around warm calls queued behind a
spinning kernel; the median of 5). Inputs are made on the card from a
fixed seed, the same in every turn. Prints one line per turn and the
median of each side. Two versions are comparable only inside one such
run: cards and their power limits differ between machines.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

PRELUDE = r"""
import json, sys, time, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels.common import l2_normalize
g = torch.Generator(device="cuda"); g.manual_seed(0)
host_fns = {{}}   # host-bound calls, timed on the host clock
host_too = set()   # kernels whose wrapper's host ms a call is reported too


def launches(fn):
    # one warm call of fn under torch.profiler: [kernel name, device ms]
    # for each launch, in launch order; the profiler can drop a session's
    # first kernels, so fn runs twice, each call behind a spinning kernel,
    # and the launches after the last spin are kept (chip_smoke.py's
    # profiled_launches does the same; a parent checkout's may not)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for spin in (cs.SPIN_CYCLES // 20, cs.SPIN_CYCLES // 100):
            torch.cuda._sleep(spin)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    last_spin = max((i for i, e in enumerate(evs) if "spin" in e.name), default=-1)
    return [[e.name[:48], (e.device_time_total if hasattr(e, "device_time_total")
                           else e.cuda_time_total) / 1e3] for e in evs[last_spin + 1:]]


def ring_arg(fn, ring):
    # the ring liveness fn takes, from the checkout's synthetic_store: a
    # bool mask where its parameter is named live, the ring doc ids (-1 an
    # empty slot) where it is named ids; the same slots are live either way
    import inspect
    if "ids" in inspect.signature(fn).parameters:
        if ring.dtype != torch.bool:
            return ring
        n = torch.arange(ring.numel(), dtype=torch.int32, device=ring.device)
        return torch.where(ring, 7 + 3 * n.view(ring.shape), -1)
    return ring if ring.dtype == torch.bool else ring >= 0


def host_ms(fn, iters=2):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters
"""
SETUP = {
    "serve": r"""
from repro_torch.kernels.serve.serve import serve_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
valid = torch.rand((K,), generator=g, device="cuda") < 0.9
labels = torch.randperm(K, generator=g, device="cuda").to(torch.int32)
labels[torch.rand((K,), generator=g, device="cuda") < 0.1] = -1
embs, live, scales = cs.synthetic_store(K, 64, d, True, g)
live = ring_arg(serve_topk_cuda, live)
fns = {"serve": lambda: serve_topk_cuda(q, q, vectors, valid, labels, embs, live,
                                        cs.TOPK, cs.NPROBE, scales)}
from repro_torch.kernels.serve import serve as serve_mod
if hasattr(serve_mod, "serve_routes_cuda"):   # the route-only entry
    fns["serve.route"] = lambda: serve_mod.serve_routes_cuda(q, vectors, valid, labels,
                                                             cs.NPROBE)
if hasattr(serve_mod, "serve_launcher"):   # the two launches apart
    run = serve_mod.serve_launcher(q, q, vectors, valid, labels, embs, live, cs.TOPK,
                                   cs.NPROBE, scales)[-1]
    run()   # a phase alone reads the keys an earlier run wrote
    fns["serve.stage1"] = lambda: run(1)
    fns["serve.stage2"] = lambda: run(2)
else:   # a serve whose first launch is topk.cuh's rows_topk_kernel: the same
    # launch as mips's blocked select at k = nprobe on the same index
    from repro_torch.kernels.mips.mips import mips_launcher
    plan, _, _, mrun = mips_launcher(q, vectors, valid, cs.NPROBE)
    if plan.path == "blocked":
        fns["serve.stage1"] = lambda: mrun(1)
""",
    "mips10": r"""
from repro_torch.kernels.mips.mips import mips_launcher, mips_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
valid = torch.rand((K,), generator=g, device="cuda") < 0.9
fns = {"mips10": lambda: mips_topk_cuda(q, vectors, valid, cs.TOPK)}
mrun = mips_launcher(q, vectors, valid, cs.TOPK)[-1]
fns["mips10.select"] = lambda: mrun(1)
fns["mips10.merge"] = lambda: mrun(2)
fns["mips8"] = lambda: mips_topk_cuda(q, vectors, valid, cs.NPROBE)
vlg = l2_normalize(torch.randn((28_125, d), generator=g, device="cuda"))
validlg = torch.rand((28_125,), generator=g, device="cuda") < 0.9
fns["mips10.lg"] = lambda: mips_topk_cuda(q, vlg, validlg, cs.TOPK)
""",
    "mips100": r"""
from repro_torch.kernels.mips.mips import mips_topk_cuda
N, d, Q = 1_000_000, 64, 4
table = torch.randn((N, d), generator=g, device="cuda") * 0.02
q = torch.randn((Q, d), generator=g, device="cuda")
valid = torch.ones((N,), dtype=torch.bool, device="cuda")
fns = {"mips100": lambda: mips_topk_cuda(q, table, valid, 100)}
""",
    "assign": r"""
from repro_torch.kernels.assign.assign import assign_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
cent = torch.randn((4218, 384), generator=g, device="cuda")
fns = {"assign": lambda: assign_cuda(x, cent)}
""",
    "admit": r"""
from repro_torch.kernels.admit.admit import admit_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
basis = torch.randn((5, 384), generator=g, device="cuda")
cent = torch.randn((4218, 384), generator=g, device="cuda")
live = torch.rand((cs.BATCH,), generator=g, device="cuda") < 0.9
fns = {"admit": lambda: admit_cuda(x, basis, cent, 0.2, live, store_dtype="int8"),
       "admit.live_none": lambda: admit_cuda(x, basis, cent, 0.2, None, store_dtype="int8")}
""",
    "prefilter": r"""
from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda
x = torch.randn((cs.BATCH, 384), generator=g, device="cuda")
basis = torch.randn((5, 384), generator=g, device="cuda")
fns = {"prefilter": lambda: prefilter_scores_cuda(x, basis)}
""",
    "rerank": r"""
from repro_torch.kernels.rerank.rerank import rerank_topk_cuda
K, d, Q = 4218, 384, cs.QUERIES
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
vectors = l2_normalize(torch.randn((K, d), generator=g, device="cuda"))
labels = torch.randperm(K, generator=g, device="cuda").to(torch.int32)
labels[torch.rand((K,), generator=g, device="cuda") < 0.1] = -1
routes = labels[torch.topk(q @ vectors.T, cs.NPROBE).indices].contiguous()
embs, live, scales = cs.synthetic_store(K, 64, d, True, g)
live = ring_arg(rerank_topk_cuda, live)
fns = {"rerank": lambda: rerank_topk_cuda(q, embs, live, routes, cs.TOPK, scales)}
""",
    "heavy_hitter": r"""
import numpy as np
from repro_torch.core import heavy_hitter as hh
try:
    from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda
    from repro_torch.kernels.heavy_hitter.ref import update_batch_ref as plain_update
except ImportError:   # a checkout from before the kernel: its update is the loop
    update_batch_cuda = None
    plain_update = lambda cfg, st, lab, dr: hh.update_batch(cfg, st, lab, draws=dr)
rng = np.random.default_rng(0)
zipf = lambda n: torch.from_numpy(cs.zipf_ids(rng, 4218, (n,))).cuda()
cases = {}
cfg = hh.HHConfig(capacity=4218)
lab = torch.full((cs.BATCH,), -1, dtype=torch.int32, device="cuda")
lab[torch.randperm(cs.BATCH, generator=g, device="cuda")[:26]] = zipf(26)
cases["main"] = (cfg, hh.init(cfg, "cuda"), lab)
for name, cfg in (("zipf", hh.HHConfig(capacity=100)),
                  ("valid256", hh.HHConfig(capacity=4218)),
                  ("random", hh.HHConfig(capacity=4218, policy=hh.Policy.RANDOM_EVICT))):
    st = hh.init(cfg, "cuda")
    for _ in range(3):   # fill the counter
        st, _ = plain_update(cfg, st, zipf(cs.BATCH), hh.draw(cfg, cs.BATCH, g, "cuda"))
    cases[name] = (cfg, st, zipf(cs.BATCH))
fns = {}
for name, policy in (("evict_min", hh.Policy.MIN_EVICT),
                     ("evict_random", hh.Policy.RANDOM_EVICT)):
    cfg = hh.HHConfig(capacity=4218, admit_prob=1.0, policy=policy)
    full = torch.from_numpy(rng.permutation(4 * 4218)[:4218].astype(np.int32)).cuda()
    counts = torch.from_numpy(rng.integers(0, 9, 4218).astype(np.int32)).cuda()
    cases[name] = (cfg, hh.init(cfg, "cuda")._replace(labels=full, counts=counts),
                   torch.arange(50_000, 50_000 + cs.BATCH, dtype=torch.int32, device="cuda"))
# the 1 GB budget's counter, past one block: the main path's batch shape on
# a fresh counter, and every arrival evicting on a full one
LG = 28_125
cfg = hh.HHConfig(capacity=LG)
lab = torch.full((cs.BATCH,), -1, dtype=torch.int32, device="cuda")
lab[torch.randperm(cs.BATCH, generator=g, device="cuda")[:26]] = torch.from_numpy(
    cs.zipf_ids(rng, LG, (26,))).cuda()
cases["lg"] = (cfg, hh.init(cfg, "cuda"), lab)
cfg = hh.HHConfig(capacity=LG, admit_prob=1.0)
full = torch.from_numpy(rng.permutation(4 * LG)[:LG].astype(np.int32)).cuda()
counts = torch.from_numpy(rng.integers(0, 9, LG).astype(np.int32)).cuda()
cases["lg_evict_min"] = (cfg, hh.init(cfg, "cuda")._replace(labels=full, counts=counts),
                         torch.arange(10 * LG, 10 * LG + cs.BATCH, dtype=torch.int32,
                                      device="cuda"))
for name, (cfg, st, lab) in cases.items():
    dr = hh.draw(cfg, cs.BATCH, g, "cuda")
    fn = None
    if update_batch_cuda is not None:
        fn = (lambda cfg=cfg, st=st, lab=lab, dr=dr: update_batch_cuda(cfg, st, lab, dr))
        try:
            fn()
        except ValueError:   # a kernel that refuses a bmax past one block
            fn = None
    if fn is not None:
        fns[f"heavy_hitter.{name}"] = fn
        host_too.add(f"heavy_hitter.{name}")
    host_fns[f"heavy_hitter.{name}.plain"] = (lambda cfg=cfg, st=st, lab=lab, dr=dr:
                                              plain_update(cfg, st, lab, dr))
""",
    "bag": r"""
import numpy as np
from repro_torch.kernels.bag import ops as bag_ops
# the entry MIND's user_vectors calls in this checkout (one without the
# sorted entry sorts first)
entry = getattr(bag_ops, "embedding_bag_sorted", bag_ops.embedding_bag)
table = torch.randn((1_000_000, 64), generator=g, device="cuda") * 0.02
rng = np.random.default_rng(0)
fns = {}
for label, B, S in (("bag.p99", 512, 50), ("bag.bulk", 262_144, 50)):
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    idx = torch.from_numpy(np.where(mask, cs.zipf_ids(rng, 1_000_000, (B, S)), 0)
                           .astype(np.int32)).cuda().reshape(-1)
    seg = torch.arange(B, dtype=torch.int32, device="cuda")[:, None].expand(B, S).reshape(-1)
    w = torch.from_numpy(mask).cuda().float().reshape(-1)
    offsets = torch.arange(0, B * S, S, device="cuda", dtype=torch.int32)
    fns[label] = lambda idx=idx, seg=seg, w=w, B=B: entry(table, idx, seg, B, w, "mean")
    fns[label + ".library"] = lambda idx=idx, w=w, o=offsets, S=S: (
        torch.nn.functional.embedding_bag(idx, table, o, mode="sum",
                                          per_sample_weights=w) / S)
# the backward at MIND's train shape (65,536 x 50), where the checkout has it
try:
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda
except ImportError:
    embedding_bag_backward_cuda = None
if embedding_bag_backward_cuda is not None:
    B, S = 65_536, 50
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    idx = torch.from_numpy(np.where(mask, cs.zipf_ids(rng, 1_000_000, (B, S)), 0)
                           .astype(np.int32)).cuda().reshape(-1)
    seg = torch.arange(B, dtype=torch.int32, device="cuda")[:, None].expand(B, S).reshape(-1)
    w = torch.from_numpy(mask).cuda().float().reshape(-1)
    grad = torch.randn((B, 64), generator=g, device="cuda") * 1e-4
    fns["bag.bwd"] = lambda: embedding_bag_backward_cuda(table, idx, seg, B, grad, w, "mean")
    # the library yardstick: a stable torch.sort of the same ids (the
    # parent's wrapper called it; the redesign sorts by hand)
    fns["bag.bwd.sort"] = lambda: torch.sort(idx, stable=True)
    # the row gathers' backward of a MIND step: the history (the same ids,
    # [B, S]), a target gather (B Zipf ids; twice a step) and the negatives
    # (512 uniform ids)
    from repro_torch.kernels.bag.bag import gather_backward_cuda
    ghist = torch.randn((B, S, 64), generator=g, device="cuda") * 1e-4
    tgt = torch.from_numpy(cs.zipf_ids(rng, 1_000_000, (B,))).cuda()
    gtgt = torch.randn((B, 64), generator=g, device="cuda") * 1e-4
    negs = torch.randint(0, 1_000_000, (512,), generator=g, device="cuda")
    gneg = torch.randn((512, 64), generator=g, device="cuda") * 1e-4
    fns["bag.gather"] = lambda: gather_backward_cuda(table, idx.view(B, S), ghist)
    fns["bag.gather.small"] = lambda: gather_backward_cuda(table, tgt, gtgt)
    fns["bag.gather.neg"] = lambda: gather_backward_cuda(table, negs, gneg)
""",
}
SETUP["serve4gb"] = r"""
import types
from repro_torch.engine.engine import routed_query
from repro_torch.kernels.serve import serve as serve_mod
from repro_torch.store import docstore
# the 4 GB budget's index (cap 112,501 x 384) at the tables' nprobe 16,
# where a query's route keys pass one block's shared memory, over the
# serve case's ring store; a checkout that refuses a call times nothing
# for it
K, d, Q, K4 = 4218, 384, cs.QUERIES, 112_501
q = l2_normalize(torch.randn((Q, d), generator=g, device="cuda"))
embs, live, scales = cs.synthetic_store(K, 64, d, True, g)
live = ring_arg(serve_mod.serve_topk_cuda, live)
v4 = l2_normalize(torch.randn((K4, d), generator=g, device="cuda"))
valid4 = torch.rand((K4,), generator=g, device="cuda") < 0.9
labels4 = torch.randint(0, K, (K4,), generator=g, device="cuda", dtype=torch.int32)
labels4[torch.rand((K4,), generator=g, device="cuda") < 0.1] = -1
fns = {}
four = {"serve.4gb": lambda: serve_mod.serve_topk_cuda(q, q, v4, valid4, labels4, embs, live,
                                                       cs.TOPK, 16, scales),
        "serve.route.4gb": lambda: serve_mod.serve_routes_cuda(q, v4, valid4, labels4, 16)}
# the whole two-stage query as a flush runs it (engine.routed_query: the
# queries' normalization, serve and whatever the checkout runs around it,
# up to the answer's rows, doc ids and clusters), host ms a call beside
ids4 = ring_arg(lambda ids: None, live)
store4 = docstore.DocStore(embs, ids4, ids4, torch.zeros((K,), dtype=torch.int32,
                                                         device="cuda"), scales)
cfg4 = types.SimpleNamespace(store_depth=64, index=types.SimpleNamespace(normalize=True))
index4 = types.SimpleNamespace(vectors=v4, valid=valid4)
four["serve.4gb.flush"] = lambda: routed_query(cfg4, index4, labels4, store4, q, cs.TOPK, 16)
host_too.update(("serve.4gb", "serve.4gb.flush"))
for name, fn in four.items():
    try:
        fn()
    except ValueError:   # past one block's shared memory in this checkout
        continue
    fns[name] = fn
if "serve.4gb" in fns:
    launched = serve_mod.serve_launcher(q, q, v4, valid4, labels4, embs, live, cs.TOPK, 16,
                                        scales)
    plan4, run4 = launched[0], launched[-1]
    run4()   # every buffer written once: each launch alone reads the one before's
    fns["serve.4gb.stage1"] = lambda: run4(1)
    if getattr(plan4, "levels", ()):
        fns["serve.4gb.merge"] = lambda: run4(4)
    fns["serve.4gb.stage2"] = lambda: run4(2)
"""
SETUP["segsum"] = r"""
import numpy as np
from repro_torch.kernels.bag import bag as bag_mod
from repro_torch.models.gnn import NeighborSampler, random_csr_graph
# MeshGraphNet's aggregation at minibatch_lg's padded shape: a sampled
# batch's edge_dst (1,024 roots, fan-out 15 then 10, of a 20,000-node
# graph of degree 40), every id 0 (a dummy batch's one hot row), and the
# gather entry at hn[src]'s shape; given each id set's order where the
# checkout has segment_order_cuda (each sum then sorts nothing), the sort
# alone as segsum.sort; a checkout without it sorts in every call
N, E, d = 169_984, 168_960, 128
indptr, indices = random_csr_graph(20_000, 40, seed=1)
sub = NeighborSampler(indptr, indices, (15, 10), seed=2).sample(
    np.random.default_rng(3).choice(20_000, 1024, replace=False), N, E)
dst = torch.from_numpy(sub["edge_dst"]).cuda()
src = torch.from_numpy(sub["edge_src"]).cuda()
zeros = torch.zeros_like(dst)
x = torch.randn((E, d), generator=g, device="cuda")
hn = torch.randn((N, d), generator=g, device="cuda")
fns = {}
if hasattr(bag_mod, "segment_order_cuda"):
    od, oz, osrc = (bag_mod.segment_order_cuda(i, N) for i in (dst, zeros, src))
    fns["segsum"] = lambda: bag_mod.segment_sum_cuda(x, dst, N, od)
    fns["segsum.hot"] = lambda: bag_mod.segment_sum_cuda(x, zeros, N, oz)
    fns["bag.gather.hn"] = lambda: bag_mod.gather_backward_cuda(hn, src, x, osrc)
    fns["segsum.sort"] = lambda: bag_mod.segment_order_cuda(dst, N)
    fns["segsum.hot.sort"] = lambda: bag_mod.segment_order_cuda(zeros, N)
else:
    fns["segsum"] = lambda: bag_mod.segment_sum_cuda(x, dst, N)
    fns["segsum.hot"] = lambda: bag_mod.segment_sum_cuda(x, zeros, N)
    fns["bag.gather.hn"] = lambda: bag_mod.gather_backward_cuda(hn, src, x)
fns["segsum.bare"] = lambda: bag_mod.segment_sum_cuda(x, dst, N)
fns["segsum.library_sort"] = lambda: torch.sort(dst, stable=True)
"""
TIME = r"""
for name, fn in fns.items():
    runs = sorted(cs.cuda_ms(fn) for _ in range(5))
    out[name] = runs[2][0]
    if SPLIT:
        splits[name] = launches(fn)
    if name in host_too:
        out[name + ".host"] = sorted(r[1] for r in runs)[2]
for name, fn in host_fns.items():
    out[name] = host_ms(fn)
host_fns = {}
"""
ROUNDS = 2


def turn(root: str, kernels: list[str], split: bool) -> tuple[dict, dict]:
    """One process in ``root``: {name: device ms} and, with ``split``,
    {name: [[kernel, device ms], ...]} from one profiled call."""
    code = (PRELUDE.format(root=os.path.abspath(root))
            + f"out, splits, SPLIT = {{}}, {{}}, {split}\n")
    for kernel in kernels:
        code += SETUP[kernel] + TIME
    code += "print(json.dumps(splits))\nprint(json.dumps(out))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-1]), json.loads(lines[-2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--kernel", nargs="+", choices=sorted(SETUP), default=["serve"])
    ap.add_argument("--split", action="store_true",
                    help="also print each timed call's launches under torch.profiler")
    args = ap.parse_args()
    times: dict[str, dict[str, list[float]]] = {}
    for _ in range(ROUNDS):
        for side in ("old", "new", "new", "old"):
            got, splits = turn(getattr(args, side), args.kernel, args.split)
            for name, ks in splits.items():
                print(f"{side} {name} split: " + ", ".join(f"{k} {ms:.4f}" for k, ms in ks)
                      + f" (sum {sum(ms for _, ms in ks):.4f} ms)")
            for name, ms in got.items():
                times.setdefault(name, {"old": [], "new": []})[side].append(ms)
            print(f"{side}: " + ", ".join(f"{k} {ms:.4f}" for k, ms in got.items())
                  + " ms device")
    for name, t in times.items():
        med = {side: float(np.median(v)) if v else None for side, v in t.items()}
        if med["old"] is None or med["new"] is None:
            side = "old" if med["old"] is not None else "new"
            print(f"{name} median: {side} {med[side]:.4f} ms (the other checkout has none)")
            continue
        print(f"{name} median: old {med['old']:.4f} ms, new {med['new']:.4f} ms "
              f"({(med['new'] / med['old'] - 1) * 100:+.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
