#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Setup: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel from ``src/repro_torch/csrc`` (time and the
   ``-Xptxas -v`` summary).
2. Kernel checks: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (the paper's 150 MB budget: k = B =
   4218 clusters/prototypes, d = 384, 256-document microbatches, 64-query
   flushes, nprobe 8, top-10). Floats agree within rtol 1e-5 (atol 1e-6);
   decisions (keep, label, ids, pos, routes) are equal except at
   near-ties, where the plain version's competing scores differ by under
   1e-5 and the kernel's pick must score within 1e-5 of the plain pick;
   int8 rows are equal or off by one only where v/scale lies within 1e-4
   of a half-integer; scales agree within 2 ulp. Times are CUDA events over
   warm repeated calls.
   The staged path's kernels (rerank, prefilter, assign) are held the
   same way, with their edge cases: a depth-32 strided ring view, fp32
   rings, dead and duplicate routes, k above the live count; a zero
   basis row and a batch off the rows a block takes; K = 4218 and B = 1.
   Admit is also held with live=None (every row live). Admit's two
   launches (prologue, tile kernel), mips's (score-and-select, merge) and
   serve's (route tiles, routed rerank) are timed apart; assign's, admit's and prefilter's kernels per
   call are listed as torch.profiler records them, and the launch floor
   (one empty kernel from ``csrc/launch_floor.cu``) is timed as the
   kernels are.
3. Main path: a ``RAGServer`` on the full-size int8 config ingests 16
   batches of the NYT-like stream and answers queries two-stage, then a
   prototype-only server answers on the same engine; every ticket must be
   answered, every kernel launched (counts reset just before, read just
   after) and no plain version called; the heavy-hitter kernel launches
   once per batch. The fp32 config (depth 16) runs a few batches too.
   Answers are checked against the plain versions. The fused ingest
   ms/batch is printed next to the per-arrival loop's (PERF.md).
3b. Heavy hitter: the kernel against its plain loop, every state leaf and
   info entry exact, on the main path's own 16 calls (their masked labels
   and draws), on a Zipf label stream over 4218 clusters at capacity 100
   for every policy with exact counts, Morris, adaptive (max capacity 200)
   and gate_below_capacity, on an all-dropped batch whose window is full,
   and at B = 1. Then timed: the main path's busiest batch, and 256 valid
   Zipf arrivals at bmax 4218 (MIN_EVICT; RANDOM_EVICT) and at capacity
   100 (full), each with its device ms, the wrapper's host ms a call, us
   per valid arrival, its hits, inserts, evictions and dropped arrivals,
   the bound (the Gumbel rows of the arrivals that evict, not all B x
   bmax) and the plain loop's host ms.
4. Staged path: the same config, seed, warmup and the main path's own 16
   batches, from a fresh init, through ``engine.staged_ingest_impl``
   (``screen -> assign_update -> count -> update_representatives ->
   store_write (store-side quantize) -> upsert_snapshot``), and 8 flushes
   of 64 queries through ``route -> rerank -> decode_rerank`` on a
   published snapshot; counts reset just before: prefilter and assign
   launch once per batch, mips and rerank once per flush, heavy_hitter
   once per batch, admit and serve never, no plain version runs. The store must fill (at least 128 live
   ring slots, 8 valid prototypes, 90% of routes and picks live), so the
   comparison is not empty. Held per batch against the fused
   ``ingest_impl`` on the same batches and counter draws (keep, labels
   and ring rows under the near-tie rule; a near-tie that flips a
   decision is reported and ends the comparison there), and per flush
   against the fused ``serve_topk`` on the same snapshot (routes, pos).
4b. Async path: an ``AsyncServer`` on the same config, seed and warmup
   ingests the main path's 16 batches by ``serve_round`` (publish every
   4; ingest on its own CUDA stream) while a submitter thread submits a
   64-query burst a round; then ``sync``, the remaining flushes, and
   ``close``. Every ticket is answered exactly once, from a published
   snapshot; sampled flushes, run again whole on the recorded snapshot
   they name, give the same answers bit for bit; the lag is 0 after
   ``sync``; admit, heavy_hitter and serve launch (counts reset just
   before) and no plain version runs; torch.profiler puts the ingest
   kernels on another stream than serve's. Prints flush and answer
   p50/p99 while ingest runs beside the synchronous server's, ingest
   ms/batch on the ingest thread, docs/s and the lag at each publish.
   Then the same run once more with the interpreter's thread switch
   interval at 0.5 ms (default 5 ms), with the same checks: a diagnostic
   of how long a flush waits for the interpreter lock behind ingest.
4c. Cached async path (run after 6, so that the recsys phases' peak
   memory does not carry the new servers' per-stream cuBLAS workspaces):
   an ``AsyncServer`` with the result cache (384
   entries) and the hot set (capacity 64, refresh every 8 flushes, min
   count 2, an 8 MB pin budget = a tier of 256 clusters of 25,348 B) on
   the same config, seed and warmup ingests the main path's 16 batches
   (publish every 4) while 64-query flushes of Zipf (alpha 1.1) draws
   over a pool of 512 stream queries run, then 16 flushes with ingest
   idle, then a batch of padding rows (doc id -1: a publish that moves no
   cluster, so every entry survives it) and the last idle round once
   more; counts reset just before: mips launches once per flush that had
   pending queries (the route pass), the heavy-hitter kernel once per such
   flush on the query stream beside once per ingest batch, serve for the
   cold and hot sub-batches, no plain version. Every ticket is answered
   once and every answer equals, bit for bit (scores, doc ids, clusters),
   its query served alone by ``engine.query_snapshot`` on the recorded
   snapshot it names; hits, hot-tier serves, tier rebuilds, re-keyed
   entries and route-checked hits must be non-zero. Every query-side
   counter update the path made (the state before it, its signatures) is
   run again through the kernel and its plain loop, every leaf equal; every
   tier serve (the tier's rings and remapped route labels, the queries) is
   run again through the serve kernel and its plain version under the
   near-tie rule. Prints the flush p50/p99 (while ingest runs; idle)
   beside the same idle draws uncached on the same snapshot, the hit
   rate, the route-free exact and the route-checked hits, what the route
   check met before the clean publish (hits, routes moved, orders a
   near-tie left open), why the route witness leaves a pool query open on
   the last snapshot, hot-served, pinned bytes, the rows where the route
   pass and the served routes differed, and the query-side counter's
   device ms a call.
4d. Durable async path (after 4c): first, two engines ingest the 16 batches and
   must end bit-equal (ingest is deterministic on the card). Then a
   durable ``AsyncServer`` (journal + checkpoints every 4 applied batches,
   fsync, in a temporary directory) takes 12 batches with flushes between
   them, and its ingest thread is killed at admit hit 11
   (``faults.inject("ingest.admit:crash@11")``); a new server on the same
   directories recovers (restore, then replay of the journal tail on the
   ingest stream) and ingests the last 4 batches. Its engine state must
   equal the uncrashed engine's leaf for leaf, bit for bit (generator,
   store and counter included); admit and heavy_hitter launch once per
   applied, replayed and new batch. Prints the journal append ms, the
   full and delta checkpoints (MB, dirty clusters, device copy ms, write
   ms), the save's host ms on the ingest thread, recovery ms (restore,
   then replay) and the flush p50 overall and while a checkpoint write
   was in flight.
5. Recsys kernels: the bag kernel against its plain version at MIND's
   serve_p99 and serve_bulk shapes (1,000,000 x 64 item table, histories
   of 50 drawn from a Zipf popularity, p ~ 1/r^1.2, with a valid prefix
   of uniform length), plus its edge cases (unsorted segments with empty
   bags, a bf16 table, int64 ids, d = 18, weights=None in sum and mean, a
   bag of one entry; the d = 18 cases, N(0, 1) rows, against the plain
   version on the CPU, whose order of summation is the kernel's; wherever
   the segments are sorted, the sorted entry equals the sorting wrapper
   bit for bit); device time of MIND's path (the sorted entry: one
   launch) and of the sorting wrapper, plain, library
   (``F.embedding_bag`` + divide) and bound. Mips at MIND's retrieval
   shape (4 x 64 against 1,000,000 x 64, k = 100) likewise, and at DIEN's
   and FM's (1 x 18 and 1 x 11 against 1,000,000 rows of N(0, 0.02)), each
   with its two launches timed apart.
6. Recsys path: MIND at full width (``configs/mind.py``, params drawn on
   the card from a seeded generator) runs serve_p99, serve_bulk and
   retrieval_cand once each with the counts reset just before: bag
   launches once per user_vectors call, mips once per retrieve, no plain
   version runs; one more user_vectors call makes exactly one bag launch
   (the counter) and no sort (torch.profiler's kernel list holds one
   bag kernel and no sort kernel). Outputs are finite and shaped as the
   reference's;
   user_vectors and scores agree with the same steps on the plain bag,
   retrieved ids with plain mips + stable top-k under the near-tie rule.
   Per step: device ms, host ms, peak memory. DIEN, BERT4Rec and FM then
   run serve_p99, retrieval_cand and serve_bulk at full width (BERT4Rec's
   serve_bulk is skipped: its [262144, 2, 200, 200] fp32 attention
   scores alone are 84 GB, more than the card holds); each one's retrieved
   scores and ids are held against plain mips + stable top-k on the
   queries and table its retrieve hands mips (FM's [1,000,000, 11] table).
7. One JSON line of kernel numbers, then ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs.streaming_rag import paper_pipeline_config  # noqa: E402
from repro_torch.core import heavy_hitter, pipeline  # noqa: E402
from repro_torch.core import index as index_lib  # noqa: E402
from repro_torch.data.streams import make_stream  # noqa: E402
from repro_torch.engine import stages  # noqa: E402
from repro_torch.engine.engine import (Engine, ingest_impl,  # noqa: E402
                                       staged_ingest_impl)
from repro_torch.kernels import build, counts  # noqa: E402
from repro_torch.kernels.admit.admit import admit_cuda, admit_launcher  # noqa: E402
from repro_torch.kernels.admit.ref import admit_ref  # noqa: E402
from repro_torch.kernels.assign.assign import assign_cuda  # noqa: E402
from repro_torch.kernels.assign.ref import assign_ref  # noqa: E402
from repro_torch.kernels.bag.bag import (embedding_bag_cuda,  # noqa: E402
                                         embedding_bag_sorted_cuda)
from repro_torch.kernels.bag.ref import (embedding_bag_ref,  # noqa: E402
                                         embedding_bag_sorted_ref)
from repro_torch.kernels.common import (NEG_INF, l2_normalize,  # noqa: E402
                                        l2_normalize_queries, require_full_fp32,
                                        stable_topk)
from repro_torch.kernels.heavy_hitter.heavy_hitter import update_batch_cuda  # noqa: E402
from repro_torch.kernels.heavy_hitter.ref import update_batch_ref  # noqa: E402
from repro_torch.kernels.mips.mips import mips_launcher, mips_topk_cuda  # noqa: E402
from repro_torch.kernels.mips.ref import mips_topk_ref  # noqa: E402
from repro_torch.kernels.prefilter.prefilter import prefilter_scores_cuda  # noqa: E402
from repro_torch.kernels.prefilter.ref import prefilter_scores_ref  # noqa: E402
from repro_torch.kernels.rerank.ref import rerank_topk_ref  # noqa: E402
from repro_torch.kernels.rerank.rerank import rerank_topk_cuda  # noqa: E402
from repro_torch.kernels.serve.ref import serve_topk_ref  # noqa: E402
from repro_torch.kernels.serve.serve import serve_launcher, serve_topk_cuda  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models.api import get_arch  # noqa: E402
from repro_torch.models.testing import assert_finite, dummy_batch  # noqa: E402
from repro_torch.obs import kern  # noqa: E402
from repro_torch.serve.durability import CheckpointStore, DurabilityConfig  # noqa: E402
from repro_torch.serve.hotset import route_signature  # noqa: E402
from repro_torch.serve.runtime import AsyncServer  # noqa: E402
from repro_torch.serve.server import RAGServer, ServerConfig  # noqa: E402
from repro_torch.store import docstore, quant  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402

PEAK_FP32 = 67e12      # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
RTOL, ATOL, TIE = 1e-5, 1e-6, 1e-5
SPIN_CYCLES = 300_000_000   # about 0.2 s of one spinning kernel at H100 clocks
SEED = 0
BATCH, QUERIES, TOPK, NPROBE = 256, 64, 10, 8
MAIN_BATCHES, STAGED_FLUSHES = 16, 8
# the staged store must hold at least this much for its comparison to mean
# anything (the main path's batches fill ~180 slots and ~11 prototypes)
MIN_LIVE_SLOTS, MIN_PROTOTYPES, MIN_LIVE_SHARE = 128, 8, 0.9
SOURCES = {"admit": "src/repro/kernels/admit/admit.py:177",
           "serve": "src/repro/kernels/serve/serve.py:230",
           "mips": "src/repro/kernels/mips/mips.py:79",
           "rerank": "src/repro/kernels/rerank/rerank.py:141",
           "prefilter": "src/repro/kernels/prefilter/prefilter.py:58",
           "assign": "src/repro/kernels/assign/assign.py:78",
           "bag": "src/repro/kernels/bag/bag.py:72",
           # port-side: no pallas_call; the reference's lax.scan of update_one
           "heavy_hitter": "src/repro/core/heavy_hitter.py:289"}
RECSYS_STEPS = ("serve_p99", "serve_bulk", "retrieval_cand")
LOOP_INGEST_MS = 250.59   # fused ingest ms/batch with the per-arrival loop in place
#                           of the heavy-hitter kernel (PERF.md; H100 80GB HBM3, 700 W)
HH_ZIPF_CLUSTERS, HH_ZIPF_CAPACITY, HH_ZIPF_BATCHES = 4218, 100, 3
ASYNC_PUBLISH_EVERY = 4
# the cached path (4c): table 21's gate cell, Zipf alpha 1.1 over a pool
# larger than the cache; 8 MB of pinned tier = 256 clusters of 25,348 B
CACHE_ENTRIES, CACHE_POOL, CACHE_ZIPF, CACHE_IDLE_FLUSHES = 384, 512, 1.1, 16
PIN_BUDGET_MB, HOT_CAPACITY, HOT_REFRESH = 8.0, 64, 8
# the durable path (4d): checkpoint every 4 applied batches, the ingest
# thread killed at admit hit 11 (batch seq 10)
DURABLE_EVERY, DURABLE_CRASH_AT = 4, 11
# BERT4Rec's serve_bulk attention scores: 262144 x 2 heads x 200 x 200 fp32
BERT4REC_BULK_SKIP = ("bert4rec serve_bulk skipped on one card: its attention "
                      "scores [262144, 2, 200, 200] fp32 alone are 84 GB (the "
                      "reference runs it sharded over a pod); the CPU smoke "
                      "test covers the cell")


def full_config(store_dtype: str, depth: int) -> pipeline.PipelineConfig:
    return pipeline.budget_to_config(150.0, dim=384, base=paper_pipeline_config(
        dim=384, store_depth=depth, store_dtype=store_dtype))


def cuda_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, host-bound ms) per call, warm. Device time: CUDA events
    around ``iters`` calls queued behind a spinning kernel, so the card
    never waits for the host's Python; host-bound: the same loop with the
    card idle, which is what a caller that waits on each call pays."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if queued_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError("the card caught up with the host: not a device time")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    return ev[1].elapsed_time(ev[2]) / iters, host


def device_ms(fn, iters: int = 20) -> tuple[float, str]:
    """``cuda_ms``'s device time where the call never waits for the card;
    for a plain or library call that synchronizes inside (a large sort),
    CUDA events around ``iters`` warm calls, which then hold the host's
    share too. Returns (ms, how it was taken)."""
    try:
        return cuda_ms(fn, iters)[0], "queued"
    except RuntimeError:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / iters, "events around calls: it synchronizes"


def launch_floor_ms() -> float:
    """Device ms of one empty kernel on the current stream, by ``cuda_ms``:
    what one launch costs, read beside a bound far below it."""
    lib = build.load("launch_floor")
    lib.empty_launch.argtypes = [build.P]
    lib.empty_launch.restype = build.I
    stream = build.stream_of(torch.device("cuda"))
    return cuda_ms(lambda: build.check(lib, lib.empty_launch(stream), "empty_launch"))[0]


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def close(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() <= ATOL + RTOL * b.abs()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


class Check:
    """Collects failures and near-tie counts of one kernel's checks."""

    def __init__(self, name: str):
        self.name, self.fail, self.ties, self.err = name, [], 0, 0.0

    def floats(self, what, k, p):
        self.err = max(self.err, max_err(k, p))
        bad = int((~close(k, p)).sum())
        if bad:
            self.fail.append(f"{what}: {bad} values off (max |d| {max_err(k, p):.3g})")

    def decisions(self, what, differ, tie_ok):
        """``differ`` marks mismatches, ``tie_ok`` those the near-tie rule
        allows."""
        n_diff, n_ok = int(differ.sum()), int((differ & tie_ok).sum())
        self.ties += n_ok
        if n_diff != n_ok:
            self.fail.append(f"{what}: {n_diff - n_ok} mismatches not at near-ties")

    def done(self, label):
        print(f"  check {self.name:9s} {label:28s} "
              f"{'ok' if not self.fail else 'FAIL'}  near-ties {self.ties}  "
              f"max|d| {self.err:.3g}")
        if self.fail:
            raise AssertionError(f"{self.name} {label}: " + "; ".join(self.fail))


# ------------------------------------------------------------------- admit
def check_admit(x, basis, cent, alpha, live, store_dtype, chk: Check):
    out_k = admit_cuda(x, basis, cent, alpha, live, store_dtype=store_dtype)
    out_p = admit_ref(x, basis, cent, alpha, live, store_dtype=store_dtype)
    torch.cuda.synchronize()
    r_k, keep_k, lab_k, sim_k, v_k, s_k = out_k
    r_p, keep_p, lab_p, sim_p, v_p, s_p = out_p
    chk.floats("r", r_k, r_p)
    chk.floats("sims", sim_k, sim_p)
    chk.decisions("keep", keep_k != keep_p, (r_p - alpha).abs() < TIE)
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pick_k = sims.gather(1, lab_k.long()[:, None])[:, 0]
    pick_p = sims.gather(1, lab_p.long()[:, None])[:, 0]
    chk.decisions("labels", lab_k != lab_p, pick_k >= pick_p - TIE)
    if store_dtype == "int8":
        ulp = torch.nextafter(s_p, torch.full_like(s_p, np.inf)) - s_p
        bad_scale = int(((s_k - s_p).abs() > 2 * ulp).sum())
        if bad_scale:
            chk.fail.append(f"scales: {bad_scale} beyond 2 ulp")
        z = l2_normalize(x) / s_p[:, None]
        half = (z - z.floor() - 0.5).abs() < 1e-4
        diff = v_k.int() - v_p.int()
        chk.decisions("int8 rows", diff != 0, (diff.abs() == 1) & half)
    else:
        chk.floats("rows", v_k, v_p)
    return out_k


def admit_split(x, basis, cent, alpha, live, iters: int = 20) -> str:
    """Device ms of the kernel's two launches apart (the prologue, then the
    tile kernel) and together, int8 rows. Each timed tile kernel follows an
    untimed prologue, which zeroes the merge keys and the done counter, so
    its last block decodes the labels and sims as in a call."""
    _, run = admit_launcher(x, basis, cent, alpha, live, store_dtype="int8")
    pro, both = (cuda_ms(lambda p=p: run(p))[0] for p in (1, 3))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for i in range(iters):
        run(1)
        ev[2 * i].record()
        run(2)
        ev[2 * i + 1].record()
    torch.cuda.synchronize()
    tiles = sum(ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(iters)) / iters
    return (f"prologue {pro:.4f} ms, tile kernel {tiles:.4f} ms (after its prologue, "
            f"decode included), both {both:.4f} ms device")


def admit_bound(B, d, K, n, int8):
    flops = 2.0 * B * d * (K + n) + 2.0 * K * d + 4.0 * B * d
    nbytes = 4 * (B * d + n * d + K * d) + B + B * 13 + B * d * (1 if int8 else 4) + 4 * B
    return bound(flops, nbytes)


# -------------------------------------------------------------------- mips
def check_mips(q, index, valid, k, chk: Check):
    s_k, i_k = mips_topk_cuda(q, index, valid, k)
    s_p, i_p = mips_topk_ref(q, index, valid, k)
    torch.cuda.synchronize()
    chk.floats("scores", s_k, s_p)
    S = torch.where(valid[None], q @ index.T, NEG_INF)
    got = S.gather(1, i_k.long())
    chk.decisions("ids", i_k != i_p, (got - s_p).abs() < TIE)
    return s_k, i_k


def mips_bound(Q, N, d, k):
    return bound(2.0 * Q * N * d, 4 * (Q * d + N * d) + N + 8 * Q * k)


def mips_split(q, index, valid, k) -> str:
    """Device ms of the kernel's two launches apart (score-and-select, then
    merge) and together, on the path its plan picks at this shape."""
    plan, _, _, run = mips_launcher(q, index, valid, k)
    sel, mer, both = (cuda_ms(lambda p=p: run(p))[0] for p in (1, 2, 3))
    return (f"{plan.path} path: score-and-select {sel:.4f} ms, merge {mer:.4f} ms, "
            f"both {both:.4f} ms device")


def kernels_per_call(fn) -> str:
    """``kern.launched_kernels`` as a report ("not measured" where the profiler
    records no device activity)."""
    try:
        names = kern.launched_kernels(fn)
    except Exception as e:  # the profiler is a report here, not a check
        return f"not measured ({type(e).__name__}: {e})"
    if not names:
        return "not measured (the profiler recorded no device activity)"
    return f"{len(names)}: " + ", ".join(names)


# ------------------------------------------------------------------- serve
def plain_route_scores(qr, vectors, valid):
    return torch.where(valid[None], qr @ vectors.T, NEG_INF)


def ring_score(qn, embs, live, scales, cluster, slot):
    """Plain score of ring entries (cluster, slot) [Q, k] for each query."""
    e = embs[cluster.clamp(min=0).long(), slot.long()].float()      # [Q, k, d]
    s = torch.einsum("qd,qkd->qk", qn, e)
    if scales is not None:
        s = s * scales[cluster.clamp(min=0).long(), slot.long()]
    ok = live[cluster.clamp(min=0).long(), slot.long()] & (cluster >= 0)
    return torch.where(ok, s, NEG_INF)


def entry_scores(qn, embs, live, scales, routes, pos):
    """Plain score of each picked entry pos = j * depth + slot of the
    query's route list (NEG_INF where pos is -1)."""
    depth = embs.shape[1]
    cl = routes.gather(1, (pos.clamp(min=0) // depth).long())
    cl = torch.where(pos >= 0, cl, -1)
    return ring_score(qn, embs, live, scales, cl, pos.clamp(min=0) % depth)


def serve_split(qr, qn, vectors, valid, labels, embs, live, scales, k, nprobe) -> str:
    """Device ms of the kernel's two launches apart (route tiles, then the
    routed rerank) and together, with the plan that sized them."""
    plan, _, _, _, run = serve_launcher(qr, qn, vectors, valid, labels, embs, live, k,
                                        nprobe, scales)
    t1, t2, both = (cuda_ms(lambda p=p: run(p))[0] for p in (1, 2, 3))
    return (f"route tiles of {8 * plan.rm} queries x 64 ({plan.ntiles} column tiles, "
            f"{plan.m} route keys a query) {t1:.4f} ms, rerank in clusters of "
            f"{plan.cluster} {t2:.4f} ms, both {both:.4f} ms device")


def check_serve(qr, qn, vectors, valid, labels, embs, live, scales, k, nprobe,
                chk: Check):
    out_k = serve_topk_cuda(qr, qn, vectors, valid, labels, embs, live, k,
                            nprobe, scales)
    out_p = serve_topk_ref(qr, qn, vectors, valid, labels, embs, live, k,
                           nprobe, scales)
    torch.cuda.synchronize()
    hold_answers(qr, qn, vectors, valid, embs, live, scales, out_k, out_p, chk)
    return out_k


def hold_answers(qr, qn, vectors, valid, embs, live, scales, got, want, chk: Check):
    """Two-stage answers ``got`` = (scores, pos, routes) against ``want``
    on the same index and rings, under the near-tie rule."""
    nprobe = got[2].shape[1]
    (s_k, p_k, r_k), (s_p, p_p, r_p) = got, want
    # routes: a mismatch is allowed only after a near-tie among the plain
    # route scores up to that probe
    rs = torch.sort(plain_route_scores(qr, vectors, valid), dim=1,
                    descending=True).values[:, :nprobe + 1]
    gaps = (rs[:, :-1] - rs[:, 1:]) < TIE
    first = torch.argmax((r_k != r_p).int(), dim=1)
    tie_q = torch.cumsum(gaps.int(), dim=1).gather(1, first[:, None])[:, 0] > 0
    route_diff = (r_k != r_p).any(dim=1)
    chk.decisions("routes", route_diff, tie_q)
    same = ~route_diff
    # positions: where routes agree, the pick must score (under the plain
    # scoring of that ring entry) within TIE of the reference's pick
    entry = entry_scores(qn, embs, live, scales, r_k, p_k)
    chk.floats("scores", s_k[same], s_p[same])
    chk.floats("scores vs entries", s_k[same], entry[same])
    chk.decisions("pos", (p_k != p_p) & same[:, None], (entry - s_p).abs() < TIE)


def serve_bound(Q, d, cap, routes, depth, nprobe, k, itemsize, int8):
    """Bytes: queries, the index, and each distinct routed ring once."""
    distinct = int(torch.unique(routes[routes >= 0]).numel())
    ring = depth * (d * itemsize + 1 + (4 if int8 else 0))
    nbytes = 2 * Q * d * 4 + cap * (d * 4 + 5) + distinct * ring + Q * (k * 8 + nprobe * 4)
    flops = 2.0 * Q * (cap + nprobe * depth) * d
    return bound(flops, nbytes)


def synthetic_store(C, depth, d, int8, gen, fill=0.6):
    dev = "cuda"
    rows = l2_normalize(torch.randn((C * depth, d), generator=gen, device=dev))
    if int8:
        q, s = quant.quantize_int8(rows, dim=-1)
        embs, scales = q.view(C, depth, d), s.view(C, depth)
    else:
        embs, scales = rows.view(C, depth, d), None
    live = torch.rand((C, depth), generator=gen, device=dev) < fill
    live[torch.rand((C,), generator=gen, device=dev) < 0.05] = False  # empty rings
    return embs, live, scales


# ------------------------------------------------------------------ rerank
def check_rerank(q, embs, live, routes, k, scales, chk: Check):
    s_k, p_k = rerank_topk_cuda(q, embs, live, routes, k, scales)
    s_p, p_p = rerank_topk_ref(q, embs, live, routes, k, scales)
    torch.cuda.synchronize()
    got = entry_scores(q, embs, live, scales, routes, p_k)
    chk.floats("scores", s_k, s_p)
    chk.floats("scores vs entries", s_k, got)
    chk.decisions("pos", p_k != p_p, (got - s_p).abs() < TIE)
    return s_k, p_k


def rerank_bound(Q, d, routes, depth, k, itemsize, int8):
    """Bytes: queries, routes, each distinct routed ring once, outputs."""
    distinct = int(torch.unique(routes[routes >= 0]).numel())
    ring = depth * (d * itemsize + 1 + (4 if int8 else 0))
    nbytes = Q * d * 4 + routes.numel() * 4 + distinct * ring + Q * k * 8
    return bound(2.0 * Q * routes.shape[1] * depth * d, nbytes)


# --------------------------------------------------------------- prefilter
def check_prefilter(x, basis, alpha, chk: Check):
    r_k = prefilter_scores_cuda(x, basis)
    r_p = prefilter_scores_ref(x, basis)
    torch.cuda.synchronize()
    chk.floats("r", r_k, r_p)
    chk.decisions("keep", (r_k >= alpha) != (r_p >= alpha),
                  (r_p - alpha).abs() < TIE)


def prefilter_bound(B, n, d):
    return bound(2.0 * B * n * d + 3.0 * B * d, 4 * (B * d + n * d + B))


# ------------------------------------------------------------------ assign
def label_ties(x, cent, lab_k, lab_p):
    """Where two label vectors differ, whether the plain cosines of the
    two picks lie within TIE of each other."""
    sims = l2_normalize(x) @ l2_normalize(cent).T
    pick_k = sims.gather(1, lab_k.long()[:, None])[:, 0]
    pick_p = sims.gather(1, lab_p.long()[:, None])[:, 0]
    return (pick_k - pick_p).abs() < TIE


def check_assign(x, cent, chk: Check):
    i_k, s_k = assign_cuda(x, cent)
    i_p, s_p = assign_ref(x, cent)
    torch.cuda.synchronize()
    chk.floats("sims", s_k, s_p)
    chk.decisions("labels", i_k != i_p, label_ties(x, cent, i_k, i_p))


def assign_bound(B, K, d):
    return bound(2.0 * B * K * d + 3.0 * (B + K) * d, 4 * (B * d + K * d) + 8 * B)


def check_stage_kernels(results, x, st, alpha, q, vectors, valid, labels, gen):
    """The staged path's kernels against their plain versions at the main
    path's shapes, plus edge cases; device, host, plain and library times."""
    K, d = st.clus.centroids.shape
    # ---- rerank: routes from the index (10% dead labels), 8 queries with
    # a duplicate route, one query routed nowhere
    _, slots = mips_topk_ref(q, vectors, valid, NPROBE)
    routes = labels[slots.long()]
    routes[:8, 1] = routes[:8, 0]
    routes[9] = -1
    chk = Check("rerank")
    embs, live_r, scales = synthetic_store(K, 64, d, True, gen)
    check_rerank(q, embs, live_r, routes, TOPK, scales, chk)
    check_rerank(q, embs[:, :32], live_r[:, :32], routes, TOPK, scales[:, :32], chk)
    ms, host = cuda_ms(lambda: rerank_topk_cuda(q, embs, live_r, routes, TOPK, scales))
    plain, _ = cuda_ms(lambda: rerank_topk_ref(q, embs, live_r, routes, TOPK, scales),
                       iters=5)
    b_ms, b_by = rerank_bound(QUERIES, d, routes, 64, TOPK, 1, True)
    del embs, live_r, scales
    e32, l32, _ = synthetic_store(K, 16, d, False, gen)
    _, p32 = check_rerank(q, e32, l32, routes, 100, None, chk)
    short = int((p32 < 0).any(dim=1).sum())
    assert short > 0, "k = 100 must exceed some query's live candidates"
    del e32, l32
    chk.done(f"int8 d64 + view d32 + fp32 d16 k100 ({short} q k>live)")
    results["rerank"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None, host_ms=host)

    # ---- prefilter: admit's ragged batch, a zero basis row, B off the block
    basis = st.pre.basis
    bz = basis.clone()
    bz[2] = 0.0
    chk = Check("prefilter")
    check_prefilter(x, basis, alpha, chk)
    check_prefilter(x, bz, alpha, chk)
    check_prefilter(x[:250], basis, alpha, chk)
    chk.done("zero basis row, B=250, 37 dead rows")
    ms, host = cuda_ms(lambda: prefilter_scores_cuda(x, basis))
    plain, _ = cuda_ms(lambda: prefilter_scores_ref(x, basis))
    F = torch.nn.functional
    lib, _ = cuda_ms(lambda: torch.mean(torch.mm(F.normalize(x), F.normalize(basis).T), 1))
    b_ms, b_by = prefilter_bound(BATCH, basis.shape[0], d)
    results["prefilter"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib, host_ms=host)
    print("  prefilter library_ms is four calls: "
          "torch.mean(torch.mm(F.normalize(x), F.normalize(basis).T), 1)")
    print(f"  prefilter: kernels per call {kernels_per_call(lambda: prefilter_scores_cuda(x, basis))}")

    # ---- assign: the batch against all K centroids, and one row alone
    cent = st.clus.centroids
    chk = Check("assign")
    check_assign(x, cent, chk)
    check_assign(x[:1], cent, chk)
    chk.done(f"K={K}, B=256 and B=1")
    ms, host = cuda_ms(lambda: assign_cuda(x, cent))
    plain, _ = cuda_ms(lambda: assign_ref(x, cent))
    xn, cn = l2_normalize(x), l2_normalize(cent)
    lib, _ = cuda_ms(lambda: torch.max(torch.mm(xn, cn.T), 1))
    b_ms, b_by = assign_bound(BATCH, K, d)
    results["assign"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib, host_ms=host)
    print("  assign library_ms is two calls on unit rows: torch.max(torch.mm(xn, cn.T), 1)")
    print(f"  assign: kernels per call {kernels_per_call(lambda: assign_cuda(x, cent))}")
    print("  admit: kernels per call "
          + kernels_per_call(lambda: admit_cuda(x, st.pre.basis, cent, alpha, None,
                                                store_dtype="int8")))
    print("  rerank: no single PyTorch call computes the same function (library_ms null)")


# ------------------------------------------------------------------ recsys
def zipf_ids(rng, n: int, size) -> np.ndarray:
    """Item ids drawn from a Zipf-like popularity, p ~ 1/r^1.2 (id = rank - 1)."""
    p = 1.0 / np.arange(1, n + 1) ** 1.2
    return rng.choice(n, size=size, p=p / p.sum()).astype(np.int32)


def recsys_batch(arch, shape: str, rng) -> dict:
    """A seeded batch for one step: the spec's entries (``dummy_batch``),
    with every id drawn from the Zipf popularity and, for histories, a
    valid prefix of length uniform in [1, S] (padding at id 0)."""
    spec = arch.step(shape).input_specs
    batch = dummy_batch(spec, seed=SEED)
    if "fields" in batch:
        B, nf = spec["fields"].shape
        batch["fields"] = torch.from_numpy(
            zipf_ids(rng, arch.cfg.rows_per_field, (B, nf))).cuda()
        return batch
    B, S = spec["hist"].shape
    n = arch.cfg.n_items
    mask = np.arange(S)[None, :] < rng.integers(1, S + 1, (B, 1))
    batch["hist"] = torch.from_numpy(np.where(mask, zipf_ids(rng, n, (B, S)), 0)
                                     .astype(np.int32)).cuda()
    batch["hist_mask"] = torch.from_numpy(mask).cuda()
    batch["target"] = torch.from_numpy(zipf_ids(rng, n, (B,))).cuda()
    return batch


def mind_bag_inputs(batch):
    """The (indices, segments, weights, bags) MIND's user_vectors hands the bag."""
    hist, mask = batch["hist"], batch["hist_mask"]
    B, S = hist.shape
    seg = torch.arange(B, dtype=torch.int32, device="cuda")[:, None].expand(B, S).reshape(-1)
    return torch.where(mask, hist, 0).reshape(-1), seg, mask.float().reshape(-1), B


@contextlib.contextmanager
def plain_recsys():
    """The recsys path with its bag and mips dispatch swapped for their
    plain versions, on the same card. Yields the list of (queries, index)
    that the plain mips was called on."""
    seen = []

    def plain_mips(q, index, valid, k):
        seen.append((q, index))
        return mips_topk_ref(q, index, valid, k)

    saved = recsys.embedding_bag_sorted, recsys.mips_topk
    recsys.embedding_bag_sorted, recsys.mips_topk = embedding_bag_sorted_ref, plain_mips
    try:
        yield seen
    finally:
        recsys.embedding_bag_sorted, recsys.mips_topk = saved


def check_bag(table, idx, seg, bags, w, mode, chk: Check, plain_on_cpu=False):
    """Returns the number of empty bags (which must come out zero). The
    plain version sums with ``index_add_``, whose order on the card changes
    from run to run; ``plain_on_cpu`` runs it on CPU copies, in the order
    the kernel sums in, for rows whose size makes that order show. Where
    the segments are sorted, the sorted entry (one launch, no sort) must
    equal the sorting wrapper bit for bit."""
    out_k = embedding_bag_cuda(table, idx, seg, bags, w, mode)
    if seg.numel() < 2 or bool((seg[1:] >= seg[:-1]).all()):
        out_s = embedding_bag_sorted_cuda(table, idx, seg, bags, w, mode)
        if not torch.equal(out_s, out_k):
            chk.fail.append(f"sorted entry != sorting wrapper ({mode} d{table.shape[1]})")
    if plain_on_cpu:
        out_p = embedding_bag_ref(table.cpu(), idx.cpu(), seg.cpu(), bags,
                                  None if w is None else w.cpu(), mode).cuda()
    else:
        out_p = embedding_bag_ref(table, idx, seg, bags, w, mode)
    torch.cuda.synchronize()
    chk.floats(f"{mode} d{table.shape[1]} {table.dtype}", out_k, out_p)
    empty = torch.bincount(seg.long(), minlength=bags) == 0
    if not bool((out_k[empty] == 0).all()):
        chk.fail.append("an empty bag is not zero")
    return int(empty.sum())


def bag_bound(table, idx, bags):
    """Bytes: each distinct row once, 12 bytes per entry, the bags out."""
    d, L = table.shape[1], idx.numel()
    distinct = int(torch.unique(idx).numel())
    nbytes = distinct * d * table.element_size() + L * 12 + bags * d * 4
    return bound(2.0 * L * d, nbytes) + (distinct,)


def time_bag(label, table, idx, seg, bags, w, mode):
    """Device ms of MIND's path (the sorted entry: one launch on MIND's own
    tensors) and of the sorting wrapper, host ms, plain ms, library ms
    (F.embedding_bag + divide) and the bound."""
    ms, host = cuda_ms(lambda: embedding_bag_sorted_cuda(table, idx, seg, bags, w, mode))
    wrap, wrap_host = cuda_ms(lambda: embedding_bag_cuda(table, idx, seg, bags, w, mode))
    sort_ms, _ = cuda_ms(lambda: torch.argsort(seg, stable=True))
    order = torch.argsort(seg, stable=True)
    idx_s, seg_s, w_s = idx[order].int(), seg[order].int(), w[order].float()
    plain, _ = device_ms(lambda: embedding_bag_ref(table, idx, seg, bags, w, mode), iters=5)
    offsets = torch.searchsorted(seg_s, torch.arange(bags, device="cuda", dtype=torch.int32),
                                 out_int32=True)
    cnt = torch.diff(offsets, append=torch.tensor([idx.numel()], device="cuda",
                                                  dtype=torch.int32))
    denom = torch.clamp(cnt.float(), min=1.0)[:, None]
    F = torch.nn.functional

    def library():
        return F.embedding_bag(idx_s, table, offsets, mode="sum",
                               per_sample_weights=w_s) / denom

    lib_err = max_err(library(), embedding_bag_ref(table, idx, seg, bags, w, mode))
    lib, _ = cuda_ms(library)
    b_ms, b_by, distinct = bag_bound(table, idx, bags)
    print(f"  bag {label}: L={idx.numel()} bags={bags} distinct rows {distinct}; "
          f"MIND's path (sorted entry, one launch) {ms:.4f} ms device ({host:.4f} ms a "
          f"call from the host), sorting wrapper {wrap:.4f} ms device ({wrap_host:.4f} ms "
          f"host; its stable argsort alone {sort_ms:.4f} ms), "
          f"plain {plain:.4f} ms, library {lib:.4f} ms (two calls: F.embedding_bag "
          f"+ divide; max|d| vs plain {lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, host_ms=host, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def phase_recsys_kernels(results):
    """bag and mips against their plain versions at MIND's shapes. Returns
    (arch, params, batches) for the recsys path."""
    arch = get_arch("mind")
    t0 = time.perf_counter()
    params = arch.init(SEED)
    rng = np.random.default_rng(SEED)
    batches = {shape: recsys_batch(arch, shape, rng) for shape in RECSYS_STEPS}
    torch.cuda.synchronize()
    table = params["item_emb"]
    print(f"recsys kernels at MIND's width: item table {tuple(table.shape)}; params and "
          f"Zipf batches in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    chk = Check("bag")
    for shape in ("serve_p99", "serve_bulk"):
        idx, seg, w, B = mind_bag_inputs(batches[shape])
        check_bag(table, idx, seg, B, w, "mean", chk)
    idx, seg, w, B = mind_bag_inputs(batches["serve_p99"])
    check_bag(table.to(torch.bfloat16), idx, seg, B, w, "mean", chk)
    check_bag(table, idx.long(), seg.long(), B, w, "mean", chk)   # int64 ids as they are
    # N(0, 1) rows: held against the plain version on the CPU (check_bag)
    t18 = torch.randn((1000, 18), generator=gen, device="cuda")
    for mode in ("sum", "mean"):
        i40 = torch.randint(0, 1000, (40,), generator=gen, device="cuda", dtype=torch.int32)
        s40 = torch.randint(0, 5, (40,), generator=gen, device="cuda", dtype=torch.int32)
        empty = check_bag(t18, i40, s40, 8, None, mode, chk,   # unsorted, bags 5..7 empty
                          plain_on_cpu=True)
        check_bag(table, idx, seg, B, None, mode, chk)
        check_bag(t18, i40[:1], torch.ones((1,), dtype=torch.int32, device="cuda"), 3,
                  None, mode, chk, plain_on_cpu=True)         # a bag of one entry
    chk.done(f"p99+bulk+bf16+i64+d18+w=None, {empty} empty")
    times = {}
    for shape in ("serve_p99", "serve_bulk"):
        idx, seg, w, B = mind_bag_inputs(batches[shape])
        times[shape] = time_bag(shape, table, idx, seg, B, w, "mean")
    results["bag"] = dict(max_abs_err=chk.err, **times["serve_p99"])

    # mips at the retrieval shape: MIND's 4 interest vectors, k = 100
    with plain_recsys():
        u = arch.user_vectors(params, batches["retrieval_cand"])[0].contiguous()
    valid = torch.ones((table.shape[0],), dtype=torch.bool, device="cuda")
    chk = Check("mips")
    check_mips(u, table, valid, 100, chk)
    chk.done("MIND retrieval, k=100")
    ms, host = cuda_ms(lambda: mips_topk_cuda(u, table, valid, 100))
    plain, plain_how = device_ms(lambda: mips_topk_ref(u, table, valid, 100))
    lib, lib_how = device_ms(lambda: torch.topk(torch.mm(u, table.T), 100))
    b_ms, b_by = mips_bound(u.shape[0], table.shape[0], table.shape[1], 100)
    print(f"  mips at MIND's retrieval shape ({u.shape[0]} x {u.shape[1]} vs "
          f"{table.shape[0]} x {table.shape[1]}, k=100): {ms:.4f} ms device ({host:.4f} ms "
          f"a call from the host), plain {plain:.4f} ms ({plain_how}), library "
          f"{lib:.4f} ms (torch.topk(torch.mm(q, X.T), 100), two calls; {lib_how}), "
          f"bound {b_ms:.4f} ms ({b_by}); {mips_split(u, table, valid, 100)}")
    # DIEN's and FM's retrieve shapes: one query against 10^6 rows of d = 18
    # and d = 11 (rows not 16-byte aligned), N(0, 0.02) rows
    chk = Check("mips")
    for d in (18, 11):
        t = torch.randn((table.shape[0], d), generator=gen, device="cuda") * 0.02
        u1 = torch.randn((1, d), generator=gen, device="cuda")
        check_mips(u1, t, valid, 100, chk)
        ms, _ = cuda_ms(lambda: mips_topk_cuda(u1, t, valid, 100))
        lib, _ = device_ms(lambda: torch.topk(torch.mm(u1, t.T), 100))
        b_ms, b_by = mips_bound(1, t.shape[0], d, 100)
        print(f"  mips at 1 x {d} vs {t.shape[0]} x {d}, k=100: {ms:.4f} ms device, library "
              f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {mips_split(u1, t, valid, 100)}")
        del t
    chk.done("Q=1, d=18 and d=11, k=100")
    return arch, params, batches


def hold_retrieve(u, table, got, want, chk: Check):
    """Retrieved (scores, ids) against the plain composition: scores within
    tolerance; every score is its id's score under one interest; ids equal
    except at near-ties of the plain list (neighbours within TIE)."""
    (s_k, i_k), (s_p, i_p) = got, want
    chk.floats("retrieve scores", s_k, s_p)
    per_interest = torch.einsum("bid,bkd->bik", u, table[i_k.long()])
    own = (per_interest - s_k[:, None]).abs().min(dim=1).values
    if not bool((own < TIE).all()):
        chk.fail.append("a retrieved score is no interest's score of its id")
    gap = (s_p[:, :-1] - s_p[:, 1:]).abs() < TIE
    near = torch.zeros_like(i_p, dtype=torch.bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    chk.decisions("retrieve ids", i_k != i_p, near)


def run_steps(arch, params, batches, shapes):
    """Each step once; per step (output, host ms, peak MB)."""
    out = {}
    for shape in shapes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = arch.step(shape).fn(params, batches[shape])
        torch.cuda.synchronize()
        out[shape] = (res, (time.perf_counter() - t) * 1e3,
                      torch.cuda.max_memory_allocated() / 1e6)
    return out


def expect_shapes(arch, shape, res):
    """The reference's output shapes: [B] scores, or ([B, 100], [B, 100])."""
    B = arch.shapes[shape].dim("batch")
    if arch.shapes[shape].kind == "retrieval":
        s, i = res
        assert s.shape == i.shape == (B, 100) and i.dtype == torch.int32, (s.shape, i.shape)
    else:
        assert res.shape == (B,) and res.dtype == torch.float32, res.shape
    assert_finite(res, f"{arch.name}/{shape}")


def phase_recsys(arch, params, batches, results):
    """MIND's three serve steps at full width through the bag and mips
    kernels, held against the plain composition; then DIEN, BERT4Rec, FM."""
    counts.reset_all()
    ran = run_steps(arch, params, batches, RECSYS_STEPS)
    launches = counts.snapshot()
    print(f"recsys path: MIND {arch.cfg}; launches {launches}")
    assert launches["bag"]["kernel"] == len(RECSYS_STEPS), launches   # one per user_vectors
    assert launches["mips"]["kernel"] == 1, launches                  # one per retrieve
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    results["bag"]["launches"] = launches["bag"]["kernel"]
    # MIND's user_vectors: exactly one bag launch and no sort, by the
    # launch counter and by the kernels torch.profiler lists for one call
    b = batches["serve_p99"]
    counts.reset_all()
    arch.user_vectors(params, b)
    uv_launches = counts.snapshot()["bag"]
    assert uv_launches == {"kernel": 1, "plain": 0}, uv_launches
    names = kern.launched_kernels(lambda: arch.user_vectors(params, b))
    bag_k = [n for n in names if n in ("bag_few_kernel", "bag_many_kernel")]
    sorts = [n for n in names if "sort" in n.lower()]
    assert len(bag_k) == 1 and not sorts, names
    print(f"  mind user_vectors: 1 bag launch, no sort ({len(names)} kernels a call: "
          f"{', '.join(names)})")
    table = params["item_emb"]
    chk = Check("mind")
    for shape in RECSYS_STEPS:
        res, first_ms, peak = ran[shape]
        expect_shapes(arch, shape, res)
        b = batches[shape]
        uv = arch.user_vectors(params, b)
        with plain_recsys():
            uv_p = arch.user_vectors(params, b)
            res_p = arch.step(shape).fn(params, b)
        chk.floats(f"user_vectors {shape}", uv, uv_p)
        if shape == "retrieval_cand":
            hold_retrieve(uv_p, table, res, res_p, chk)
        else:
            chk.floats(f"score {shape}", res, res_p)
        fn = arch.step(shape).fn
        dev, host = cuda_ms(lambda: fn(params, b), iters=3 if shape == "serve_bulk" else 10)
        print(f"  mind {shape:14s} B={b['hist'].shape[0]:6d}: {dev:.4f} ms device, "
              f"{host:.4f} ms host (first call {first_ms:.2f} ms), peak memory "
              f"{peak:.1f} MB")
    chk.done("vs plain bag/mips on the card")

    for name in ("dien", "bert4rec", "fm"):
        del params, batches
        torch.cuda.empty_cache()
        arch = get_arch(name)
        params = arch.init(SEED)
        rng = np.random.default_rng(SEED)
        shapes = [s for s in ("serve_p99", "retrieval_cand", "serve_bulk")
                  if not (name == "bert4rec" and s == "serve_bulk")]
        batches = {s: recsys_batch(arch, s, rng) for s in shapes}
        counts.reset_all()
        ran = run_steps(arch, params, batches, shapes)
        launches = counts.snapshot()
        assert launches["mips"]["kernel"] == 1 and launches["bag"]["kernel"] == 0, launches
        assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
        # retrieve against plain mips on the queries and index it was given
        # (FM's concatenated [rows, k + 1] table included)
        with plain_recsys() as seen:
            want = arch.step("retrieval_cand").fn(params, batches["retrieval_cand"])
        (q, index), = seen
        chk = Check(name)
        hold_retrieve(q.reshape(want[0].shape[0], -1, q.shape[1]), index,
                      ran["retrieval_cand"][0], want, chk)
        chk.done(f"retrieve q {tuple(q.shape)} vs {tuple(index.shape)}")
        del seen, q, index, want
        for shape in shapes:
            res, first_ms, peak = ran[shape]
            expect_shapes(arch, shape, res)
            fn = arch.step(shape).fn
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(params, batches[shape])
            torch.cuda.synchronize()
            print(f"  {name:8s} {shape:14s} {(time.perf_counter() - t) * 1e3:.2f} ms host "
                  f"(warm; first {first_ms:.2f} ms), peak memory {peak:.1f} MB, finite")
        if name == "bert4rec":
            print(f"  {BERT4REC_BULK_SKIP}")


# -------------------------------------------------------------------- main
def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup():
    print(nvidia_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    require_full_fp32()
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: " + ", ".join(f"{n} {b.seconds:.2f} s" for n, b in sorted(built.items())) + ")")
    for name, b in sorted(built.items()):
        for line in b.log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas[{name}] {line.strip()}")


def warmup_rows(stream, k):
    n = -(-2 * k // BATCH)
    return np.concatenate([stream.next_batch(BATCH)["embedding"] for _ in range(n)])


def phase_kernels(results: dict):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cfg = full_config("int8", 64)
    K, d = cfg.clus.num_clusters, cfg.clus.dim
    stream = make_stream("nyt", dim=d)
    warm = warmup_rows(stream, K)
    st = pipeline.init(cfg, SEED, warm, device="cuda")
    basis, cent = st.pre.basis, st.clus.centroids
    alpha = cfg.pre.alpha
    print(f"kernel checks at K={K} d={d} B={BATCH} Q={QUERIES} k={TOPK} nprobe={NPROBE}")
    print(f"  launch floor: {launch_floor_ms():.4f} ms device (one empty kernel, "
          "csrc/launch_floor.cu, timed as the kernels are)")

    # ---- admit: a ragged batch (the tail rows dead and zero), fp32 + int8
    x = torch.from_numpy(stream.next_batch(BATCH)["embedding"]).cuda()
    live = torch.ones((BATCH,), dtype=torch.bool, device="cuda")
    live[-37:] = False
    x[-37:] = 0.0
    chk = Check("admit")
    for dt in ("fp32", "int8"):
        check_admit(x, basis, cent, alpha, live, dt, chk)
        check_admit(x, basis, cent, alpha, None, dt, chk)
    chk.done("fp32+int8, 37 dead rows, live=None")
    ms, host = cuda_ms(lambda: admit_cuda(x, basis, cent, alpha, live, store_dtype="int8"))
    ms_none, _ = cuda_ms(lambda: admit_cuda(x, basis, cent, alpha, None, store_dtype="int8"))
    print(f"  admit with live=None: {ms_none:.4f} ms device")
    print(f"  admit launches apart at B={BATCH} vs {K} x {d}: "
          f"{admit_split(x, basis, cent, alpha, live)}")
    plain, _ = cuda_ms(lambda: admit_ref(x, basis, cent, alpha, live, store_dtype="int8"))
    b_ms, b_by = admit_bound(BATCH, d, K, basis.shape[0], True)
    results["admit"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None, host_ms=host)

    # ---- mips: the prototype index with invalid rows
    q = l2_normalize(torch.from_numpy(stream.queries(QUERIES)["embedding"]).cuda())
    vectors = l2_normalize(cent)
    valid = torch.rand((K,), generator=gen, device="cuda") < 0.9
    chk = Check("mips")
    check_mips(q, vectors, valid, TOPK, chk)
    check_mips(q, vectors, valid, NPROBE, chk)
    chk.done("10% invalid rows")
    bias = torch.where(valid, 0.0, NEG_INF)[None].expand(QUERIES, K)
    ms, host = cuda_ms(lambda: mips_topk_cuda(q, vectors, valid, TOPK))
    plain, _ = cuda_ms(lambda: mips_topk_ref(q, vectors, valid, TOPK))
    lib, _ = cuda_ms(lambda: torch.topk(torch.addmm(bias, q, vectors.T), TOPK))
    b_ms, b_by = mips_bound(QUERIES, K, d, TOPK)
    results["mips"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib, host_ms=host)
    print("  mips library_ms is two calls: torch.topk(torch.addmm(bias, q, X.T), k)")
    print(f"  mips launches apart at Q={QUERIES} vs {K} x {d}, k={TOPK}: "
          f"{mips_split(q, vectors, valid, TOPK)}")

    # ---- serve: int8 depth 64, fp32 depth 16, a depth-32 strided view;
    # 10% of route labels dead so some queries meet dead routes
    labels = torch.randperm(K, generator=gen, device="cuda").to(torch.int32)
    labels[torch.rand((K,), generator=gen, device="cuda") < 0.1] = -1
    chk = Check("serve")
    embs, live_r, scales = synthetic_store(K, 64, d, True, gen)
    out = check_serve(q, q, vectors, valid, labels, embs, live_r, scales, TOPK,
                      NPROBE, chk)
    dead = int((out[2] < 0).any(dim=1).sum())
    check_serve(q, q, vectors, valid, labels, embs[:, :32], live_r[:, :32],
                scales[:, :32], TOPK, NPROBE, chk)
    ms, host = cuda_ms(lambda: serve_topk_cuda(q, q, vectors, valid, labels, embs,
                                               live_r, TOPK, NPROBE, scales))
    plain, _ = cuda_ms(lambda: serve_topk_ref(q, q, vectors, valid, labels, embs,
                                              live_r, TOPK, NPROBE, scales), iters=5)
    b_ms, b_by = serve_bound(QUERIES, d, K, out[2], 64, NPROBE, TOPK, 1, True)
    print(f"  serve launches apart at Q={QUERIES} vs {K} x {d}, int8 depth 64: "
          f"{serve_split(q, q, vectors, valid, labels, embs, live_r, scales, TOPK, NPROBE)}")
    del embs, live_r, scales
    cfg32 = full_config("fp32", 16)
    K32 = cfg32.clus.num_clusters
    e32, l32, _ = synthetic_store(K32, 16, d, False, gen)
    lab32 = torch.randperm(K32, generator=gen, device="cuda")[:K].to(torch.int32)
    lab32[labels < 0] = -1
    check_serve(q, q, vectors, valid, lab32, e32, l32, None, TOPK, NPROBE, chk)
    del e32, l32
    chk.done(f"int8 d64 + view d32 + fp32 d16, {dead} q w/ dead routes")
    results["serve"] = dict(max_abs_err=chk.err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None, host_ms=host)
    print("  admit and serve: no single PyTorch call computes the same "
          "function (library_ms null)")
    check_stage_kernels(results, x, st, alpha, q, vectors, valid, labels, gen)
    return stream, warm


def answers_ok(answers, k):
    for a in answers:
        live = a["doc_ids"] >= 0
        assert a["scores"].shape == (k,) and a["doc_ids"].shape == (k,)
        assert np.all(np.isfinite(a["scores"][live])), a
    return True


def compare_with_plain(engine, q, two_stage):
    """The engine's answer against the plain versions composed the same way
    on the same card state: scores within tolerance, ids equal except at
    near-ties. Returns the number of near-tie id swaps."""
    cfg, st = engine.cfg, engine.state
    s_k, _, i_k, _ = engine.query(q, TOPK, two_stage=two_stage, nprobe=NPROBE)
    qn = l2_normalize(q)
    if two_stage:
        scales = st.store.scales if st.store.embs.dtype == torch.int8 else None
        s_p, pos, routes = serve_topk_ref(qn, qn, st.index.vectors, st.index.valid,
                                          st.route_labels, st.store.embs,
                                          st.store.ids >= 0, TOPK, NPROBE, scales)
        i_p = stages.decode_rerank(st.store.ids, routes, s_p, pos,
                                   cfg.store_depth, NPROBE)[2]
    else:
        s_p, rows = mips_topk_ref(qn, st.index.vectors, st.index.valid, TOPK)
        i_p = st.index.ids[rows.long()]
    assert bool(((s_k - s_p).abs() < TIE).all()), "scores disagree with plain"
    return int(((i_k != i_p) & (s_p > NEG_INF / 2)).sum())


@contextlib.contextmanager
def timed_heavy_hitter():
    """Times each ``heavy_hitter.update_batch`` call (the counter's share of
    ingest, host clock between two synchronizes) into the first yielded
    list, in ms, and records each call's (cfg, state, labels, draws) into
    the second. The draws are made here from the caller's generator, as
    ``update_batch`` would make them."""
    hh_ms, calls = [], []
    real_update = heavy_hitter.update_batch

    def timed_update(cfg, state, labels, gen=None, draws=None):
        if draws is None:
            draws = heavy_hitter.draw(cfg, labels.shape[0], gen, labels.device)
        calls.append((cfg, state, labels, draws))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(cfg, state, labels, draws=draws)
        torch.cuda.synchronize()
        hh_ms.append((time.perf_counter() - t) * 1e3)
        return out

    heavy_hitter.update_batch = timed_update
    try:
        yield hh_ms, calls
    finally:
        heavy_hitter.update_batch = real_update


def phase_main(stream, warm, results):
    """``stream`` continues the stream the warmup came from. Returns the
    ingested batches."""
    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = RAGServer(cfg, scfg, seed=SEED, warmup=warm, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: k={cfg.clus.num_clusters} B={cfg.hh.bmax()} int8 depth "
          f"{cfg.store_depth}, state {pipeline.state_memory_bytes(cfg) / 1e6:.1f} MB, "
          f"init {time.perf_counter() - t0:.2f} s")

    batches = [stream.next_batch(BATCH) for _ in range(MAIN_BATCHES)]
    queries = stream.queries(QUERIES * 12)["embedding"]
    counts.reset_all()
    ingest_ms, submitted, answers = [], 0, []
    with timed_heavy_hitter() as (hh_ms, hh_calls):
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            server.ingest(b["embedding"], b["doc_id"])
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t) * 1e3)
            if i >= 4:
                for qv in queries[(i - 4) * QUERIES:(i - 3) * QUERIES]:
                    server.submit(qv)
                    submitted += 1
                answers += server.flush()
        answers += server.drain()
        proto = RAGServer(cfg, ServerConfig(max_batch=QUERIES, topk=TOPK),
                          engine=server.engine)
        for qv in queries[-2 * QUERIES:]:
            proto.submit(qv)
        proto_answers = proto.drain()
    torch.cuda.synchronize()
    launches = counts.snapshot()
    print(f"  launches on the main path: {launches}")
    for name in ("admit", "serve", "mips"):
        assert launches[name]["kernel"] > 0, f"{name} kernel never launched"
        results[name]["launches"] = launches[name]["kernel"]
    # one heavy-hitter launch per ingest batch (its plain version: none)
    assert launches["heavy_hitter"]["kernel"] == len(batches), launches["heavy_hitter"]
    results["heavy_hitter"] = dict(launches=launches["heavy_hitter"]["kernel"])
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    assert len(answers) == submitted, (len(answers), submitted)
    assert sorted(a["ticket"] for a in answers) == list(range(submitted))
    assert len(proto_answers) == 2 * QUERIES
    answers_ok(answers, TOPK)
    answers_ok(proto_answers, TOPK)

    eng = server.engine
    # device->host syncs the port makes in one more ingest batch, as torch
    # reports them, each at the innermost line of the port that made it
    # (switching the debug mode on reports one of its own, not counted)
    sync_sites = []

    def on_warning(message, *_a, **_k):
        port = [f for f in traceback.extract_stack()[:-1] if "repro_torch" in f.filename]
        if "synchroniz" in str(message) and port:
            sync_sites.append(f"{os.path.basename(port[-1].filename)}:{port[-1].lineno}")

    x, ids = stream.next_batch(BATCH)["embedding"], np.arange(10**6, 10**6 + BATCH,
                                                                 dtype=np.int32)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.ingest(x, ids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = len(sync_sites)
    ctr = eng.device_counters()
    lat = server.latency_stats()
    steady = ingest_ms[1:]
    print(f"  ingest ms/batch: median {np.median(steady):.2f} (first {ingest_ms[0]:.2f}; "
          f"with the per-arrival loop instead of the kernel: {LOOP_INGEST_MS} on an H100 80GB "
          f"HBM3 at 700 W); heavy-hitter update {np.median(hh_ms[1:]):.3f} ms = "
          f"{np.median(hh_ms[1:]) / np.median(steady) * 100:.1f}% of a batch (host clock "
          f"between synchronizes, one kernel launch)")
    print(f"  syncs per ingest batch: {syncs} seen by torch's sync debug mode, "
          f"{eng.host_syncs / (len(batches) + 1):.0f} counted by the engine; at {sync_sites}")
    print(f"  two-stage flush p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms over "
          f"{lat['batches']} flushes; prototype-only p50 {proto.latency_stats()['p50_ms']:.3f} ms")
    print(f"  answered {len(answers)}/{submitted} two-stage + {len(proto_answers)}/"
          f"{2 * QUERIES} prototype-only; upserts {eng.state.upserts}; index size "
          f"{eng.index_size()}; store fill {ctr['store_fill']:.4f}; admit rate "
          f"{ctr['admit_rate']:.3f}; max memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    q = torch.from_numpy(queries[:QUERIES]).cuda()
    for two in (True, False):
        n = compare_with_plain(eng, q, two)
        print(f"  {'two-stage' if two else 'prototype-only'} answers vs plain "
              f"versions on the card: agree, {n} near-tie id swaps")
    del server, proto, eng
    torch.cuda.empty_cache()

    cfg32 = full_config("fp32", 16)
    server32 = RAGServer(cfg32, scfg, seed=SEED, warmup=warm, device="cuda")
    for b in (stream.next_batch(BATCH) for _ in range(5)):
        server32.ingest(b["embedding"], b["doc_id"])
    for qv in queries[:QUERIES]:
        server32.submit(qv)
    got = server32.drain()
    assert len(got) == QUERIES and answers_ok(got, TOPK)
    n = compare_with_plain(server32.engine, q, True)
    print(f"  fp32 depth-16 config: k={cfg32.clus.num_clusters}, 5 batches, "
          f"{len(got)} answered, upserts {server32.engine.state.upserts}, vs plain: "
          f"{n} near-tie id swaps")
    return batches, hh_calls, lat


def written(store, before_ids):
    """(index tuple, ids, int8 rows, scales) of the ring slots a batch wrote."""
    w = torch.nonzero(store.ids != before_ids, as_tuple=True)
    return w, store.ids[w], store.embs[w], store.scales[w]


def phase_staged(stream, warm, batches, results):
    """The staged decomposition on the main path's config, seed, warmup
    and batches, held against the fused composition on the same batches."""
    cfg = full_config("int8", 64)
    alpha, depth = cfg.pre.alpha, cfg.store_depth
    n_batches = len(batches)
    queries = torch.from_numpy(stream.queries(QUERIES * STAGED_FLUSHES)["embedding"]).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    draws = [heavy_hitter.draw(cfg.hh, BATCH, gen, "cuda") for _ in batches]

    # the fused composition first, recorded per batch, outside the counts
    fused = pipeline.init(cfg, SEED, warm, device="cuda")
    ref = []
    for b, dr in zip(batches, draws):
        before = fused.store.ids.clone()
        fused, info = ingest_impl(cfg, fused, b["embedding"], b["doc_id"], dr)
        ref.append((info["keep"], info["labels"], written(fused.store, before),
                    info["stored"]))
    del fused

    # the staged composition, counted
    staged = pipeline.init(cfg, SEED, warm, device="cuda")
    torch.cuda.synchronize()
    seen, stored, ingest_ms, flush_ms, answers = [], [], [], [], []
    counts.reset_all()
    with timed_heavy_hitter() as (hh_ms, _):
        for b, dr in zip(batches, draws):
            before, cent = staged.store.ids.clone(), staged.clus.centroids
            torch.cuda.synchronize()
            t = time.perf_counter()
            staged, info = staged_ingest_impl(cfg, staged, b["embedding"],
                                              b["doc_id"], dr)
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t) * 1e3)
            seen.append((info["keep"], info["labels"], written(staged.store, before),
                         cent, staged.pre.basis))
            stored.append(info["stored"])
    snap = Engine(cfg, state=staged).publish()
    for f in range(STAGED_FLUSHES):
        q = queries[f * QUERIES:(f + 1) * QUERIES]
        torch.cuda.synchronize()
        t = time.perf_counter()
        routes = stages.route(cfg.index, snap.index, snap.route_labels, q, NPROBE)
        scores, pos = stages.rerank(snap.store, l2_normalize(q), routes, TOPK)
        out = stages.decode_rerank(snap.store.ids, routes, scores, pos, depth, NPROBE)
        host = [o.cpu().numpy() for o in out]
        flush_ms.append((time.perf_counter() - t) * 1e3)
        answers.append((q, routes, scores, pos, host))
    torch.cuda.synchronize()
    launches = counts.snapshot()
    print(f"staged path: the main path's {n_batches} batches of {BATCH}, "
          f"{STAGED_FLUSHES} flushes of {QUERIES}; launches {launches}")
    want = dict(prefilter=n_batches, assign=n_batches, mips=STAGED_FLUSHES,
                rerank=STAGED_FLUSHES, heavy_hitter=n_batches, admit=0, serve=0)
    for name, n in want.items():
        assert launches[name]["kernel"] == n, (name, launches[name], n)
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    for name in ("rerank", "prefilter", "assign"):
        results[name]["launches"] = launches[name]["kernel"]
    n_answered = live_routes = live_picks = 0
    for _, routes, _, _, (sc, rows, ids, clusters) in answers:
        live = ids >= 0
        assert sc.shape == ids.shape == (QUERIES, TOPK) and np.isfinite(sc[live]).all()
        n_answered += sc.shape[0]
        live_routes += int((routes >= 0).sum())
        live_picks += int(live.sum())
    assert n_answered == STAGED_FLUSHES * QUERIES
    live_slots, protos = int((staged.store.ids >= 0).sum()), int(staged.index.valid.sum())
    print(f"  keep per batch {[int(k.sum()) for k, *_ in seen]}; stored per batch "
          f"{[int(m.sum()) for m in stored]} (fused: "
          f"{[int(r[3].sum()) for r in ref]})")
    print(f"  staged store: {live_slots} live ring slots, {protos} valid prototypes, "
          f"{staged.upserts} upserts; live routes {live_routes}/"
          f"{n_answered * NPROBE}, live picks {live_picks}/{n_answered * TOPK}")
    assert live_slots >= MIN_LIVE_SLOTS and protos >= MIN_PROTOTYPES, (live_slots, protos)
    assert live_routes >= MIN_LIVE_SHARE * n_answered * NPROBE
    assert live_picks >= MIN_LIVE_SHARE * n_answered * TOPK

    # per batch against the fused composition
    chk = Check("staged")
    flip = None
    for i, (b, (keep_f, lab_f, (w, ids_f, rows_f, sc_f), _),
            (keep_s, lab_s, (w_s, ids_s, rows_s, sc_s), cent, basis)) in enumerate(
                zip(batches, ref, seen)):
        x = torch.from_numpy(b["embedding"]).cuda()
        r_p = prefilter_scores_ref(x, basis)
        keep_diff = keep_s != keep_f
        chk.decisions(f"keep b{i}", keep_diff, (r_p - alpha).abs() < TIE)
        lab_diff = (lab_s != lab_f) & keep_s & keep_f
        chk.decisions(f"labels b{i}", lab_diff,
                      label_ties(x, cent, lab_s.clamp(min=0), lab_f.clamp(min=0)))
        if bool(keep_diff.any() | lab_diff.any()):
            flip = i
            print(f"  a near-tie flipped a decision in batch {i}: keep "
                  f"{int(keep_diff.sum())}, labels {int(lab_diff.sum())}; "
                  f"comparing batches 0..{i - 1} only")
            break
        same_slots = len(w[0]) == len(w_s[0]) and all(torch.equal(a, c) for a, c in zip(w, w_s))
        if not same_slots or not torch.equal(ids_s, ids_f):
            chk.fail.append(f"batch {i}: the staged store wrote other slots or docs")
            break
        # int8 rows: +-1 only where v/scale lies within 1e-4 of a half-integer
        v = l2_normalize(x[(ids_s - int(b["doc_id"][0])).long()])
        ulp = torch.nextafter(sc_s, torch.full_like(sc_s, np.inf)) - sc_s
        bad = int(((sc_f - sc_s).abs() > 2 * ulp).sum())
        if bad:
            chk.fail.append(f"batch {i}: {bad} scales beyond 2 ulp")
        z = v / sc_s[:, None]
        half = (z - z.floor() - 0.5).abs() < 1e-4
        diff = rows_f.int() - rows_s.int()
        chk.decisions(f"int8 rows b{i}", diff != 0, (diff.abs() == 1) & half)
    batches_held = n_batches if flip is None else flip
    rows_held = sum(len(seen[i][2][1]) for i in range(batches_held))

    # per flush against the fused serve kernel on the same snapshot
    for q, routes, scores, pos, _ in answers:
        fused_out = stages.serve_topk(cfg.index, snap.index, snap.route_labels,
                                      snap.store, q, TOPK, NPROBE)
        qn = l2_normalize(q)
        hold_answers(qn, qn, snap.index.vectors, snap.index.valid, snap.store.embs,
                     snap.store.ids >= 0, snap.store.scales, (scores, pos, routes),
                     fused_out, chk)
    chk.done(f"{batches_held} batches ({rows_held} rows), {STAGED_FLUSHES} flushes")

    steady, hh = np.median(ingest_ms[1:]), np.median(hh_ms[1:])
    print(f"  staged ingest ms/batch: median {steady:.2f} with the heavy-hitter update, "
          f"{steady - hh:.2f} without it (update {hh:.3f} ms; first batch "
          f"{ingest_ms[0]:.2f})")
    print(f"  staged flush p50 {np.percentile(flush_ms, 50):.3f} ms p99 "
          f"{np.percentile(flush_ms, 99):.3f} ms over {len(flush_ms)} flushes; answered "
          f"{n_answered}/{STAGED_FLUSHES * QUERIES}; upserts {staged.upserts}; index size "
          f"{int(staged.index.valid.sum())}; store live {int((staged.store.ids >= 0).sum())}")


# ------------------------------------------------------------ heavy hitter
def hh_hold(got, want, what, chk: Check):
    """Every HHState leaf and every info entry equal, bit for bit."""
    (s_k, i_k), (s_p, i_p) = got, want
    bad = [n for n, a, b in zip(s_p._fields, s_k, s_p)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    bad += [n for n in i_p if i_k[n].dtype != i_p[n].dtype or not torch.equal(i_k[n], i_p[n])]
    if bad:
        chk.fail.append(f"{what}: {', '.join(bad)} differ")


def hh_check(cfg, state, labels, draws, what, chk: Check):
    """The kernel against its plain version on the same state and draws;
    returns the kernel's and the plain version's new states."""
    got = update_batch_cuda(cfg, state, labels, draws)
    want = update_batch_ref(cfg, state, labels, draws)
    torch.cuda.synchronize()
    hh_hold(got, want, what, chk)
    return got[0], want[0]


def hh_bound(cfg, B, bmax, rows):
    """Bytes these inputs need: labels and draws in, the state in and out
    once, the info out, and for RANDOM_EVICT the Gumbel rows of the
    ``rows`` arrivals that evict (no other arrival reads its row); no
    arithmetic worth a bound (integer compares)."""
    cells = cfg.cms_depth * cfg.cms_width if cfg.policy == heavy_hitter.Policy.COUNT_MIN else 0
    state = 8 * bmax + 4 * cells + 28
    draws = 4 * B * (1 + int(cfg.morris))
    if cfg.policy == heavy_hitter.Policy.RANDOM_EVICT:
        draws += 4 * rows * bmax
    return bound(0.0, 4 * B + draws + 2 * state + 10 * B)


def hh_tally(state, new, labels, info) -> dict:
    """What a batch did: hits, inserts, evictions, dropped arrivals."""
    ev = int(new.total_evictions) - int(state.total_evictions)
    return dict(valid=int((labels >= 0).sum()), hits=int(info["hit"].sum()),
                inserts=int(info["admitted"].sum()) - ev, evictions=ev,
                dropped=int((labels < 0).sum()))


def hh_timed(what, cfg, st, lab, dr):
    """Device ms and the wrapper's host ms a call of one update, its tally,
    us per valid arrival, the plain loop's host ms and the bound."""
    new, info = update_batch_cuda(cfg, st, lab, dr)
    t = hh_tally(st, new, lab, info)
    ms, host = cuda_ms(lambda: update_batch_cuda(cfg, st, lab, dr))
    plain = hh_plain_ms(lambda: update_batch_ref(cfg, st, lab, dr), iters=1)
    b_ms, b_by = hh_bound(cfg, lab.shape[0], st.labels.shape[0], t["evictions"])
    print(f"  hh {what}: {ms:.4f} ms device, {host:.4f} ms a call from the host, "
          f"{ms * 1e3 / max(t['valid'], 1):.3f} us per valid arrival; {t}; plain loop "
          f"{plain:.2f} ms (host clock); bound {b_ms:.6f} ms ({b_by})")
    return ms, host, plain, b_ms, b_by


def hh_plain_ms(fn, iters: int = 2) -> float:
    """Host ms of the plain loop between synchronizes (it is host-bound)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def hh_zipf_cfg(policy, option):
    kw = dict(capacity=HH_ZIPF_CAPACITY, policy=policy)
    if option == "morris":
        kw["morris"] = True
    elif option == "adaptive":
        kw.update(adaptive=True, max_capacity=2 * HH_ZIPF_CAPACITY)
    elif option == "gate":
        kw["gate_below_capacity"] = True
    return heavy_hitter.HHConfig(**kw)


def phase_heavy_hitter(results, calls):
    """The heavy-hitter kernel against its plain loop, every leaf exact:
    on the main path's own 16 calls (MIN_EVICT, bmax 4218, the masked
    labels and draws that path used), on a Zipf label stream over 4218
    clusters at capacity 100 (paper Table 2's B; all arrivals valid) for
    each policy with exact counts, Morris, adaptive (max 200) and
    gate_below_capacity, on an all-dropped batch whose window is already
    full, and at B = 1. Then times: device, bound, plain."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    chk = Check("hh")
    valid = [int((lab >= 0).sum()) for _, _, lab, _ in calls]
    for i, (cfg, st, lab, dr) in enumerate(calls):
        hh_check(cfg, st, lab, dr, f"main batch {i}", chk)
    cfg0, st0, lab0, dr0 = calls[0]
    hh_check(cfg0, st0, lab0[:1], {k: v[:1] for k, v in dr0.items()}, "main B=1", chk)
    writes = {}
    for policy in heavy_hitter.Policy:
        for option in ("exact", "morris", "adaptive", "gate"):
            cfg = hh_zipf_cfg(policy, option)
            st_k = st_p = heavy_hitter.init(cfg, "cuda")
            for b in range(HH_ZIPF_BATCHES):
                lab = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (BATCH,))).cuda()
                dr = heavy_hitter.draw(cfg, BATCH, gen, "cuda")
                got = update_batch_cuda(cfg, st_k, lab, dr)
                want = update_batch_ref(cfg, st_p, lab, dr)
                torch.cuda.synchronize()
                hh_hold(got, want, f"zipf {policy.name} {option} batch {b}", chk)
                st_k, st_p = got[0], want[0]
            writes[f"{policy.name}/{option}"] = (int(st_k.total_writes),
                                                 int(st_k.total_evictions))
            if option == "adaptive":   # an all-dropped batch on a full window
                full = st_k._replace(seen_in_window=torch.tensor(
                    cfg.window + 3, dtype=torch.int32, device="cuda"))
                drop = torch.full((BATCH,), -1, dtype=torch.int32, device="cuda")
                dr = heavy_hitter.draw(cfg, BATCH, gen, "cuda")
                new, _ = hh_check(cfg, full, drop, dr, f"{policy.name} all dropped", chk)
                if int(new.seen_in_window) != 0:
                    chk.fail.append("the all-dropped batch did not close the window")
            one = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (1,))).cuda()
            hh_check(cfg, st_k, one, heavy_hitter.draw(cfg, 1, gen, "cuda"),
                     f"{policy.name} {option} B=1", chk)
    chk.done(f"main x{len(calls)}, zipf 4 policies x 4 options, dropped, B=1")
    print(f"  hh: valid arrivals per main batch {valid}; zipf (writes, evictions) "
          f"after {HH_ZIPF_BATCHES} batches: {writes}")
    # ---- times: the main path's busiest batch; 256 valid Zipf arrivals at
    # bmax 4218 (MIN_EVICT, and RANDOM_EVICT, which never fills) and at
    # capacity 100 (full)
    i = int(np.argmax(valid))
    cfg, st, lab, dr = calls[i]
    ms, host, plain, b_ms, b_by = hh_timed(
        f"at the main path's batch {i} (MIN_EVICT, bmax {st.labels.shape[0]}, {valid[i]} "
        f"valid of {BATCH})", cfg, st, lab, dr)
    results["heavy_hitter"].update(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None, host_ms=host)
    for policy, cap in ((heavy_hitter.Policy.MIN_EVICT, st.labels.shape[0]),
                        (heavy_hitter.Policy.RANDOM_EVICT, st.labels.shape[0]),
                        (heavy_hitter.Policy.MIN_EVICT, HH_ZIPF_CAPACITY)):
        cfg = heavy_hitter.HHConfig(capacity=cap, policy=policy)
        st_z = heavy_hitter.init(cfg, "cuda")
        for _ in range(3):   # fill some slots first (capacity 100: all)
            lab = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (BATCH,))).cuda()
            st_z, _ = update_batch_cuda(cfg, st_z, lab, heavy_hitter.draw(cfg, BATCH, gen,
                                                                           "cuda"))
        lab = torch.from_numpy(zipf_ids(rng, HH_ZIPF_CLUSTERS, (BATCH,))).cuda()
        dr = heavy_hitter.draw(cfg, BATCH, gen, "cuda")
        hh_check(cfg, st_z, lab, dr, f"{policy.name} bmax {cfg.capacity} zipf", chk)
        hh_timed(f"{policy.name} at bmax {cfg.capacity}, {BATCH} valid Zipf arrivals",
                 cfg, st_z, lab, dr)
    chk.done("timed inputs")
    print("  heavy_hitter: no PyTorch call computes the same function (library_ms null)")



# ------------------------------------------------------------------- async
class RecordingEngine(Engine):
    """Keeps every published snapshot (so answers can be held against the
    snapshot they name) and the host ms of each ingest batch on the
    thread that ran it (no synchronize added)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.published, self.ingest_ms = {}, []

    def ingest(self, x, doc_ids, draws=None):
        t = time.perf_counter()
        out = super().ingest(x, doc_ids, draws)
        self.ingest_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def publish(self):
        snap = super().publish()
        self.published[snap.version] = snap
        return snap


class LagServer(AsyncServer):
    """Records (snapshot version, lag in docs) at every publish."""

    def __init__(self, *a, **kw):
        self.lags = []
        super().__init__(*a, **kw)

    def _publish(self):
        super()._publish()
        self.lags.append((self._snapshot.version, self.stats["docs"] - self._published_docs))


def kernel_streams(trace_path: str) -> dict[str, list]:
    """The CUDA stream id of each launch, by kernel name, in a
    torch.profiler chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            out.setdefault(e["name"], []).append(e.get("args", {}).get("stream"))
    return out


def phase_async(stream, warm, batches, sync_lat, switch_s=None):
    """An AsyncServer on the main path's config, seed and warmup ingests
    the main path's 16 batches by serve_round (publish every 4) while a
    submitter thread submits a 64-query burst each round. ``switch_s``
    sets the interpreter's thread switch interval for the run (a
    diagnostic of where a flush waits; None keeps the default and adds
    the torch.profiler window)."""
    switch = sys.getswitchinterval()
    if switch_s is not None:
        sys.setswitchinterval(switch_s)
        print(f"async path again, the interpreter's switch interval {switch_s * 1e3:g} ms "
              f"(default {switch * 1e3:g} ms):")
    try:
        _async_run(stream, warm, batches, sync_lat, profiled=switch_s is None)
    finally:
        sys.setswitchinterval(switch)


def _async_run(stream, warm, batches, sync_lat, profiled):
    from torch.profiler import ProfilerActivity, profile

    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    eng = RecordingEngine(cfg, SEED, warm, device="cuda")
    server = LagServer(cfg, scfg, engine=eng, publish_every=ASYNC_PUBLISH_EVERY, queue_max=8)
    qs = stream.queries(QUERIES * len(batches))["embedding"]
    torch.cuda.synchronize()
    submitted, flushes = {}, []
    rounds = threading.Semaphore(0)
    lock = threading.Lock()

    def submitter():
        for r in range(len(batches)):
            if not rounds.acquire(timeout=120):
                return
            for qv in qs[r * QUERIES:(r + 1) * QUERIES]:
                t = server.submit(qv)
                with lock:
                    submitted[t] = qv

    counts.reset_all()
    sub = threading.Thread(target=submitter)
    sub.start()
    t0 = time.perf_counter()
    for b in batches:
        out = server.serve_round(b)   # flush first, then enqueue the batch
        if out:
            flushes.append(out)
        rounds.release()
    sub.join(120)
    assert not sub.is_alive(), "the submitter did not finish"
    during = server.latency_stats()   # the flushes while ingest ran
    server.sync(timeout=300)
    ingest_s = time.perf_counter() - t0
    while True:
        out = server.flush()
        if not out:
            break
        flushes.append(out)
    launches = counts.snapshot()
    fresh = server.freshness_stats()
    answers = [a for f in flushes for a in f]
    # the flushes after sync, with the ingest thread idle
    idle = list(server.stats["query_latency_ms"])[during["batches"]:]
    print(f"async path: {len(batches)} batches by serve_round, publish every "
          f"{ASYNC_PUBLISH_EVERY}, {len(submitted)} queries in bursts of {QUERIES}; "
          f"launches {launches}")
    assert sorted(a["ticket"] for a in answers) == sorted(submitted), "a ticket lost or repeated"
    assert len(answers) == len(submitted) == QUERIES * len(batches)
    assert {a["snapshot_version"] for a in answers} <= set(eng.published)
    assert fresh["lag_docs"] == 0, fresh
    for name in ("admit", "heavy_hitter", "serve"):
        assert launches[name]["kernel"] > 0, f"{name} never launched on the async path"
    assert launches["admit"]["kernel"] == launches["heavy_hitter"]["kernel"] == len(batches)
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    # each sampled flush again, whole, on the snapshot it names: bit for bit
    held = 0
    for f in flushes[::3]:
        snap = eng.published[f[0]["snapshot_version"]]
        q = np.stack([submitted[a["ticket"]] for a in f])
        s_, _, ids, _ = eng.query_snapshot(snap, q, TOPK, two_stage=True, nprobe=NPROBE)
        s_, ids = s_.cpu().numpy(), ids.cpu().numpy()
        for j, a in enumerate(f):
            if not (np.array_equal(a["doc_ids"], ids[j]) and np.array_equal(a["scores"], s_[j])):
                raise AssertionError(f"ticket {a['ticket']}: not its snapshot's answer")
            held += 1
    answers_ok(answers, TOPK)
    live = sum(int((b["doc_id"] >= 0).sum()) for b in batches)
    steady = eng.ingest_ms[1:]
    print(f"  answered {len(answers)}/{len(submitted)} exactly once from "
          f"{len({a['snapshot_version'] for a in answers})} snapshots; {held} answers held "
          f"bit for bit against their recorded snapshot; lag after sync {fresh['lag_docs']}")
    print(f"  flush while ingest runs: p50 {during['p50_ms']:.3f} ms p99 {during['p99_ms']:.3f} "
          f"ms, answer p50 {during['answer_p50_ms']:.3f} ms p99 {during['answer_p99_ms']:.3f} "
          f"ms over {during['batches']} flushes; synchronous server (main path, this card): "
          f"p50 {sync_lat['p50_ms']:.3f} p99 {sync_lat['p99_ms']:.3f}, answer p50 "
          f"{sync_lat['answer_p50_ms']:.3f} p99 {sync_lat['answer_p99_ms']:.3f} ms; this "
          f"server's {len(idle)} flushes after sync (ingest idle): "
          + (f"p50 {np.percentile(idle, 50):.3f} ms max {max(idle):.3f} ms" if idle
             else "none"))
    print(f"  ingest on the ingest thread: {np.median(steady):.2f} ms/batch median (first "
          f"{eng.ingest_ms[0]:.2f}); {live} docs ingested and published in {ingest_s:.3f} s "
          f"= {live / ingest_s:.0f} docs/s; lag (docs) at each publish {server.lags}")
    if not profiled:
        server.close(timeout=300)
        return
    # torch.profiler: the ingest kernels run on another stream than serve's
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        b = stream.next_batch(BATCH)
        server.ingest(b["embedding"], b["doc_id"])
        for qv in qs[:QUERIES]:
            server.submit(qv)
        server.flush()
        server.sync(timeout=300)
        torch.cuda.synchronize()
    server.close(timeout=300)
    trace = str(build.BUILD_DIR / "async_trace.json")
    prof.export_chrome_trace(trace)
    streams = kernel_streams(trace)
    ingest_k = {n: s for n, s in streams.items()
                if any(k in n for k in ("admit_prologue_kernel", "assign_tile_kernel",
                                        "heavy_hitter_kernel"))}
    serve_k = {n: s for n, s in streams.items()
               if any(k in n for k in ("route_tile_kernel", "serve_rerank_kernel"))}
    ingest_s_ids = set().union(*ingest_k.values()) if ingest_k else set()
    serve_s_ids = set().union(*serve_k.values()) if serve_k else set()
    hh_n = sum(len(v) for n, v in ingest_k.items() if "heavy_hitter_kernel" in n)
    print(f"  torch.profiler over one more batch and flush: streams of the ingest kernels "
          f"{sorted(map(str, ingest_s_ids))}, of the serve kernels "
          f"{sorted(map(str, serve_s_ids))}; heavy_hitter kernels for the one batch: {hh_n}")
    assert len(ingest_k) == 3 and len(serve_k) == 2, (sorted(streams))
    assert hh_n == 1, hh_n
    assert None not in ingest_s_ids | serve_s_ids, "the trace names no stream"
    assert not ingest_s_ids & serve_s_ids, "ingest and serve kernels share a stream"


# ------------------------------------------------------------ cached async
def zipf_pool_draws(rng, pool: int, n: int, alpha: float = CACHE_ZIPF) -> np.ndarray:
    """``n`` indices into a pool of ``pool`` queries, rank r drawn with
    probability ~ 1 / r^alpha."""
    p = 1.0 / np.arange(1, pool + 1) ** alpha
    return rng.choice(pool, size=n, p=p / p.sum())


@contextlib.contextmanager
def calls_seen(obj, name, hook):
    """Run ``hook(*args)`` before each call of ``obj.name`` while active."""
    real = getattr(obj, name)

    def seen(*a, **kw):
        hook(*a, **kw)
        return real(*a, **kw)

    setattr(obj, name, seen)
    try:
        yield
    finally:
        setattr(obj, name, real)


def check_tier_serves(cfg, calls, chk: Check) -> int:
    """The serve kernel over each hot tier the cached path served from,
    with the inputs ``HotSet.serve`` gave it (the tier's remapped route
    labels, its gathered rings), against serve's plain version."""
    n = 0
    for snap, labels, tier, q, k, nprobe, depth in calls:
        qn = l2_normalize_queries(q)
        scales = tier.scales if tier.embs.dtype == torch.int8 else None
        embs, live, scales = stages.slice_rings(tier.embs, docstore.live_mask(tier),
                                                scales, depth)
        check_serve(qn if cfg.index.normalize else q, qn, snap.index.vectors,
                    snap.index.valid, labels, embs, live, scales, k, nprobe, chk)
        n += q.shape[0]
    return n


def route_tie_census(cfg, snap, q) -> str:
    """Which of the queries ``q`` the route witness leaves open on
    ``snap``, and why: for each, the closest pair among its top NPROBE + 1
    route scores; ties between bitwise-identical prototypes apart."""
    _, clear = stages.route_witnessed(cfg.index, snap.index, snap.route_labels, q, NPROBE)
    sc, slots, _ = index_lib.search(cfg.index, snap.index, q, NPROBE + 1)
    gaps = torch.where(sc[:, :-1] > NEG_INF / 2, sc[:, :-1] - sc[:, 1:], float("inf"))
    j = torch.argmin(gaps, dim=1)
    a = slots.gather(1, j[:, None])[:, 0].long()
    b = slots.gather(1, j[:, None] + 1)[:, 0].long()
    v = snap.index.vectors
    same = (v[a] == v[b]).all(dim=1)
    g = gaps.gather(1, j[:, None])[:, 0]
    op = torch.from_numpy(~clear).to(g.device)
    rest = g[op & ~same]
    return (f"{int(op.sum())} of {q.shape[0]} left open: {int((op & same).sum())} by "
            f"bitwise-identical prototypes (a tie every kernel breaks alike), "
            f"{rest.numel()} by closest gaps "
            f"{', '.join(f'{x:.2e}' for x in sorted(rest.tolist())[:6])}"
            f"{' ...' if rest.numel() > 6 else ''}; "
            f"{int(torch.sum(snap.index.valid))} valid prototypes")


def phase_cached(stream, warm, batches, results):
    """4c. The cached async path: result cache + hot set on the main
    path's config, ingesting its 16 batches (publish every 4) while
    64-query flushes of Zipf draws over a 512-query pool run, then 16
    flushes with ingest idle, then a publish that moves no cluster and
    the last idle round once more. Every answer is held bit for bit
    against its query served alone on the recorded snapshot it names;
    the query-side counter and the tier serves against their plain
    versions on the inputs the path gave them."""
    cfg = full_config("int8", 64)
    base = dict(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    scfg = ServerConfig(**base, cache_entries=CACHE_ENTRIES, hotset=True,
                        pin_budget_mb=PIN_BUDGET_MB, hotset_capacity=HOT_CAPACITY,
                        hotset_refresh=HOT_REFRESH, hotset_min_count=2)
    eng = RecordingEngine(cfg, SEED, warm, device="cuda")
    server = AsyncServer(cfg, scfg, engine=eng, publish_every=ASYNC_PUBLISH_EVERY,
                         queue_max=8)
    hot, cache = server._hotset, server._result_cache
    pool = stream.queries(CACHE_POOL)["embedding"]
    rng = np.random.default_rng(SEED)
    rounds = [zipf_pool_draws(rng, CACHE_POOL, QUERIES)
              for _ in range(len(batches) + CACHE_IDLE_FLUSHES)]
    # a publish that moves no cluster (a batch of padding rows, doc id -1,
    # as a fixed-size producer pads a quiet interval) keeps every entry, so
    # the last idle round asked again is answered through the route check
    pad_batch = dict(embedding=batches[-1]["embedding"],
                     doc_id=np.full_like(batches[-1]["doc_id"], -1))
    torch.cuda.synchronize()
    asked, flushes, flush_ms = {}, [], []
    observed, tier_calls = [], []

    def flush_round(draws):
        for i in draws:
            asked[server.submit(pool[i])] = i
        t = time.perf_counter()
        out = server.flush()
        flush_ms.append((time.perf_counter() - t) * 1e3)
        flushes.append(out)

    with calls_seen(hot, "observe", lambda routes: observed.append((hot.hh, routes))), \
            calls_seen(hot, "serve", lambda snap, q, k, nprobe, depth: tier_calls.append(
                (snap, hot._hot_labels, hot._tier, q, k, nprobe, depth))):
        counts.reset_all()
        for r, b in enumerate(batches):
            flush_round(rounds[r])
            server.ingest(b["embedding"], b["doc_id"])
        server.sync(timeout=300)
        for r in range(len(batches), len(rounds)):
            flush_round(rounds[r])
        before = cache.stats()
        found = dict(hit=before["hits"] - before["hits_exact"],
                     routes_moved=cache.routes_moved, near_tie=cache.unwitnessed)
        server.ingest(pad_batch["embedding"], pad_batch["doc_id"])
        server.sync(timeout=300)
        clean_publish = dict(eng.last_publish_info)
        flush_round(rounds[-1])
        torch.cuda.synchronize()
        launches = counts.snapshot()
    cs, hs, rs = server.cache_stats(), hot.stats(), cache.stats()
    route_checked = rs["hits"] - rs["hits_exact"]
    answers = [a for f in flushes for a in f]
    ingested = len(batches) + 1
    print(f"cached async path: cache {CACHE_ENTRIES} entries, hot set (capacity "
          f"{HOT_CAPACITY}, refresh {HOT_REFRESH}, pin budget {PIN_BUDGET_MB} MB = "
          f"{hs['tier_bucket']} clusters x {hot.per_cluster_bytes} B); "
          f"{len(answers)} queries, Zipf alpha {CACHE_ZIPF} over {CACHE_POOL}; "
          f"launches {launches}")
    assert sorted(a["ticket"] for a in answers) == sorted(asked), "a ticket lost or repeated"
    assert len(answers) == QUERIES * (len(rounds) + 1)
    for name in ("mips", "serve", "heavy_hitter"):
        assert launches[name]["kernel"] > 0, f"{name} never launched on the cached path"
    # one route pass (mips) and one query-side counter update a flush that
    # had pending queries, beside one counter update per ingest batch
    assert launches["heavy_hitter"]["kernel"] == ingested + launches["mips"]["kernel"]
    assert launches["mips"]["kernel"] == len(observed) <= len(rounds) + 1
    assert launches["admit"]["kernel"] == ingested
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    assert cs["hits"] > 0 and cs["hot_served"] > 0 and cs["tier_rebuilds"] > 0, cs
    assert clean_publish["mode"] == "republish", clean_publish
    assert rs["rekeyed"] > before["rekeyed"] and route_checked > 0, rs
    # every answer: its query alone on the snapshot it names, bit for bit
    for a in answers:
        snap = eng.published[a["snapshot_version"]]
        s_, _, ids, cl = eng.query_snapshot(snap, pool[asked[a["ticket"]]][None], TOPK,
                                            two_stage=True, nprobe=NPROBE)
        if not (np.array_equal(a["scores"], s_[0].cpu().numpy())
                and np.array_equal(a["doc_ids"], ids[0].cpu().numpy())
                and np.array_equal(a["clusters"], cl[0].cpu().numpy())):
            raise AssertionError(f"ticket {a['ticket']}: not its snapshot's answer")
    answers_ok(answers, TOPK)
    ties = route_tie_census(cfg, eng.published[max(eng.published)],
                            torch.from_numpy(np.asarray(pool, np.float32)).cuda())
    # the query-side counter: the kernel against its plain loop on every
    # update the path made (the state before it, its padded signatures,
    # explicit draws: MIN_EVICT at admit_prob 1 lets no draw decide)
    chk = Check("heavy_hitter")
    dgen = torch.Generator(device="cuda").manual_seed(SEED)
    for st, routes in observed:
        sigs = np.full((QUERIES,), -1, np.int32)
        sigs[:len(routes)] = [route_signature(r) for r in routes]
        sig_t = torch.from_numpy(sigs).cuda()
        hh_check(hot.hh_cfg, st, sig_t,
                 heavy_hitter.draw(hot.hh_cfg, QUERIES, dgen, sig_t.device),
                 "query side", chk)
    # ... and timed on its final state: live signatures (hits) and padding
    sigs = torch.full((QUERIES,), -1, dtype=torch.int32, device="cuda")
    live = [s for s in hot.hh.labels.cpu().tolist() if s >= 0][:QUERIES // 2]
    sigs[:len(live)] = torch.tensor(live, dtype=torch.int32)
    draws = heavy_hitter.draw(hot.hh_cfg, QUERIES, hot._gen, sigs.device)
    hh_check(hot.hh_cfg, hot.hh, sigs, draws, "query side, timed inputs", chk)
    chk.done(f"query side ({len(observed) + 1} updates)")
    hh_dev, hh_host = cuda_ms(lambda: heavy_hitter.update_batch(
        hot.hh_cfg, hot.hh, sigs, draws=draws))
    chk = Check("serve")
    n_tier = check_tier_serves(cfg, tier_calls, chk)
    chk.done(f"hot tier ({len(tier_calls)} serves)")
    assert n_tier == cs["hot_served"], (n_tier, cs["hot_served"])
    server.close(timeout=300)
    # the same idle rounds, uncached, on the same final snapshot
    plain_srv = AsyncServer(cfg, ServerConfig(**base), engine=eng, publish_every=10**9)
    idle_u = []
    for r in range(len(batches), len(rounds)):
        for i in rounds[r]:
            plain_srv.submit(pool[i])
        t = time.perf_counter()
        plain_srv.flush()
        idle_u.append((time.perf_counter() - t) * 1e3)
    plain_srv.close(timeout=300)
    during, idle = flush_ms[:len(batches)], flush_ms[len(batches):len(rounds)]
    print(f"  answered {len(answers)} exactly once; every answer bit-equal to its query "
          f"alone on its recorded snapshot ({len({a['snapshot_version'] for a in answers})} "
          f"snapshots); route pass vs served routes differed on "
          f"{server.route_mismatches} rows; {server.route_near_ties} pending rows left "
          f"unverified by a near-tie")
    print(f"  hit rate {cs['hit_rate']:.4f} ({cs['hits']} hits, {rs['hits_exact']} route-free "
          f"exact = {rs['hits_exact'] / len(answers):.4f} of queries, {route_checked} "
          f"route-checked, {cs['misses']} misses); hot-served {cs['hot_served']}; tier "
          f"rebuilds {cs['tier_rebuilds']}; pinned {cs['pinned_bytes']} B "
          f"({cs['pinned_clusters']} clusters); invalidated {cs['invalidated']}, cleared "
          f"{cs['cleared']}, evicted {cs['evicted_lru']}, rekeyed {rs['rekeyed']} "
          f"({before['rekeyed']} before the clean publish, whose route-checked hits are "
          f"{route_checked - (before['hits'] - before['hits_exact'])} of "
          f"{QUERIES}); before it, the route check met a re-keyed entry "
          f"{sum(found.values())} times: {found}")
    print(f"  route witness over the {CACHE_POOL}-query pool on the last snapshot: {ties}")
    print(f"  flush ms cached: while ingest runs p50 {np.percentile(during, 50):.3f} p99 "
          f"{np.percentile(during, 99):.3f}; ingest idle p50 {np.percentile(idle, 50):.3f} "
          f"p99 {np.percentile(idle, 99):.3f}; uncached, the same idle draws on the same "
          f"snapshot: p50 {np.percentile(idle_u, 50):.3f} p99 {np.percentile(idle_u, 99):.3f}")
    print(f"  query-side heavy_hitter (capacity {HOT_CAPACITY}, B = {QUERIES}): "
          f"{hh_dev:.4f} ms device, {hh_host:.4f} ms a call from the host")
    del server, plain_srv, eng, observed, tier_calls
    torch.cuda.empty_cache()


# ----------------------------------------------------------- durable async
@contextlib.contextmanager
def timed_method(obj, name, into: list):
    """Host ms of each call of ``obj.name`` into ``into`` while active."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        into.append((time.perf_counter() - t) * 1e3)
        return out

    setattr(obj, name, timed)
    try:
        yield into
    finally:
        setattr(obj, name, real)


def same_state(a, b) -> list[str]:
    """The leaves (checkpoint keystr paths) where two states differ."""
    fa, fb = ckpt_lib.flatten_tree(a), ckpt_lib.flatten_tree(b)
    assert fa.keys() == fb.keys()
    return [k for k in fa if not np.array_equal(ckpt_lib.to_host(fa[k]),
                                                ckpt_lib.to_host(fb[k]))]


def phase_durable(stream, warm, batches):
    """4d. The durable async path: journal + checkpoints every 4 applied
    batches (fsync), the ingest thread killed at admit hit 11, recovery
    on the same directories, the rest of the stream; the recovered state
    against an engine that never crashed, leaf for leaf, bit for bit."""
    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    crash_batch, cut = DURABLE_CRASH_AT - 1, DURABLE_CRASH_AT + 1
    # determinism first: two engines, the same batches, bit-equal states
    ref, twin = (Engine(cfg, SEED, warm, device="cuda") for _ in range(2))
    for b in batches:
        ref.ingest(b["embedding"], b["doc_id"])
        twin.ingest(b["embedding"], b["doc_id"])
    torch.cuda.synchronize()
    diff = same_state(ref.state, twin.state)
    assert not diff, f"ingest is not deterministic on the card: {diff}"
    del twin
    qs = stream.queries(QUERIES * len(batches))["embedding"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_durable_") as tmp:
        dcfg = DurabilityConfig(checkpoint_dir=tmp, checkpoint_every=DURABLE_EVERY,
                                fsync=True)
        counts.reset_all()
        srv = AsyncServer(cfg, scfg, engine=Engine(cfg, SEED, warm, device="cuda"),
                          publish_every=ASYNC_PUBLISH_EVERY, durability=dcfg,
                          queue_max=len(batches))
        dur = srv._durable
        saves, appends, snap_ms, waits, flush_ms = [], [], [], [], []
        durable_cb = dur.ckpt.on_durable
        dur.ckpt.on_durable = lambda seq: (saves.append(dict(dur.ckpt.last_save)),
                                           durable_cb(seq))
        with timed_method(dur.journal, "append", appends), \
                timed_method(dur, "checkpoint", snap_ms), \
                timed_method(dur.ckpt, "wait", waits), \
                faults.inject(f"ingest.admit:crash@{DURABLE_CRASH_AT}") as plan:
            for r, b in enumerate(batches[:cut]):
                try:
                    srv.ingest(b["embedding"], b["doc_id"])
                except RuntimeError:
                    pass   # the thread died; the batch was journaled before the put
                for qv in qs[r * QUERIES:(r + 1) * QUERIES]:
                    srv.submit(qv)
                writing = dur.ckpt._thread is not None and dur.ckpt._thread.is_alive()
                t = time.perf_counter()
                srv.flush()
                flush_ms.append(((time.perf_counter() - t) * 1e3, writing))
            srv._thread.join(120)
            assert not srv._thread.is_alive(), "the injected crash did not land"
            assert plan.fired("ingest.admit") == 1
        dur.ckpt.wait()
        applied = dur._applied_seq
        dur.close()
        torch.cuda.synchronize()
        restore_ms = []
        fresh = Engine(cfg, SEED, warm, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        with timed_method(CheckpointStore, "restore", restore_ms):
            srv2 = AsyncServer(cfg, scfg, engine=fresh,
                               publish_every=ASYNC_PUBLISH_EVERY, durability=dcfg)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t) * 1e3
        rep = srv2.recovery_report
        for b in batches[cut:]:
            srv2.ingest(b["embedding"], b["doc_id"])
        srv2.sync(timeout=300)
        torch.cuda.synchronize()
        diff = same_state(ref.state, srv2.engine.state)
        srv2.close(timeout=300)
        launches = counts.snapshot()
    print(f"durable async path: checkpoint every {DURABLE_EVERY} applied batches (fsync), "
          f"{cut} batches journaled, the ingest thread killed at batch seq {crash_batch} "
          f"({applied + 1} applied); launches {launches}")
    assert applied == crash_batch - 1, applied
    assert rep["checkpoint_seq"] is not None and rep["quarantined"] == [], rep
    assert rep["applied_seq"] == cut - 1, rep
    assert not diff, f"recovered state differs from the uncrashed engine's: {diff}"
    expect = applied + 1 + rep["replayed"] + len(batches) - cut
    assert launches["admit"]["kernel"] == launches["heavy_hitter"]["kernel"] == expect
    assert launches["serve"]["kernel"] > 0
    assert all(c["plain"] == 0 for c in launches.values()), "a plain version ran"
    fulls = [s for s in saves if s["mode"] == "full"]
    deltas = [s for s in saves if s["mode"] == "delta"]
    assert fulls and deltas, saves
    busy = [ms for ms, w in flush_ms if w]
    print(f"  recovered state equals the uncrashed engine's leaf for leaf, bit for bit "
          f"(generator, store and counter included); ingest twice from one state: "
          f"bit-equal")
    print(f"  journal append (+fsync) p50 {np.percentile(appends, 50):.3f} ms a batch "
          f"over {len(appends)}")
    for what, ss in (("full", fulls), ("delta", deltas)):
        print(f"  {what} checkpoints: " + "; ".join(
            f"seq {s['seq']} {s['bytes'] / 1e6:.2f} MB, {s['dirty_clusters']} clusters, "
            f"device copy {s['copy_ms']:.3f} ms, write {s['write_ms']:.1f} ms"
            for s in ss))
    print(f"  save() on the ingest thread: " + ", ".join(
        f"{s['mode']} {ms:.3f} ms ({w:.3f} of it waiting for the previous write)"
        for s, ms, w in zip(saves, snap_ms, waits))
        + " (the rest: signature, gather, queued copies; pinned buffers allocated on "
          "first use)")
    print(f"  recovery {recover_ms:.1f} ms in all: restore {restore_ms[0]:.1f} ms (checkpoint "
          f"seq {rep['checkpoint_seq']}), then replay of {rep['replayed']} batches and the "
          f"first publish {recover_ms - restore_ms[0]:.1f} ms")
    print(f"  flush p50 {np.percentile([m for m, _ in flush_ms], 50):.3f} ms over "
          f"{len(flush_ms)}; while a checkpoint was being written: "
          + (f"p50 {np.percentile(busy, 50):.3f} ms over {len(busy)}" if busy
             else "no flush fell inside a write"))
    del ref, srv, srv2, fresh
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_setup()
    results: dict = {}
    stream, warm = phase_kernels(results)
    batches, hh_calls, sync_lat = phase_main(stream, warm, results)
    phase_heavy_hitter(results, hh_calls)
    del hh_calls
    phase_staged(stream, warm, batches, results)
    phase_async(stream, warm, batches, sync_lat)
    phase_async(stream, warm, batches, sync_lat, switch_s=0.0005)
    torch.cuda.empty_cache()
    phase_recsys(*phase_recsys_kernels(results), results)
    # after the recsys phases: each server's ingest stream leaves cuBLAS a
    # 32 MiB workspace for the life of the process, which would otherwise
    # sit in every recsys peak-memory reading
    phase_cached(stream, warm, batches, results)
    phase_durable(stream, warm, batches)
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name:9s} kernel {r['ms']:.4f} ms device ({r['host_ms']:.4f} ms a call "
              f"from the host)  plain {r['plain_ms']:.4f} ms  library {lib}  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches on its path {r['launches']}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    kernels = [dict(name=n, route="cuda", source=f"src/repro_torch/csrc/{n}.cu",
                    replaces=SOURCES[n], launches=results[n]["launches"],
                    max_abs_err=results[n]["max_abs_err"], ms=results[n]["ms"],
                    plain_ms=results[n]["plain_ms"], bound_ms=results[n]["bound_ms"],
                    bound_by=results[n]["bound_by"], library_ms=results[n]["library_ms"])
               for n in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
