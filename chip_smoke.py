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
3. Main path: a ``RAGServer`` on the full-size int8 config ingests 16
   batches of the NYT-like stream and answers queries two-stage, then a
   prototype-only server answers on the same engine; every ticket must be
   answered, every kernel launched (counts reset just before, read just
   after) and no plain version called. The fp32 config (depth 16) runs a
   few batches too. Answers are checked against the plain versions.
4. One JSON line of kernel numbers, then ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs.streaming_rag import paper_pipeline_config  # noqa: E402
from repro_torch.core import heavy_hitter, pipeline  # noqa: E402
from repro_torch.data.streams import make_stream  # noqa: E402
from repro_torch.engine import stages  # noqa: E402
from repro_torch.kernels import build, counts  # noqa: E402
from repro_torch.kernels.admit.admit import admit_cuda  # noqa: E402
from repro_torch.kernels.admit.ref import admit_ref  # noqa: E402
from repro_torch.kernels.common import (NEG_INF, l2_normalize,  # noqa: E402
                                        require_full_fp32)
from repro_torch.kernels.mips.mips import mips_topk_cuda  # noqa: E402
from repro_torch.kernels.mips.ref import mips_topk_ref  # noqa: E402
from repro_torch.kernels.serve.ref import serve_topk_ref  # noqa: E402
from repro_torch.kernels.serve.serve import serve_topk_cuda  # noqa: E402
from repro_torch.serve.server import RAGServer, ServerConfig  # noqa: E402
from repro_torch.store import quant  # noqa: E402

PEAK_FP32 = 67e12      # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
RTOL, ATOL, TIE = 1e-5, 1e-6, 1e-5
SPIN_CYCLES = 300_000_000   # about 0.2 s of one spinning kernel at H100 clocks
SEED = 0
BATCH, QUERIES, TOPK, NPROBE = 256, 64, 10, 8
SOURCES = {"admit": "src/repro/kernels/admit/admit.py:177",
           "serve": "src/repro/kernels/serve/serve.py:230",
           "mips": "src/repro/kernels/mips/mips.py:79"}


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
        print(f"  check {self.name:5s} {label:28s} "
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


def check_serve(qr, qn, vectors, valid, labels, embs, live, scales, k, nprobe,
                chk: Check):
    depth = embs.shape[1]
    out_k = serve_topk_cuda(qr, qn, vectors, valid, labels, embs, live, k,
                            nprobe, scales)
    out_p = serve_topk_ref(qr, qn, vectors, valid, labels, embs, live, k,
                           nprobe, scales)
    torch.cuda.synchronize()
    (s_k, p_k, r_k), (s_p, p_p, r_p) = out_k, out_p
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
    # positions: where routes agree, the kernel's pick must score (under the
    # plain scoring of that ring entry) within TIE of the plain pick
    cl = r_k.gather(1, (p_k.clamp(min=0) // depth).long())
    cl = torch.where(p_k >= 0, cl, -1)
    got = ring_score(qn, embs, live, scales, cl, p_k.clamp(min=0) % depth)
    chk.floats("scores", s_k[same], s_p[same])
    chk.floats("scores vs entries", s_k[same], got[same])
    chk.decisions("pos", (p_k != p_p) & same[:, None], (got - s_p).abs() < TIE)
    return out_k


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

    # ---- admit: a ragged batch (the tail rows dead and zero), fp32 + int8
    x = torch.from_numpy(stream.next_batch(BATCH)["embedding"]).cuda()
    live = torch.ones((BATCH,), dtype=torch.bool, device="cuda")
    live[-37:] = False
    x[-37:] = 0.0
    chk = Check("admit")
    for dt in ("fp32", "int8"):
        check_admit(x, basis, cent, alpha, live, dt, chk)
    chk.done("fp32+int8, 37 dead rows")
    ms, host = cuda_ms(lambda: admit_cuda(x, basis, cent, alpha, live, store_dtype="int8"))
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


def phase_main(stream, warm, results):
    """``stream`` continues the stream the warmup came from."""
    cfg = full_config("int8", 64)
    scfg = ServerConfig(max_batch=QUERIES, topk=TOPK, two_stage=True, nprobe=NPROBE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = RAGServer(cfg, scfg, seed=SEED, warmup=warm, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: k={cfg.clus.num_clusters} B={cfg.hh.bmax()} int8 depth "
          f"{cfg.store_depth}, state {pipeline.state_memory_bytes(cfg) / 1e6:.1f} MB, "
          f"init {time.perf_counter() - t0:.2f} s")

    hh_ms = []
    real_update = heavy_hitter.update_batch

    def timed_update(*a, **kw):   # the per-arrival loop's share of ingest
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(*a, **kw)
        torch.cuda.synchronize()
        hh_ms.append((time.perf_counter() - t) * 1e3)
        return out

    batches = [stream.next_batch(BATCH) for _ in range(16)]
    queries = stream.queries(QUERIES * 12)["embedding"]
    counts.reset_all()
    heavy_hitter.update_batch = timed_update
    ingest_ms, submitted, answers = [], 0, []
    try:
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
    finally:
        heavy_hitter.update_batch = real_update
    torch.cuda.synchronize()
    launches = counts.snapshot()
    print(f"  launches on the main path: {launches}")
    for name in ("admit", "serve", "mips"):
        assert launches[name]["kernel"] > 0, f"{name} kernel never launched"
        assert launches[name]["plain"] == 0, f"{name} plain version ran"
        results[name]["launches"] = launches[name]["kernel"]
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
    print(f"  ingest ms/batch: median {np.median(steady):.2f} (first {ingest_ms[0]:.2f}); "
          f"heavy-hitter loop {np.median(hh_ms[1:]):.2f} ms = "
          f"{np.median(hh_ms[1:]) / np.median(steady) * 100:.1f}% of a batch")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_setup()
    results: dict = {}
    stream, warm = phase_kernels(results)
    phase_main(stream, warm, results)
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name:5s} kernel {r['ms']:.4f} ms device ({r['host_ms']:.4f} ms a call "
              f"from the host)  plain {r['plain_ms']:.4f} ms  library {lib}  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches on the main path {r['launches']}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    kernels = [dict(name=n, route="cuda", source=f"src/repro_torch/csrc/{n}.cu",
                    replaces=SOURCES[n], launches=results[n]["launches"],
                    max_abs_err=results[n]["max_abs_err"], ms=results[n]["ms"],
                    plain_ms=results[n]["plain_ms"], bound_ms=results[n]["bound_ms"],
                    bound_by=results[n]["bound_by"], library_ms=results[n]["library_ms"])
               for n in ("admit", "serve", "mips")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
