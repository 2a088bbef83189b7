"""The paper's six comparison strategies (§Baselines), sharing one protocol:

    init(seed, warmup=None, device=None) -> state
    ingest(state, x, ids, draws=None) -> state
    query(state, q, k) -> (scores, rows, ids)

* Static RAG          — index built once from the warmup prefix, never updated.
* Full Rebuild        — buffer recent docs; rebuild the whole index (fresh
                        k-means) every refresh interval.
* Reservoir Sampling  — Vitter's uniform reservoir of size k as the index.
* Heap Filtering Only — heavy-hitter filter over *frozen* random-anchor
                        labels, no clustering; index rows are each active
                        label's best-matching document.
* Faiss IVFPQ Incr.   — IVF+PQ index (``core/index.py``) with incremental adds
                        (``init(seed, train_sample, device=None)``).
* SAKR (Kang et al.)  — single-topic-vector screening + k-means + min-heap
                        top-B clusters (no admission randomness).

plus the streaming pipeline itself, prototype-only and two-stage, so one
harness drives all eight. Every state lives on one device (``cuda`` unless
``device`` says otherwise). Each random draw a method makes comes from the
``torch.Generator`` in its state, or from ``draws`` where the caller
passes them (the reference's own draws, in the tests): reservoir
{"uniforms", "slots"} per arrival, full rebuild {"picks"} (the k-means++
rows of a rebuild), heap-only and the pipelines the counter's
(``heavy_hitter.update_batch``). The reservoir draws and decides on the
host (a CPU generator): its per-arrival scan reduces to one write of the
slots' last takers. Host integers (fills, pointers, counters) decide
every branch, so no ingest reads the device back.

Duplicate writes resolve as the reference's sequential scatter does on
the CPU, the last writer of a row winning (ROADMAP C0d: Static RAG
crossing capacity tombstones its last slot).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import clustering, heavy_hitter, index as index_lib, pipeline, prefilter
from repro_torch.kernels.common import host_to_device, l2_normalize, resolve_device


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    init: Callable[..., Any]
    ingest: Callable[..., Any]
    query: Callable[..., Any]
    memory_bytes: Callable[[], int]


def _gen(seed: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _rows(x, dev: torch.device) -> torch.Tensor:
    return host_to_device(x, dev, torch.float32)


def _ids(ids, dev: torch.device) -> torch.Tensor:
    return host_to_device(ids, dev, torch.int32)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _last_writer(labels: torch.Tensor, wins: torch.Tensor, n_out: int):
    """For each of ``n_out`` targets, the last position i with wins[i] whose
    label is that target (-1 where none): the winner of a sequential
    scatter, whatever order the device writes in."""
    pos = torch.arange(labels.shape[0], device=labels.device)
    return torch.full((n_out,), -1, dtype=torch.int64, device=labels.device) \
        .scatter_reduce(0, labels.to(torch.int64), torch.where(wins, pos, -1),
                        "amax", include_self=True)


def _flat_query(icfg: index_lib.IndexConfig):
    def query(s, q, k):
        return index_lib.search(icfg, s.index, _rows(q, s.index.vectors.device), k)
    return query


# ---------------------------------------------------------------- static RAG
class StaticState(NamedTuple):
    index: index_lib.FlatIndex
    fill: int
    frozen: bool


def make_static_rag(dim: int, capacity: int = 8192):
    cfg = index_lib.IndexConfig(capacity=capacity, dim=dim)

    def init(seed: int = 0, warmup=None, device=None):
        return StaticState(index_lib.init(cfg, resolve_device(device)), 0, False)

    def ingest(s, x, ids, draws=None):
        # absorb only until capacity, then freeze (the "stale snapshot");
        # rows past it clip onto the last slot, where the batch's last row
        # wins, tombstoned (C0d)
        dev = s.index.vectors.device
        n = len(x)
        pos = s.fill + np.arange(n)
        rows = np.minimum(pos, capacity - 1)
        last = np.ones(n, bool)
        last[:-1] = rows[:-1] != rows[1:]
        sel = np.nonzero(last)[0]
        can = (not s.frozen) & (pos[sel] < capacity)
        sel_t = host_to_device(sel, dev)
        idx = index_lib.upsert(cfg, s.index, host_to_device(rows[sel], dev),
                               _rows(x, dev).index_select(0, sel_t),
                               _ids(ids, dev).index_select(0, sel_t),
                               host_to_device(can, dev))
        fill = min(s.fill + n, capacity)
        return StaticState(idx, fill, fill >= capacity)

    return Method("static_rag", init, ingest, _flat_query(cfg),
                  lambda: index_lib.memory_bytes(cfg))


# -------------------------------------------------------------- full rebuild
class RebuildState(NamedTuple):
    buf: torch.Tensor       # [buffer_size, d] f32 ring of recent docs
    buf_ids: torch.Tensor   # [buffer_size] i32
    ptr: int
    fill: int
    since: int              # arrivals since the last rebuild
    index: index_lib.FlatIndex
    gen: torch.Generator


def make_full_rebuild(dim: int, buffer_size: int = 2048, k: int = 100,
                      rebuild_interval: int = 1000):
    icfg = index_lib.IndexConfig(capacity=k, dim=dim)

    def init(seed: int = 0, warmup=None, device=None):
        dev = resolve_device(device)
        return RebuildState(
            torch.zeros((buffer_size, dim), dtype=torch.float32, device=dev),
            torch.full((buffer_size,), -1, dtype=torch.int32, device=dev),
            0, 0, 0, index_lib.init(icfg, dev), _gen(seed, dev))

    def rebuild(s: RebuildState, fill: int, picks):
        # full k-means from scratch over the buffer = the expensive path
        buf = s.buf
        dev = buf.device
        c = clustering.kmeans_plus_plus(s.gen, buf, k, picks)
        xn = l2_normalize(buf)
        m = torch.arange(buffer_size, device=dev) < fill
        for _ in range(3):   # Lloyd
            lbl = torch.argmax(xn @ c.T, dim=1)
            sums, cnt = clustering._segment_sums(k, xn, lbl, m)
            c = torch.where((cnt > 0)[:, None],
                            sums / torch.clamp(cnt, min=1.0)[:, None], c)
        s_all = xn @ c.T
        lbl = torch.where(m, torch.argmax(s_all, dim=1), k)
        sims = torch.max(s_all, dim=1).values
        best = torch.full((k + 1,), -torch.inf, device=dev).scatter_reduce(
            0, lbl, torch.where(m, sims, -torch.inf), "amax")[:k]
        wins = m & (sims >= best[torch.clamp(lbl, max=k - 1)])
        win = _last_writer(torch.where(wins, lbl, k), wins, k + 1)[:k]
        rep = torch.where(win >= 0, s.buf_ids[torch.clamp(win, min=0)], 0)
        return index_lib.upsert(icfg, index_lib.init(icfg, dev),
                                torch.arange(k, device=dev), c, rep,
                                best > -torch.inf)

    def ingest(s, x, ids, draws=None):
        dev = s.buf.device
        n = len(x)
        if n > buffer_size:
            raise ValueError(f"a batch of {n} overruns the buffer of {buffer_size}")
        rows = host_to_device((s.ptr + np.arange(n)) % buffer_size, dev)
        s.buf[rows] = _rows(x, dev)
        s.buf_ids[rows] = _ids(ids, dev)
        fill = min(s.fill + n, buffer_size)
        since = s.since + n
        idx = s.index
        if since >= rebuild_interval:
            idx = rebuild(s, fill, None if draws is None else draws["picks"])
            since = 0
        return s._replace(ptr=(s.ptr + n) % buffer_size, fill=fill, since=since,
                          index=idx)

    mem = lambda: buffer_size * dim * 4 + index_lib.memory_bytes(icfg)
    return Method("full_rebuild", init, ingest, _flat_query(icfg), mem)


# ---------------------------------------------------------- reservoir sample
class ReservoirState(NamedTuple):
    index: index_lib.FlatIndex
    seen: int
    gen: torch.Generator    # on the host: the reservoir decides there


def make_reservoir(dim: int, k: int = 256):
    icfg = index_lib.IndexConfig(capacity=k, dim=dim)

    def init(seed: int = 0, warmup=None, device=None):
        return ReservoirState(index_lib.init(icfg, resolve_device(device)), 0,
                              _gen(seed, torch.device("cpu")))

    def ingest(s, x, ids, draws=None):
        """Vitter: arrival t joins w.p. k/t (every one while t <= k, into
        slot t - 1), replacing a uniform slot. An arrival's decision reads
        only t and its own draws, and a take overwrites a whole row, so
        the batch is one write of each slot's last taker."""
        dev = s.index.vectors.device
        n = len(x)
        if draws is None:
            draws = {"uniforms": torch.rand((n,), generator=s.gen),
                     "slots": torch.randint(0, k, (n,), generator=s.gen)}
        u = _host(draws["uniforms"]).astype(np.float32)
        t = s.seen + 1 + np.arange(n)
        join = u < np.float32(k) / np.maximum(t, 1).astype(np.float32)
        slot = np.where(t <= k, t - 1, _host(draws["slots"]))
        take = join | (t <= k)
        last = {}
        for i in np.nonzero(take)[0]:
            last[int(slot[i])] = i
        if not last:
            return s._replace(seen=s.seen + n)
        sel = host_to_device(np.fromiter(last.values(), np.int64), dev)
        idx = index_lib.upsert(icfg, s.index,
                               host_to_device(np.fromiter(last, np.int64), dev),
                               _rows(x, dev).index_select(0, sel),
                               _ids(ids, dev).index_select(0, sel),
                               torch.ones((len(last),), dtype=torch.bool, device=dev))
        # the reference upserts once per take
        idx = idx._replace(version=s.index.version + int(take.sum()))
        return ReservoirState(idx, s.seen + n, s.gen)

    return Method("reservoir", init, ingest, _flat_query(icfg),
                  lambda: index_lib.memory_bytes(icfg))


# ------------------------------------------------------- heap filtering only
class HeapOnlyState(NamedTuple):
    anchors: torch.Tensor    # [n_anchors, d] frozen unit anchors
    hh: heavy_hitter.HHState
    best_doc: torch.Tensor   # [n_anchors, d] best doc vec per anchor label
    best_id: torch.Tensor    # [n_anchors] i32
    best_sim: torch.Tensor   # [n_anchors] f32
    index: index_lib.FlatIndex
    gen: torch.Generator


def make_heap_only(dim: int, n_anchors: int = 512, capacity: int = 100,
                   admit_prob: float = 0.05):
    hcfg = heavy_hitter.HHConfig(capacity=capacity, admit_prob=admit_prob,
                                 policy=heavy_hitter.Policy.MIN_EVICT)
    icfg = index_lib.IndexConfig(capacity=capacity, dim=dim)

    def init(seed: int = 0, warmup=None, device=None):
        dev = resolve_device(device)
        gen = _gen(seed, dev)
        anchors = l2_normalize(torch.randn((n_anchors, dim), generator=gen, device=dev))
        return HeapOnlyState(
            anchors, heavy_hitter.init(hcfg, dev),
            torch.zeros((n_anchors, dim), dtype=torch.float32, device=dev),
            torch.full((n_anchors,), -1, dtype=torch.int32, device=dev),
            torch.full((n_anchors,), -torch.inf, dtype=torch.float32, device=dev),
            index_lib.init(icfg, dev), gen)

    def ingest(s, x, ids, draws=None):
        dev = s.anchors.device
        xn = l2_normalize(_rows(x, dev))
        ids = _ids(ids, dev)
        sims_all = xn @ s.anchors.T
        labels = torch.argmax(sims_all, dim=1).to(torch.int32)
        sims = torch.max(sims_all, dim=1).values
        hh, _ = heavy_hitter.update_batch(hcfg, s.hh, labels, gen=s.gen, draws=draws)
        # track the best doc per (frozen) anchor; an exact tie in one batch
        # goes to its last row
        lab64 = labels.to(torch.int64)
        best = torch.full((n_anchors,), -torch.inf, device=dev).scatter_reduce(
            0, lab64, sims, "amax")
        best = torch.maximum(best, s.best_sim)
        wins = sims >= best[lab64]
        win = _last_writer(labels, wins, n_anchors)
        has = win >= 0
        w = torch.clamp(win, min=0)
        best_doc = torch.where(has[:, None], xn[w], s.best_doc)
        best_id = torch.where(has, ids[w], s.best_id)
        # index rows = active labels' best docs
        lbl = torch.clamp(hh.labels, min=0).to(torch.int64)
        idx = index_lib.upsert(icfg, s.index, torch.arange(capacity, device=dev),
                               best_doc[lbl], best_id[lbl], heavy_hitter.active_mask(hh))
        return HeapOnlyState(s.anchors, hh, best_doc, best_id, best, idx, s.gen)

    mem = lambda: (n_anchors * (dim + 2) * 4 + capacity * 8
                   + index_lib.memory_bytes(icfg))
    return Method("heap_only", init, ingest, _flat_query(icfg), mem)


# ------------------------------------------------------------------ IVFPQ
class IVFPQState(NamedTuple):
    index: index_lib.IVFPQIndex
    vecs: torch.Tensor   # ids -> vectors are PQ-coded; keep none (true PQ)


def make_ivfpq(dim: int, capacity: int = 4096, nlist: int = 64, m: int = 8,
               nprobe: int = 8):
    cfg = index_lib.IVFPQConfig(capacity=capacity, dim=dim, nlist=nlist, m=m,
                                nprobe=nprobe)

    def init(seed: int, train_sample, device=None, draws=None):
        """``draws`` = ``index.ivfpq_train``'s (coarse picks, codeword
        choices), else drawn from a generator seeded with ``seed``."""
        dev = resolve_device(device)
        idx = index_lib.ivfpq_train(cfg, _gen(seed, dev), _rows(train_sample, dev),
                                    draws)
        return IVFPQState(idx, torch.zeros((), device=dev))

    def ingest(s, x, ids, draws=None):
        dev = s.vecs.device
        return IVFPQState(index_lib.ivfpq_add(cfg, s.index, _rows(x, dev), _ids(ids, dev)),
                          s.vecs)

    def query(s, q, k):
        return index_lib.ivfpq_search(cfg, s.index, _rows(q, s.vecs.device), k)

    mem = lambda: (cfg.nlist * dim * 4 + cfg.m * 256 * (dim // cfg.m) * 4
                   + capacity * (cfg.m + 8))
    return Method("ivfpq_incremental", init, ingest, query, mem)


# ------------------------------------------------------- the pipeline's own
def _pipeline_method(name: str, cfg: pipeline.PipelineConfig, **query_kw):
    def init(seed: int = 0, warmup=None, device=None):
        return pipeline.init(cfg, seed, warmup, device)

    def ingest(s, x, ids, draws=None):
        return pipeline.ingest_batch(cfg, s, x, _host(ids), draws)[0]

    def query(s, q, k):
        sc, rows, ids, _ = pipeline.query(cfg, s, _rows(q, s.route_labels.device), k,
                                          **query_kw)
        return sc, rows, ids

    return Method(name, init, ingest, query, lambda: pipeline.state_memory_bytes(cfg))


def make_sakr(dim: int, k: int = 100, capacity: int = 100):
    """Kang et al. 2024: single topic vector + k-means + min-heap top-B."""
    pcfg = prefilter.PrefilterConfig(num_vectors=1, dim=dim, alpha=0.0, basis="fixed")
    ccfg = clustering.ClusterConfig(num_clusters=k, dim=dim)
    hcfg = heavy_hitter.HHConfig(capacity=capacity, admit_prob=1.0,
                                 policy=heavy_hitter.Policy.SPACE_SAVING)
    return _pipeline_method("sakr", pipeline.PipelineConfig(
        pre=pcfg, clus=ccfg, hh=hcfg, update_interval=1000))


def make_streaming_rag(cfg: pipeline.PipelineConfig):
    return _pipeline_method("streaming_rag", cfg)


def make_streaming_rag_two_stage(cfg: pipeline.PipelineConfig, nprobe: int = 8):
    """The pipeline with routed two-stage retrieval: prototype router +
    exact rerank over the per-cluster document store (same ingest path)."""
    return _pipeline_method("streaming_rag_2stage", cfg, two_stage=True, nprobe=nprobe)
