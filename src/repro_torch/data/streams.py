"""Eight real-time stream simulators (paper §Datasets), host-side numpy.

Offline container ⇒ the live feeds (NYT, Twitter, IoT, Reddit, Wikimedia,
NASDAQ, BTC mempool) are modeled as *parameterized topic-mixture processes*
matching each feed's published dynamics: arrival rate, topic cardinality,
popularity skew (Zipf s), drift rate (topic-mean rotation), burstiness
(topic popularity spikes), noise level, and irrelevant-background fraction
(items the pre-filter should drop). The synthetic Poisson stream is the
paper's own controlled-load generator.

Every item carries its latent topic id — the exact-oracle ground truth the
benchmarks score Recall@10 / nDCG@10 against (DESIGN.md §8.2).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    name: str
    dim: int = 384
    n_topics: int = 64
    zipf_s: float = 1.1          # popularity skew over topics
    drift: float = 0.01          # per-batch topic-mean rotation magnitude
    burstiness: float = 0.0      # prob. a topic spikes to 10x popularity
    noise: float = 0.35          # intra-topic spread
    background_frac: float = 0.1  # irrelevant (off-topic-subspace) items
    # SBERT-like anisotropy: all on-topic items share a corpus-mean direction
    # (real sentence embeddings are strongly non-centered), which is what
    # makes cosine screening against data-aligned topic vectors meaningful.
    anisotropy: float = 1.0
    rate_per_sec: float = 100.0  # nominal arrival rate (metadata)
    poisson_batches: bool = False  # Poisson-distributed batch sizes
    seed: int = 0


# Published dynamics of the eight feeds (paper §Datasets).
STREAMS: dict[str, StreamConfig] = {
    # NYT: ~5000 articles/day peaks, editorial topic cycle, mild drift
    "nyt": StreamConfig("nyt", n_topics=96, zipf_s=1.1, drift=0.01,
                        burstiness=0.05, noise=0.30, background_frac=0.10,
                        rate_per_sec=0.06, seed=1),
    # controlled Poisson load test
    "synthetic": StreamConfig("synthetic", n_topics=64, zipf_s=1.0, drift=0.0,
                              burstiness=0.0, noise=0.25, background_frac=0.0,
                              rate_per_sec=1000.0, poisson_batches=True, seed=2),
    # Twitter: 400 tweets/s, heavy skew, fast drift, bursty hashtags
    "twitter": StreamConfig("twitter", n_topics=256, zipf_s=1.2, drift=0.03,
                            burstiness=0.15, noise=0.45, background_frac=0.20,
                            rate_per_sec=400.0, seed=3),
    # IoT: 1000 readings/s, few modes, tiny drift, sensor noise
    "iot": StreamConfig("iot", n_topics=16, zipf_s=0.8, drift=0.002,
                        burstiness=0.02, noise=0.50, background_frac=0.05,
                        rate_per_sec=1000.0, seed=4),
    # Reddit: 50 comments/s, many communities, moderate drift
    "reddit": StreamConfig("reddit", n_topics=128, zipf_s=1.05, drift=0.015,
                           burstiness=0.10, noise=0.40, background_frac=0.15,
                           rate_per_sec=50.0, seed=5),
    # Wikimedia edits: 2/s, long-tail pages, slow drift
    "wikimedia": StreamConfig("wikimedia", n_topics=192, zipf_s=1.3,
                              drift=0.005, burstiness=0.02, noise=0.35,
                              background_frac=0.10, rate_per_sec=2.0, seed=6),
    # NASDAQ ticks: 500k/day, regime shifts (bursts), low-dim structure
    "nasdaq": StreamConfig("nasdaq", n_topics=32, zipf_s=1.0, drift=0.04,
                           burstiness=0.25, noise=0.55, background_frac=0.05,
                           rate_per_sec=5.8, seed=7),
    # BTC mempool: 3 tps, few tx archetypes, spiky fee regimes
    "btc": StreamConfig("btc", n_topics=12, zipf_s=1.1, drift=0.02,
                        burstiness=0.30, noise=0.60, background_frac=0.05,
                        rate_per_sec=3.0, seed=8),
}


class TopicStream:
    """Drifting Zipf-weighted topic-mixture embedding stream with oracle labels."""

    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        g0 = self.rng.normal(size=cfg.dim)
        self.corpus_mean = g0 / np.linalg.norm(g0)
        m = (self.rng.normal(size=(cfg.n_topics, cfg.dim))
             + cfg.anisotropy * np.sqrt(cfg.dim) * self.corpus_mean)
        self.means = m / np.linalg.norm(m, axis=1, keepdims=True)
        w = 1.0 / np.arange(1, cfg.n_topics + 1) ** max(cfg.zipf_s, 1e-3)
        self.rng.shuffle(w)
        self.base_weights = w / w.sum()
        self.spike = np.ones(cfg.n_topics)
        self.next_id = 0

    # -- dynamics ------------------------------------------------------------
    def _advance(self):
        cfg = self.cfg
        if cfg.drift > 0:  # rotate topic means by a small random step
            step = self.rng.normal(size=self.means.shape) * cfg.drift
            self.means = self.means + step
            # drift preserves the corpus-mean anisotropy
            self.means += 0.1 * cfg.drift * np.sqrt(cfg.dim) * self.corpus_mean
            self.means /= np.linalg.norm(self.means, axis=1, keepdims=True)
        if cfg.burstiness > 0:  # topic popularity spikes decay geometrically
            self.spike *= 0.9
            self.spike = np.maximum(self.spike, 1.0)
            burst = self.rng.random(cfg.n_topics) < cfg.burstiness / cfg.n_topics
            self.spike[burst] = 10.0

    def weights(self) -> np.ndarray:
        w = self.base_weights * self.spike
        return w / w.sum()

    # -- batch emission -------------------------------------------------------
    def next_batch(self, batch: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        self._advance()
        if cfg.poisson_batches:
            batch = max(1, int(self.rng.poisson(batch)))
        topics = self.rng.choice(cfg.n_topics, size=batch, p=self.weights())
        eps = self.rng.normal(size=(batch, cfg.dim))
        eps /= np.linalg.norm(eps, axis=1, keepdims=True)  # unit noise
        x = self.means[topics] * (1 - cfg.noise) + cfg.noise * eps
        # background: isotropic noise, no topic (label -1) — prefilter fodder
        bg = self.rng.random(batch) < cfg.background_frac
        x[bg] = self.rng.normal(size=(bg.sum(), cfg.dim))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        topics = np.where(bg, -1, topics)
        ids = np.arange(self.next_id, self.next_id + batch, dtype=np.int32)
        self.next_id += batch
        return {
            "embedding": x.astype(np.float32),
            "topic": topics.astype(np.int32),
            "doc_id": ids,
        }

    def batches(self, n_batches: int, batch: int) -> Iterator[dict]:
        for _ in range(n_batches):
            yield self.next_batch(batch)

    # -- query workload --------------------------------------------------------
    def queries(self, n: int, zipf_s: float | None = None) -> dict[str, np.ndarray]:
        """Queries from the *current* topic distribution (paper: Zipf s=1.2
        for Twitter; uniform-daily for NYT)."""
        cfg = self.cfg
        w = self.weights()
        if zipf_s is not None:
            w = 1.0 / np.arange(1, cfg.n_topics + 1) ** zipf_s
            w /= w.sum()
        topics = self.rng.choice(cfg.n_topics, size=n, p=w)
        eps = self.rng.normal(size=(n, cfg.dim))
        eps /= np.linalg.norm(eps, axis=1, keepdims=True)
        q = self.means[topics] * (1 - cfg.noise * 0.5) + cfg.noise * 0.5 * eps
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return {"embedding": q.astype(np.float32), "topic": topics.astype(np.int32)}


def make_stream(name: str, dim: int = 384, seed: int | None = None) -> TopicStream:
    cfg = STREAMS[name]
    if dim != cfg.dim or seed is not None:
        cfg = dataclasses.replace(cfg, dim=dim,
                                  seed=cfg.seed if seed is None else seed)
    return TopicStream(cfg)


def mixed_stream(names: list[str], dim: int = 384, seed: int = 0) -> "MixedStream":
    return MixedStream([make_stream(n, dim, seed + i) for i, n in enumerate(names)])


class MixedStream:
    """Interleave several streams (paper's bursty NYT+Twitter mix, Table 9)."""

    def __init__(self, streams: list[TopicStream]):
        self.streams = streams
        self.cfg = streams[0].cfg  # dim/metadata of the mix
        self.rng = np.random.default_rng(hash(tuple(s.cfg.name for s in streams)) % 2**31)
        self._turn = 0

    def next_batch(self, batch: int) -> dict[str, np.ndarray]:
        s = self.streams[self._turn % len(self.streams)]
        self._turn += 1
        out = s.next_batch(batch)
        # offset ids/topics per sub-stream so they never collide
        k = self.streams.index(s)
        out["doc_id"] = out["doc_id"] + np.int32(k * 10_000_000)
        out["topic"] = np.where(out["topic"] >= 0,
                                out["topic"] + k * 100_000, -1).astype(np.int32)
        return out

    def batches(self, n_batches: int, batch: int) -> Iterator[dict]:
        for _ in range(n_batches):
            yield self.next_batch(batch)

    def queries(self, n: int) -> dict[str, np.ndarray]:
        per = n // len(self.streams)
        outs = []
        for k, s in enumerate(self.streams):
            q = s.queries(per)
            q["topic"] = q["topic"] + k * 100_000
            outs.append(q)
        return {
            "embedding": np.concatenate([o["embedding"] for o in outs]),
            "topic": np.concatenate([o["topic"] for o in outs]),
        }
