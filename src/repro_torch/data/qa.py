"""Synthetic open-domain QA + summarization workload (paper Table 13),
host-side numpy as in the reference.

GPT-3.5-Turbo is unreachable offline, so the downstream tasks are rebuilt
with exact, computable ground truth (DESIGN.md §8.3): a stream of *fact
documents* "entity e has value v (time t, topic k)" whose values drift over
time — precisely the paper's case study ("current Bitcoin mempool size").
A stale index answers with an old value; a fresh one with the latest.

Reader = extractive: among retrieved docs mentioning the queried entity,
answer with the most recent value. Metrics: EM, token-F1, ROUGE-L — the
relative Static-vs-Streaming delta is the reproduction target.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.streams import TopicStream


@dataclasses.dataclass
class FactDoc:
    doc_id: int
    entity: int
    value: str
    time: int
    topic: int
    text: str


class FactStream:
    """Wraps a TopicStream: every on-topic item becomes a fact document."""

    def __init__(self, base: TopicStream, n_entities: int = 64, seed: int = 0):
        self.base = base
        self.n_entities = n_entities
        self.rng = np.random.default_rng(seed)
        self.archive: dict[int, FactDoc] = {}
        # entity -> latest (time, value); the QA ground truth
        self.latest: dict[int, tuple[int, str]] = {}
        self.t = 0
        # entities live inside topics (entity e belongs to topic e % n_topics)
        self.entity_topic = self.rng.integers(
            0, base.cfg.n_topics, size=n_entities)

    def next_batch(self, batch: int) -> dict[str, np.ndarray]:
        out = self.base.next_batch(batch)
        ids, topics = out["doc_id"], out["topic"]
        for i in range(len(ids)):
            self.t += 1
            if topics[i] < 0:
                continue
            cands = np.where(self.entity_topic == topics[i] % self.base.cfg.n_topics)[0]
            ent = int(self.rng.choice(cands)) if len(cands) else int(
                self.rng.integers(0, self.n_entities))
            val = f"{self.rng.integers(0, 10_000) / 10:.1f}"
            doc = FactDoc(
                doc_id=int(ids[i]), entity=ent, value=val, time=self.t,
                topic=int(topics[i]),
                text=f"entity_{ent} has value {val} at time {self.t} in topic_{topics[i]}",
            )
            self.archive[doc.doc_id] = doc
            prev = self.latest.get(ent)
            if prev is None or prev[0] < self.t:
                self.latest[ent] = (self.t, val)
        return out

    # ------------------------------------------------------------------ QA
    def qa_queries(self, n: int) -> list[dict]:
        """Questions about entities with known (latest) answers."""
        ents = [e for e in self.latest]
        if not ents:
            return []
        chosen = self.rng.choice(ents, size=min(n, len(ents)), replace=False)
        qs = []
        for e in chosen:
            topic = self.entity_topic[e]
            # query embedding = the entity's topic direction (current)
            q = self.base.means[topic] + 0.1 * self.rng.normal(size=self.base.cfg.dim)
            q = q / np.linalg.norm(q)
            qs.append({
                "question": f"what is the current value of entity_{e}?",
                "entity": int(e),
                "embedding": q.astype(np.float32),
                "answer": self.latest[e][1],
            })
        return qs

    def read(self, query: dict, retrieved_doc_ids: np.ndarray) -> str:
        """Extractive reader: latest retrieved fact about the queried entity."""
        best_t, best_v = -1, ""
        for did in np.asarray(retrieved_doc_ids).ravel():
            doc = self.archive.get(int(did))
            if doc is None:
                continue
            if doc.entity == query["entity"] and doc.time > best_t:
                best_t, best_v = doc.time, doc.value
        return best_v

    # --------------------------------------------------------- summarization
    def summary_reference(self, topic: int, top: int = 3) -> str:
        """Reference summary = latest facts of the topic's busiest entities."""
        ents = [e for e in range(self.n_entities)
                if self.entity_topic[e] == topic and e in self.latest]
        ents = sorted(ents, key=lambda e: -self.latest[e][0])[:top]
        return " . ".join(
            f"entity_{e} has value {self.latest[e][1]}" for e in ents)

    def summarize(self, topic: int, retrieved_doc_ids: np.ndarray, top: int = 3) -> str:
        facts: dict[int, FactDoc] = {}
        for did in np.asarray(retrieved_doc_ids).ravel():
            doc = self.archive.get(int(did))
            if doc is None or doc.topic % self.base.cfg.n_topics != topic:
                continue
            cur = facts.get(doc.entity)
            if cur is None or doc.time > cur.time:
                facts[doc.entity] = doc
        docs = sorted(facts.values(), key=lambda d: -d.time)[:top]
        return " . ".join(f"entity_{d.entity} has value {d.value}" for d in docs)


# ------------------------------------------------------------------ metrics
def exact_match(pred: str, ref: str) -> float:
    return float(pred.strip() == ref.strip() and ref.strip() != "")


def token_f1(pred: str, ref: str) -> float:
    p, r = pred.split(), ref.split()
    if not p or not r:
        return float(p == r)
    common: dict[str, int] = {}
    for tok in p:
        common[tok] = common.get(tok, 0) + 1
    overlap = 0
    for tok in r:
        if common.get(tok, 0) > 0:
            overlap += 1
            common[tok] -= 1
    if overlap == 0:
        return 0.0
    prec, rec = overlap / len(p), overlap / len(r)
    return 2 * prec * rec / (prec + rec)


def rouge_l(pred: str, ref: str) -> float:
    """ROUGE-L F-measure (token-level LCS)."""
    a, b = pred.split(), ref.split()
    if not a or not b:
        return 0.0
    dp = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int32)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            dp[i, j] = (dp[i - 1, j - 1] + 1 if a[i - 1] == b[j - 1]
                        else max(dp[i - 1, j], dp[i, j - 1]))
    lcs = int(dp[-1, -1])
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(a), lcs / len(b)
    return 2 * prec * rec / (prec + rec)
