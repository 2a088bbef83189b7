"""Batched streaming-RAG serving (synchronous event loop).

Couples an ``engine.Engine`` with the micro-batching front end from
``serve.runtime``: requests are queued, batched up to (max_batch,
max_wait), answered from the live state, and ingest keeps absorbing
stream batches between query rounds. Retrieval is prototype-only or
routed two-stage (``ServerConfig.two_stage``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import pipeline
from repro_torch.engine.engine import Engine
from repro_torch.serve.runtime import QueryFrontend, ServerConfig

__all__ = ["RAGServer", "ServerConfig"]


class RAGServer(QueryFrontend):
    """Runs on ``cuda`` unless ``device`` (or the given engine) says
    otherwise; raises when no card is present."""

    def __init__(self, cfg: "pipeline.PipelineConfig", server_cfg: ServerConfig,
                 seed: int | None = None, warmup=None, embed_fn=None,
                 engine: Engine | None = None, device=None):
        super().__init__(cfg, server_cfg, embed_fn)
        if engine is not None:
            assert engine.cfg == cfg, "engine.cfg disagrees with cfg"
        else:
            assert seed is not None, "either an engine or an init seed"
            engine = Engine(cfg, seed, warmup, device=device)
        self.engine = engine

    @property
    def state(self):
        return self.engine.state

    def ingest(self, embeddings, doc_ids: np.ndarray, draws: dict | None = None):
        self.engine.ingest(embeddings, doc_ids, draws)
        with self._lock:
            self.stats["docs"] += len(doc_ids)

    def _query_batch(self, q: np.ndarray, plan=None):
        return self.engine.query(q, self.scfg.topk,
                                 two_stage=self.scfg.two_stage,
                                 nprobe=self.scfg.nprobe, plan=plan)

    def serve_round(self, stream_batch=None) -> list[dict]:
        """One event-loop turn: ingest (if a stream batch arrived), then
        answer due queries."""
        if stream_batch is not None:
            self.ingest(stream_batch["embedding"], stream_batch["doc_id"])
        return self.flush() if self._flush_due() else []
