"""End-to-end serving on the PyTorch port: a live RAG server answering
batched queries against a continuously-updating knowledge base, with
time-sensitive QA (the paper's 'current Bitcoin mempool size' case
study — a stale snapshot answers with the old value, the streaming index
with the fresh one). The same steps and lines as
``examples/streaming_news_serve.py``.

Run: PYTHONPATH=src python examples/torch/streaming_news_serve.py [--device cpu]
(``cuda`` by default: the admit, heavy_hitter and serve kernels; ``cpu``
runs their plain versions)
"""
import argparse

import numpy as np

from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.core import baselines as B
from repro_torch.data.qa import FactStream, exact_match
from repro_torch.data.streams import make_stream
from repro_torch.serve.server import RAGServer, ServerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

DIM = 64

fact_stream = FactStream(make_stream("btc", dim=DIM), n_entities=32, seed=0)
warm = fact_stream.next_batch(256)

cfg = paper_pipeline_config(dim=DIM, k=150, capacity=100,
                            update_interval=128, alpha=0.1, store_depth=8)
# two_stage=True answers from the per-cluster document store (routed
# exact rerank) instead of one representative doc per prototype; the
# engine draws from a torch.Generator seeded 0
server = RAGServer(cfg, ServerConfig(max_batch=16, topk=10, two_stage=True,
                                     nprobe=10),
                   seed=0, warmup=warm["embedding"], device=args.device)
server.ingest(warm["embedding"], warm["doc_id"])

# a static snapshot frozen after the warmup, for contrast
static = B.make_static_rag(DIM, capacity=256)
static_state = static.init(1, device=args.device)
static_state = static.ingest(static_state, warm["embedding"], warm["doc_id"])

# live phase: facts keep changing while we serve
for _ in range(30):
    b = fact_stream.next_batch(128)
    server.serve_round(b)

queries = fact_stream.qa_queries(24)
em_live, em_static = [], []
for q in queries:
    server.submit(q["embedding"])
    (res,) = server.flush()
    pred = fact_stream.read(q, res["doc_ids"])
    em_live.append(exact_match(pred, q["answer"]))

    out = static.query(static_state, q["embedding"][None], 10)
    pred_s = fact_stream.read(q, out[2].cpu().numpy())
    em_static.append(exact_match(pred_s, q["answer"]))

lat = server.latency_stats()
print(f"docs ingested           : {server.stats['docs']}")
print(f"time-sensitive QA (EM)  : streaming={np.mean(em_live):.2f}  "
      f"static-snapshot={np.mean(em_static):.2f}")
print(f"query batch latency (ms): mean={lat['mean_ms']:.2f} "
      f"p50={lat['p50_ms']:.2f} p99={lat['p99_ms']:.2f}")
ex = queries[0]
print(f"example: '{ex['question']}' -> truth {ex['answer']}")
