"""Quickstart on the PyTorch port: build a Streaming-RAG pipeline, ingest
a live stream, query it, and watch the index stay fresh under a memory
budget. The same steps and lines as ``examples/quickstart.py``.

Run: PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(``cuda`` by default: the admit, heavy_hitter, mips and serve kernels;
``cpu`` runs their plain versions)
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.core import heavy_hitter, pipeline
from repro_torch.data.streams import make_stream
from repro_torch.store import docstore

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

DIM = 64

# 1. A drifting, bursty news-like stream (latent topics = ground truth).
stream = make_stream("nyt", dim=DIM)
warm = np.concatenate([stream.next_batch(256)["embedding"] for _ in range(2)])

# 2. The paper's pipeline (Table 2 defaults; alpha calibrated to the
#    synthetic embedding geometry), its draws from a torch.Generator seeded 0.
cfg = paper_pipeline_config(dim=DIM, k=150, capacity=100,
                            update_interval=256, alpha=0.1,
                            store_depth=8)  # doc rings for two-stage (§5)
state = pipeline.init(cfg, seed=0, warmup=warm, device=args.device)
print(f"state memory budget: {pipeline.state_memory_bytes(cfg)/1e6:.2f} MB")

# 3. Ingest 5,000 documents (batched steps: one fused admit and one
#    heavy-hitter update per batch).
for _ in range(20):
    b = stream.next_batch(256)
    state, info = pipeline.ingest_batch(cfg, state, b["embedding"], b["doc_id"])

print(f"arrivals={int(state.arrivals)}  kept={int(state.kept)} "
      f"({100*int(state.kept)/int(state.arrivals):.0f}% passed screening)")
print(f"active clusters={int(torch.sum(heavy_hitter.active_mask(state.hh)))} "
      f"(counter capacity {cfg.hh.capacity})")
print(f"index refreshes={int(state.upserts)}  "
      f"counter writes={int(state.hh.total_writes)}")

# 4. Query the live prototype index (one representative doc per cluster).
qs = stream.queries(5)
q = torch.as_tensor(qs["embedding"], device=state.route_labels.device)
scores, rows, doc_ids, clusters = pipeline.query(cfg, state, q, k=5)
for i in range(5):
    print(f"query topic {qs['topic'][i]:>3}: "
          f"retrieved docs {doc_ids[i].tolist()} "
          f"(cos {np.round(scores[i].cpu().numpy(), 3).tolist()})")

# 5. Routed two-stage retrieval: the prototype index routes each query to
#    its top-nprobe clusters, then their per-cluster document ring buffers
#    are exact-reranked by the fused serve kernel, from the same state.
print(f"\ndoc store: {int(docstore.size(state.store))} live docs in "
      f"{cfg.clus.num_clusters} x {cfg.store_depth} ring slots")
scores2, rows2, doc_ids2, clusters2 = pipeline.query(
    cfg, state, q, k=5, two_stage=True, nprobe=10)
for i in range(5):
    print(f"query topic {qs['topic'][i]:>3}: "
          f"two-stage docs {doc_ids2[i].tolist()} "
          f"(cos {np.round(scores2[i].cpu().numpy(), 3).tolist()})")
