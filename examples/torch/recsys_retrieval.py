"""Streaming candidate retrieval for recsys on the PyTorch port: the
paper's pipeline keeps a bounded index of *item* prototypes over a click
stream; MIND's multi-interest user vectors query it. The same steps and
lines as ``examples/recsys_retrieval.py``.

Run: PYTHONPATH=src python examples/torch/recsys_retrieval.py [--device cpu]
(``cuda`` by default: the bag kernel in MIND's user vectors, mips in both
retrievals; ``cpu`` runs their plain versions)
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.streaming_rag import paper_pipeline_config
from repro_torch.core import pipeline
from repro_torch.models.api import get_arch

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

EMB = 16
N_ITEMS = 1000

# 1. A MIND tower (smoke scale), its params drawn from a torch.Generator
#    seeded 0, provides item/user embeddings.
mind = get_arch("mind", smoke=True)
params = mind.init(0, args.device)
dev = params["item_emb"].device
item_emb = params["item_emb"].cpu().numpy()

# 2. Click stream: bursty item popularity (Zipf) — the heavy-hitter filter
#    keeps hot items' clusters, clustering keeps coverage of the tail.
rng = np.random.default_rng(0)
pop = 1.0 / np.arange(1, N_ITEMS + 1) ** 1.2
pop /= pop.sum()

cfg = paper_pipeline_config(dim=EMB, k=64, capacity=32, update_interval=128,
                            alpha=-1.0)  # no screening: all clicks count
state = pipeline.init(cfg, seed=1, warmup=item_emb[:256], device=dev)
for _ in range(20):
    clicked = rng.choice(N_ITEMS, size=128, p=pop)
    state, _ = pipeline.ingest_batch(cfg, state, item_emb[clicked],
                                     clicked.astype(np.int32))

print(f"clicks ingested: {int(state.arrivals)}, "
      f"candidate prototypes live: {int(state.index.valid.sum())}")

# 3. Multi-interest retrieval: each MIND interest queries the live index.
hist = torch.as_tensor(rng.choice(N_ITEMS, size=(4, 8), p=pop).astype(np.int32),
                       device=dev)
batch = {"hist": hist, "hist_mask": torch.ones((4, 8), dtype=torch.bool, device=dev)}
with torch.no_grad():
    interests = mind.user_vectors(params, batch)          # [4, I, d]
B, I, d = interests.shape
scores, rows, doc_ids, _ = pipeline.query(cfg, state, interests.reshape(B * I, d), k=5)
doc_ids = doc_ids.cpu().numpy().reshape(B, I, 5)
for u in range(B):
    cands = sorted(set(doc_ids[u].ravel().tolist()) - {-1})
    print(f"user {u}: candidates from {I} interests -> {cands[:10]}")

# 4. Exact full-table MIPS (the retrieval_cand path) for comparison.
with torch.no_grad():
    sc, ids = mind.retrieve(params, batch, k=5)
print("full-table MIPS top-5 (user 0):", ids[0].tolist())
