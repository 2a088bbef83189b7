"""End-to-end training on the PyTorch port: contrastively train the
SBERT-style encoder (the pipeline's embedding model) with the
fault-tolerant Trainer (async checkpoints, resume). The same steps and
lines as ``examples/train_embedder.py``.

Pairs are generated procedurally: two 'sentences' (token sequences) from
the same latent topic are positives. Use --full for the 22M-param encoder;
default is the smoke config so the example runs in seconds.

Run: PYTHONPATH=src python examples/torch/train_embedder.py [--steps 300] [--full]
     [--device cpu] [--ckpt-dir DIR]
(``cuda`` by default; without ``--ckpt-dir`` the checkpoints go to a new
directory under the temp dir)
"""
import argparse

import numpy as np
import torch

from repro_torch.models.api import get_arch
from repro_torch.train.trainer import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--full", action="store_true")
ap.add_argument("--device", default="cuda")
ap.add_argument("--ckpt-dir", default=None)
args = ap.parse_args()

arch = get_arch("streaming-rag-embedder", smoke=not args.full)
spec = arch.step("train_pairs")
B = spec.input_specs["anchor"].shape[0]
S = spec.input_specs["anchor"].shape[1]
V = arch.cfg.vocab

rng = np.random.default_rng(0)
N_TOPICS = 32
topic_vocab = rng.integers(0, V, size=(N_TOPICS, 64))  # per-topic word pool


def sample_sentences(topics):
    toks = np.stack([rng.choice(topic_vocab[t], size=S) for t in topics])
    return (torch.as_tensor(toks, dtype=torch.int32, device=tr.device),
            torch.ones((len(topics), S), dtype=torch.bool, device=tr.device))


def data_iter():
    while True:
        topics = rng.integers(0, N_TOPICS, size=B)
        a, am = sample_sentences(topics)
        p, pm = sample_sentences(topics)  # same topics -> positives
        yield {"anchor": a, "anchor_mask": am, "positive": p,
               "positive_mask": pm}


# the params are drawn from a torch.Generator seeded 0 (Trainer.init_state)
tr = Trainer(arch, TrainerConfig(total_steps=args.steps,
                                 ckpt_dir=args.ckpt_dir,
                                 ckpt_interval=max(50, args.steps // 4),
                                 log_interval=20), device=args.device)
state, hist = tr.fit(data_iter())
print("loss trajectory:")
for step, m in hist:
    print(f"  step {step:>4}: loss={m['loss']:.4f} "
          f"alignment={m.get('alignment', 0):.3f}")
first, last = hist[0][1]["loss"], hist[-1][1]["loss"]
print(f"loss {first:.3f} -> {last:.3f} "
      f"({'improved' if last < first else 'no improvement'})")
