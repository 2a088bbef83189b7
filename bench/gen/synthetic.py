"""The paper's controlled-load stream (``synthetic``), frozen for the
benchmark and drawn on the device from the run's seed.

The law is the topic-mixture process of the program's
``data/streams.py::TopicStream`` with the ``synthetic`` feed's
parameters, which the traffic file states (64 topics, Zipf 1.0 over
them, intra-topic noise 0.25, the SBERT-like shared corpus direction,
no drift, no bursts, no background, Poisson batch sizes, the topics
drawn from the feed's own seed 2):

    corpus = unit(N(0, I_d))
    mean_t = unit(N(0, I_d) + anisotropy * sqrt(d) * corpus)
    w      = shuffled 1 / rank^zipf_s, normalised
    doc    = unit(mean_t * (1 - noise) + noise * unit(N(0, I_d))),  t ~ w
    query  = unit(mean_t * (1 - noise/2) + noise/2 * unit(N(0, I_d))), t ~ w
    batch  = max(1, Poisson(mean_batch)) documents

With no drift the topic means never move, so a query pool made at
set-up stays current for the whole run. Everything comes from one
``torch.Generator`` on the device, in a few large calls.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 18   # rows drawn per call (bounds the device scratch)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class Synthetic:
    """The feed's topics (means and popularity) come from its own
    ``topic_seed``, so every run serves the same feed; the run's seed
    draws the documents, queries, batch sizes and counter draws."""

    def __init__(self, params: dict, dim: int, seed: int, device):
        self.p = params
        self.dim = dim
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(params["topic_seed"]))
        T = int(params["n_topics"])
        corpus = _unit(self._normal((dim,)))
        m = (self._normal((T, dim))
             + float(params["anisotropy"]) * dim ** 0.5 * corpus)
        self.means = _unit(m)
        w = 1.0 / torch.arange(1, T + 1, dtype=torch.float64,
                               device=self.device) ** max(
            float(params["zipf_s"]), 1e-3)
        w = w[torch.randperm(T, generator=self.gen, device=self.device)]
        self.weights = (w / w.sum()).to(torch.float32)
        self.gen.manual_seed(int(seed))

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def _rows(self, n: int, noise: float) -> torch.Tensor:
        t = torch.multinomial(self.weights, n, replacement=True,
                              generator=self.gen)
        eps = _unit(self._normal((n, self.dim)))
        return _unit(self.means[t] * (1.0 - noise) + noise * eps)

    def docs_into(self, out: np.ndarray, rows: int = CHUNK) -> None:
        """Fill the host array ``out`` [n, d] f32 with documents, ``rows``
        at a time (which bounds the device scratch of one call)."""
        noise = float(self.p["noise"])
        for lo in range(0, out.shape[0], rows):
            hi = min(out.shape[0], lo + rows)
            out[lo:hi] = self._rows(hi - lo, noise).cpu().numpy()

    def docs(self, n: int) -> torch.Tensor:
        """[n, d] f32 documents on the device."""
        return self._rows(n, float(self.p["noise"]))

    def queries(self, n: int) -> np.ndarray:
        """[n, d] f32 host query vectors from the current topics."""
        return self._rows(n, 0.5 * float(self.p["noise"])).cpu().numpy()

    def batch_sizes(self, n: int, mean: float) -> np.ndarray:
        lam = torch.full((n,), float(mean), dtype=torch.float32,
                         device=self.device)
        sizes = torch.poisson(lam, generator=self.gen).to(torch.int64)
        return np.maximum(sizes.cpu().numpy(), 1)

    def uniforms(self, n: int) -> torch.Tensor:
        """[n] f32 draws for the heavy-hitter counter, on the device."""
        return torch.rand((n,), generator=self.gen, device=self.device)

    def host_rng(self) -> np.random.Generator:
        """A host generator for schedules, seeded from this stream."""
        s = torch.randint(0, 2**62, (2,), generator=self.gen,
                          device=self.device).cpu().tolist()
        return np.random.default_rng(s)
