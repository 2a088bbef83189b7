"""Plain reference of the streaming-RAG deployment (paper Algorithm 1 with
the two-stage query), in PyTorch and NumPy, for the benchmark's check.

It imports nothing of the program. From the deployment's file and the
run's inputs (the warmup rows, the batches, the counter's draws, the
queries) it works everything out again:

* (k, B) from the budget by the paper's Table 6 rule;
* the prefilter basis: the warmup's top-n uncentered principal
  directions, sign-aligned;
* the k-means++ start: D^2 sampling under cosine distance with a
  ``torch.Generator`` seeded with the run's seed, the draws taken in the
  order the deployment's initialisation takes them;
* per batch: the screen (mean cosine >= alpha), the nearest centroid
  (ties to the lowest index), the mini-batch k-means fold
  ``mu <- (n mu + sum x) / (n + m)``, the heavy-hitter counter (host, one
  arrival at a time), the freshest member per cluster, the int8 ring
  write (the last ``depth`` stored documents of each cluster, in arrival
  order), and the index rebuilt from the counter's slots every
  ``update_interval`` arrivals;
* the two-stage answer: the top-``nprobe`` prototypes by cosine, then
  the top-``topk`` ring entries of those clusters by the cosine of the
  query with the dequantised row.

``precision`` is "fp32" (full fp32 products, TF32 off) or "tf32": every
product's operands rounded to TF32's 10-bit mantissa first, the control
that a lower precision must fail.

``Replay(forced=...)`` follows the cluster choices and keep decisions of
a system under test where its final store shows them (the program's
served "tokens"), and counts every choice that a near-tie does not
explain (``label_miss``), and apart every choice off by more than a
gross tolerance (``forced_miss``): far past what rounding, or a centroid
moved by an earlier near-tie, leaves in a sound run, and far short of a
wrong label or a wrong keep; elsewhere it decides itself.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np
import torch

EMPTY = -1
INT_MAX = 2**31 - 1


# ----------------------------------------------------------------- deployment
@dataclasses.dataclass(frozen=True)
class Deployment:
    budget_mb: float
    dim: int
    depth: int
    int8: bool
    n_basis: int
    alpha: float
    admit_prob: float
    update_interval: int
    nprobe: int
    topk: int
    k: int
    B: int

    @staticmethod
    def from_file(cfg: dict) -> "Deployment":
        p, s = cfg["pipeline"], cfg["server"]
        dim, depth = int(cfg["dim"]), int(p["store_depth"])
        int8 = p["store_dtype"] == "int8"
        assert p["policy"] == "MIN_EVICT" and p["basis"] == "fixed", p
        k, b = budget_rule(float(cfg["budget_mb"]), dim, depth, int8)
        return Deployment(float(cfg["budget_mb"]), dim, depth, int8,
                          int(p["num_vectors"]), float(p["alpha"]),
                          float(p["admit_prob"]), int(p["update_interval"]),
                          int(s["nprobe"]), int(s["topk"]), k, b)


def budget_rule(budget_mb: float, dim: int, depth: int, int8: bool):
    """(k, B): ~80% of the budget to clusters with their rings, ~20% to
    the index and counters (paper Table 6)."""
    budget = budget_mb * 1e6
    per_proto = dim * 4 * 2 + 24
    per_cluster = per_proto + depth * (dim * (1 if int8 else 4) + 12) + 4
    k = max(16, int(budget * 0.8 / per_cluster))
    b = max(16, min(k, int(budget * 0.2 / per_proto)))
    return k, b


# ------------------------------------------------------------------ arithmetic
def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10-bit mantissa, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Arith:
    def __init__(self, precision: str):
        assert precision in ("fp32", "tf32"), precision
        self.low = precision == "tf32"

    def operand(self, a: torch.Tensor) -> torch.Tensor:
        return tf32(a) if self.low else a

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)


def l2n(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)),
                           min=1e-12)


def pca_basis(ar: Arith, warm: torch.Tensor, n: int) -> torch.Tensor:
    """Top-n uncentered principal directions of the warmup rows [W, d],
    unit rows, each signed so the warmup projects positively on it."""
    W, d = warm.shape
    if W <= d:
        _, vecs = torch.linalg.eigh(ar.mm(warm, warm.T))
        dirs = ar.mm(warm.T, vecs[:, -n:].flip(1))
    else:
        _, vecs = torch.linalg.eigh(ar.mm(warm.T, warm))
        dirs = vecs[:, -n:].flip(1)
    basis = l2n(dirs.T)
    proj = torch.sum(ar.mm(warm, basis.T), dim=0)
    sign = torch.where(proj >= 0, 1.0, -1.0).to(basis.dtype)
    return basis * sign[:, None]


def kmeans_pp(ar: Arith, gen: torch.Generator, data: torch.Tensor,
              k: int) -> torch.Tensor:
    """k-means++ over the unit warmup rows: the first pick uniform, each
    next one D^2-sampled under ``1 - cos`` (uniform once every distance
    is 0). Returns the picked unit rows [k, d]."""
    n = data.shape[0]
    xn = l2n(data)
    xm = ar.operand(xn)
    first = torch.randint(0, n, (1,), generator=gen, device=data.device)
    picks = [xn.index_select(0, first)]
    d2 = 1.0 - xm @ ar.operand(picks[0][0])
    for _ in range(k - 1):
        p = torch.clamp(d2, min=0.0)
        p = torch.where(p.sum() > 0, p, torch.ones_like(p))
        idx = torch.multinomial(p, 1, generator=gen)
        c = xn.index_select(0, idx)
        picks.append(c)
        d2 = torch.minimum(d2, 1.0 - xm @ ar.operand(c[0]))
    return torch.cat(picks, dim=0)


def quantize(v: torch.Tensor):
    """Symmetric int8 per row of unit rows v [m, d]: (q i8, scale f32)."""
    scale = torch.clamp(torch.amax(torch.abs(v), dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def quant_alternatives(v: torch.Tensor, scale: torch.Tensor, q: torch.Tensor,
                       window: float):
    """The other rounding of each element whose ``v / scale`` lies within
    ``window`` of a half-integer (a row normalised in another summation
    order may round it the other way), else the element itself."""
    t = v.to(torch.float64) / scale.to(torch.float64)[:, None]
    frac = t - torch.floor(t)
    amb = torch.abs(frac - 0.5) < window
    other = torch.where(q.to(torch.float64) > t, q.to(torch.float64) - 1,
                        q.to(torch.float64) + 1)
    other = torch.clamp(other, -127, 127)
    return torch.where(amb, other, q.to(torch.float64))


# ------------------------------------------------------------------ the counter
class Counter:
    """The MIN_EVICT heavy-hitter counter over B slots, one arrival at a
    time: a hit bumps its slot; a miss takes the lowest empty slot while
    there is room, else replaces the least-counted slot (lowest on ties)
    when its gate draw is <= u."""

    def __init__(self, B: int, admit_prob: float):
        self.labels = np.full(B, EMPTY, np.int64)
        self.counts = np.zeros(B, np.int64)
        self.slot_of: dict[int, int] = {}
        self.free = list(range(B))        # a heap: lowest empty slot first
        self.u = np.float32(admit_prob)
        self.seen = self.evictions = self.writes = 0

    def arrive(self, label: int, uniform: np.float32) -> bool:
        """One valid arrival; True when it was counted (hit or admitted)."""
        self.seen += 1
        s = self.slot_of.get(label)
        if s is not None:
            self.counts[s] += 1
            self.writes += 1
            return True
        if self.free:
            s = heapq.heappop(self.free)
        elif uniform <= self.u:
            occ = np.where(self.labels != EMPTY, self.counts, INT_MAX)
            s = int(np.argmin(occ))
            del self.slot_of[int(self.labels[s])]
            self.evictions += 1
        else:
            return False
        self.labels[s] = label
        self.counts[s] = 1
        self.slot_of[label] = s
        self.writes += 1
        return True


# ------------------------------------------------------------------- the state
class Replay:
    """The reference state, advanced one batch at a time.

    ``forced`` [N] is the cluster of each document id in a system's final
    store (-1 where the store does not show the document): shown
    documents take the system's keep and cluster, and each such choice is
    judged by the near-tie rule; the rest are decided here."""

    def __init__(self, dep: Deployment, warm: torch.Tensor, seed: int,
                 precision: str = "fp32", forced=None,
                 label_tol: float = 1e-5, keep_tol: float = 1e-5,
                 gross_tol: float = 1e-3):
        self.dep, self.ar = dep, Arith(precision)
        dev = warm.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.centroids = kmeans_pp(self.ar, gen, warm, dep.k)
        self.counts = torch.zeros(dep.k, dtype=torch.float32, device=dev)
        self.basis_n = l2n(pca_basis(self.ar, warm, dep.n_basis))
        self.counter = Counter(dep.B, dep.admit_prob)
        self.rep_ids = np.full(dep.k, -1, np.int64)
        self.rings: dict[int, collections.deque] = {}
        self.ptr = np.zeros(dep.k, np.int64)
        self.arrivals = self.kept = self.since = self.upserts = 0
        self.index_slots = np.zeros(0, np.int64)      # valid slots, ascending
        self.index_labels = np.zeros(0, np.int64)
        self.index_ids = np.zeros(0, np.int64)
        self.index_vecs = torch.zeros((0, dep.dim), dtype=torch.float32,
                                      device=dev)
        self.forced = forced
        self.label_tol, self.keep_tol = label_tol, keep_tol
        self.gross_tol = gross_tol
        self.label_miss = self.forced_miss = 0
        self.worst_label_gap = self.worst_keep_gap = 0.0
        self.device = dev

    # ............................................................ ingest
    def ingest(self, x: np.ndarray, ids: np.ndarray, uniforms: np.ndarray):
        dep, ar = self.dep, self.ar
        xd = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        xn = l2n(xd)
        r = torch.mean(ar.mm(xn, self.basis_n.T), dim=1)
        sims = ar.mm(xn, l2n(self.centroids).T)
        best, _ = torch.max(sims, dim=1)
        own = torch.argmax((sims == best[:, None]).to(torch.int32), dim=1)
        keep = (r >= dep.alpha).cpu().numpy()
        labels = own.cpu().numpy().astype(np.int64)
        if self.forced is not None:
            f_label = self.forced
            shown = f_label[ids] >= 0
            if shown.any():
                rows = np.nonzero(shown)[0]
                fl = f_label[ids[rows]]
                at = torch.as_tensor(rows, device=self.device)
                got = sims[at, torch.as_tensor(fl, device=self.device)]
                gap = (best[at] - got).cpu().numpy()
                below = dep.alpha - r[at].cpu().numpy()
                miss = (gap > self.label_tol) | (below > self.keep_tol)
                self.label_miss += int(miss.sum())
                self.forced_miss += int(np.sum((gap > self.gross_tol)
                                               | (below > self.gross_tol)))
                self.worst_label_gap = max(self.worst_label_gap,
                                           float(gap.max()))
                self.worst_keep_gap = max(self.worst_keep_gap,
                                          float(below.max()))
                labels[rows] = fl
                keep[rows] = True
        self._fold(xd, labels, keep)
        stamps = self.arrivals + np.arange(ids.shape[0])
        for i in np.nonzero(keep)[0]:
            lbl = int(labels[i])
            self.kept += 1
            if ids[i] > self.rep_ids[lbl]:
                self.rep_ids[lbl] = ids[i]
            if self.counter.arrive(lbl, uniforms[i]):
                ring = self.rings.get(lbl)
                if ring is None:
                    ring = self.rings[lbl] = collections.deque(maxlen=dep.depth)
                ring.append((int(ids[i]), int(stamps[i]), int(self.ptr[lbl])))
                self.ptr[lbl] += 1
        self.arrivals += ids.shape[0]
        self.since += ids.shape[0]
        if self.since >= dep.update_interval:
            self._upsert()
            self.since = 0
            self.upserts += 1

    def _fold(self, xd, labels, keep):
        """Mini-batch k-means: mu <- (n mu + sum x) / (n + m) over the kept
        rows of each cluster; the sums as one fp32 product."""
        k = self.dep.k
        lab = torch.as_tensor(np.where(keep, labels, k), device=self.device)
        onehot = (torch.arange(k, device=self.device)[:, None]
                  == lab[None, :]).to(torch.float32)
        sums = self.ar.mm(onehot, xd)
        cnts = onehot.sum(dim=1)
        denom = self.counts + cnts
        self.centroids = torch.where(
            (cnts > 0)[:, None],
            (self.centroids * self.counts[:, None] + sums)
            / torch.clamp(denom, min=1.0)[:, None],
            self.centroids)
        self.counts = denom

    def _upsert(self):
        lbl = self.counter.labels
        slots = np.nonzero(lbl != EMPTY)[0]
        self.index_slots = slots
        self.index_labels = lbl[slots].copy()
        self.index_ids = self.rep_ids[self.index_labels]
        at = torch.as_tensor(self.index_labels, device=self.device)
        self.index_vecs = l2n(self.centroids[at])

    # ............................................................. query
    def ring_entries(self, cluster: int):
        """[(doc id, stamp, slot)] live in the cluster's ring now."""
        ring = self.rings.get(cluster, ())
        return [(d, s, p % self.dep.depth) for d, s, p in ring]

    def routes(self, qn64: torch.Tensor):
        """Prototype scores of unit queries [m, d] (f64) against the valid
        index rows: (scores [m, nv] f64, labels [nv])."""
        vecs = self.index_vecs.to(torch.float64)
        return qn64 @ vecs.T, self.index_labels

    def answer(self, q: np.ndarray, X: np.ndarray):
        """The system's own two-stage answer (used where the reference is
        put in the program's place): (scores [m, k] f32, ids, clusters)."""
        dep, ar = self.dep, self.ar
        qd = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        qn = l2n(qd)
        m, K = q.shape[0], dep.topk
        scores = np.full((m, K), -np.inf, np.float32)
        out_ids = np.full((m, K), -1, np.int32)
        out_cl = np.full((m, K), -1, np.int32)
        nv = self.index_vecs.shape[0]
        if nv == 0:
            return scores, out_ids, out_cl
        ps = ar.mm(qn, self.index_vecs.T)
        order = torch.sort(ps, dim=1, descending=True, stable=True)[1]
        order = order[:, :dep.nprobe].cpu().numpy()
        for i in range(m):
            cand = []
            for j, slot_idx in enumerate(order[i]):
                c = int(self.index_labels[slot_idx])
                for d, _, slot in self.ring_entries(c):
                    cand.append((j * dep.depth + slot, d, c))
            if not cand:
                continue
            cand.sort()
            docs = np.asarray([c[1] for c in cand])
            v = l2n(torch.as_tensor(X[docs], device=self.device))
            qv, sc = quantize(v)
            rows = qv.to(torch.float32) * sc[:, None]
            s = ar.mm(rows, qn[i]).cpu().numpy()
            top = np.argsort(-s, kind="stable")[:K]
            scores[i, :top.size] = s[top]
            out_ids[i, :top.size] = docs[top]
            out_cl[i, :top.size] = [cand[t][2] for t in top]
        return scores, out_ids, out_cl

    # ............................................................ output
    def final_state(self, X: np.ndarray) -> dict:
        """The state in the form the check reads from a system: the live
        ring entries (cluster, slot, doc, stamp, int8 row, scale), the
        write counters, the index and the pipeline counters."""
        ents = [(c, slot, d, s) for c in sorted(self.rings)
                for d, s, slot in self.ring_entries(c)]
        ent = np.asarray(ents, np.int64).reshape(-1, 4)
        if ent.shape[0]:
            v = l2n(torch.as_tensor(X[ent[:, 2]], device=self.device))
            q, sc = quantize(v)
            rows, scales = q.cpu().numpy(), sc.cpu().numpy()
        else:
            rows = np.zeros((0, self.dep.dim), np.int8)
            scales = np.zeros(0, np.float32)
        return {
            "entries": ent, "rows": rows, "scales": scales,
            "ptr": self.ptr.copy(),
            "index_slots": self.index_slots.copy(),
            "index_labels": self.index_labels.copy(),
            "index_ids": self.index_ids.copy(),
            "index_vecs": self.index_vecs.cpu().numpy(),
            "counters": self.counters(),
        }

    def counters(self) -> dict:
        c = self.counter
        occ = c.labels != EMPTY
        live = sum(len(r) for r in self.rings.values())
        return {"arrivals": self.arrivals, "admitted": self.kept,
                "hh_seen": c.seen, "hh_evictions": c.evictions,
                "hh_writes": c.writes, "hh_occupied": int(occ.sum()),
                "hh_max_count": int(c.counts[occ].max()) if occ.any() else 0,
                "store_live": live, "index_valid": int(self.index_slots.size),
                "upserts": self.upserts}


COUNTER_KEYS = ("arrivals", "admitted", "hh_seen", "hh_evictions",
                "hh_writes", "hh_occupied", "hh_max_count", "store_live",
                "index_valid", "upserts")
