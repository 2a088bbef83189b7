"""The check that decides ``correct``: a system's outputs against the plain
reference (``pipeline.Replay``), after the window.

Inputs are what the benchmark made (the warmup, every document by id,
the counter's draws, the batch bounds, the queries) and what the system
produced: a sample of its answers, each with the snapshot version it was
served from, and its final state as the last published snapshot shows
it (the live ring entries with their int8 rows and scales, the write
counters, the valid index rows) with its pipeline counters.

The reference replays every batch, following the system's cluster and
keep choices where the final store shows them and judging each by the
near-tie rule. At each published version it judges the answers served
from it. The numbers (each beside its limit in the run's last lines):

* ``label_miss``: documents whose shown cluster scores more than
  ``LABEL_TOL`` below the reference's nearest centroid, or whose screen
  score lies more than ``KEEP_TOL`` below alpha (a count);
* ``forced_miss``: the same documents counted where the shown choice is
  off by more than ``GROSS_TOL``, in cluster score or below alpha: a
  near-tie early in the stream can move a young centroid and leave later
  choices off by ~1e-4 in a sound run, a wrong label or keep by ~0.1;
* ``state_diff``: entries of the final state that differ: ring members
  (cluster, document) on one side only, a member's slot or stamp, write
  counters, int8 rows off by more than one step where no half-integer
  explains it or scales off by more than ``SCALE_RTOL``, index slots
  (valid, label, document id, a vector off by more than ``VEC_TOL``),
  and the pipeline counters' absolute differences (a count);
* ``score_err``: the largest distance of a served score from the
  cosine of the query with that document's int8 row, over the roundings
  a half-integer leaves open; infinite where a served document is not in
  the ring of the cluster it names at that version, is named twice, or
  lies in a cluster no route can reach;
* ``answer_gap``: the largest amount by which the reference's r-th best
  score, over the clusters the answer may have been routed through (the
  top ``nprobe`` prototypes, near-ties within ``ROUTE_TOL`` either
  way), lies above the served r-th score.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from bench.reference.pipeline import (COUNTER_KEYS, Deployment, Replay, l2n,
                                      quant_alternatives, quantize)

LABEL_TOL = 1e-5    # the near-tie rule: a pick within this of the best
KEEP_TOL = 1e-5
GROSS_TOL = 1e-3    # a shown choice off by more than this is wrong
ROUTE_TOL = 1e-5
VEC_TOL = 1e-6
SCALE_RTOL = 1e-5
HALF_WINDOW = 1e-3  # |v/scale - (n + 1/2)| under this may round either way


def _score_bounds(dev, qn64: torch.Tensor, X: np.ndarray, docs: np.ndarray):
    """[lo, hi] of the cosine of unit query qn64 [d] (f64) with each
    document's int8 row, over the open roundings."""
    v = l2n(torch.as_tensor(X[docs], device=dev))
    q, sc = quantize(v)
    alt = quant_alternatives(v, sc, q, HALF_WINDOW)
    a = q.to(torch.float64) * qn64
    b = alt * qn64
    s = sc.to(torch.float64)
    lo = s * torch.minimum(a, b).sum(dim=1)
    hi = s * torch.maximum(a, b).sum(dim=1)
    return lo.cpu().numpy(), hi.cpu().numpy()


def judge_answer(rep: Replay, X: np.ndarray, q: np.ndarray, ids: np.ndarray,
                 scores: np.ndarray, clusters: np.ndarray):
    """(score_err, answer_gap) of one served answer at the replay's
    current state."""
    dep, dev = rep.dep, rep.device
    q64 = torch.as_tensor(q, dtype=torch.float64, device=dev)
    qn64 = q64 / torch.clamp(torch.linalg.vector_norm(q64), min=1e-12)
    ps, labels = rep.routes(qn64[None])
    ps = ps[0].cpu().numpy()
    if ps.size > dep.nprobe:
        t = np.sort(ps)[::-1][dep.nprobe - 1]
        required = set(labels[ps > t + ROUTE_TOL].tolist())
        optional = set(labels[np.abs(ps - t) <= ROUTE_TOL].tolist())
    else:
        required, optional = set(labels.tolist()), set()
    live = ids >= 0
    served = [int(c) for c in clusters[live]]
    if (len(set(ids[live].tolist())) != int(live.sum())
            or any(c not in required and c not in optional for c in served)
            or not np.all(np.diff(scores[live]) <= 0)
            or (live.any() and not live[:int(live.sum())].all())):
        return float("inf"), float("inf")
    used = required | (set(served) & optional)
    if len(used) > dep.nprobe:
        return float("inf"), float("inf")
    cand = []
    for c in sorted(used):
        cand += [(d, c) for d, _, _ in rep.ring_entries(c)]
    members = set(cand)
    for d, c in zip(ids[live].tolist(), served):
        if (d, c) not in members:
            return float("inf"), float("inf")
    if not cand:
        return 0.0, 0.0
    docs = np.asarray([d for d, _ in cand], np.int64)
    lo, hi = _score_bounds(dev, qn64, X, docs)
    at = {d: i for i, d in enumerate(docs.tolist())}
    err = 0.0
    for d, s in zip(ids[live].tolist(), scores[live].tolist()):
        i = at[d]
        err = max(err, lo[i] - s, s - hi[i])
    ref = np.sort(lo)[::-1][:dep.topk]
    got = np.where(live, scores.astype(np.float64), -np.inf)[:ref.size]
    gap = float(np.max(ref - got)) if ref.size else 0.0
    return max(err, 0.0), max(gap, 0.0)


def compare_state(sys_st: dict, ref_st: dict, X: np.ndarray) -> dict:
    """(counts of what differs between two final states, their sum is
    ``state_diff`` (see the module docstring); the first rows that
    differ, for the log)."""
    out = {}
    seen = []
    se, re_ = sys_st["entries"], ref_st["entries"]
    s_mem = {(int(c), int(d)): (int(sl), int(st), i)
             for i, (c, sl, d, st) in enumerate(se)}
    r_mem = {(int(c), int(d)): (int(sl), int(st), i)
             for i, (c, sl, d, st) in enumerate(re_)}
    out["ring_members"] = len(set(s_mem) ^ set(r_mem))
    both = set(s_mem) & set(r_mem)
    out["ring_slots"] = sum(s_mem[m][:2] != r_mem[m][:2] for m in both)
    out["ring_ptr"] = int(np.sum(sys_st["ptr"] != ref_st["ptr"]))
    bad_rows = 0
    if both:
        si = np.asarray([s_mem[m][2] for m in sorted(both)])
        ri = np.asarray([r_mem[m][2] for m in sorted(both)])
        s_rows = sys_st["rows"][si].astype(np.int64)
        r_rows = ref_st["rows"][ri].astype(np.int64)
        s_sc = sys_st["scales"][si].astype(np.float64)
        r_sc = ref_st["scales"][ri].astype(np.float64)
        # the other rounding open at half-integers of v / scale
        t = (r_rows * 0).astype(np.float64)
        diff = np.abs(s_rows - r_rows)
        off = diff > 0
        if off.any():
            docs = np.asarray([m[1] for m in sorted(both)])
            rows_at = np.nonzero(off.any(axis=1))[0]
            v = l2n(torch.as_tensor(X[docs[rows_at]]))
            q, sc = quantize(v)
            alt = quant_alternatives(v, sc, q, HALF_WINDOW).numpy()
            t[rows_at] = alt
            # the host's own rounding may be either one too
            t2 = r_rows.astype(np.float64).copy()
            t2[rows_at] = q.numpy()
            ok = (diff <= 1) & ((~off) | (s_rows == t) | (s_rows == t2))
        else:
            ok = np.ones_like(off)
        bad = ~ok.all(axis=1) | (np.abs(s_sc - r_sc) > SCALE_RTOL * r_sc)
        bad_rows = int(bad.sum())
        docs = [m[1] for m in sorted(both)]
        for i in np.nonzero(bad)[0][:3]:
            cols = np.nonzero(~ok[i])[0][:4]
            v = l2n(torch.as_tensor(X[docs[i]][None]))[0].double()
            sc = float(r_sc[i])
            seen.append({"doc": int(docs[i]), "cols": cols.tolist(),
                         "sys": s_rows[i, cols].tolist(),
                         "ref": r_rows[i, cols].tolist(),
                         "v_over_scale": (v[cols] / sc).tolist(),
                         "scale_sys": float(s_sc[i]), "scale_ref": sc})
    out["rows"] = bad_rows
    s_slots = dict(zip(sys_st["index_slots"].tolist(),
                       range(len(sys_st["index_slots"]))))
    r_slots = dict(zip(ref_st["index_slots"].tolist(),
                       range(len(ref_st["index_slots"]))))
    out["index_slots"] = len(set(s_slots) ^ set(r_slots))
    common = sorted(set(s_slots) & set(r_slots))
    si = np.asarray([s_slots[s] for s in common], np.int64)
    ri = np.asarray([r_slots[s] for s in common], np.int64)
    if common:
        vd = np.abs(sys_st["index_vecs"][si].astype(np.float64)
                    - ref_st["index_vecs"][ri].astype(np.float64)).max(axis=1)
        out["index_rows"] = int(np.sum(
            (sys_st["index_labels"][si] != ref_st["index_labels"][ri])
            | (sys_st["index_ids"][si] != ref_st["index_ids"][ri])
            | (vd > VEC_TOL)))
    else:
        out["index_rows"] = 0
    out["counters"] = int(sum(abs(int(sys_st["counters"][k])
                                  - int(ref_st["counters"][k]))
                              for k in COUNTER_KEYS))
    return out, seen


def judge(dep: Deployment, warm: torch.Tensor, seed: int, X: np.ndarray,
          U: np.ndarray, bounds: np.ndarray, pub_batches: list[int],
          answers: list[dict], sys_state: dict,
          precision: str = "fp32") -> tuple[dict, dict]:
    """(numbers, detail). ``bounds`` [nb + 1] are the batches' row bounds
    (document id = row of X); ``pub_batches[v]`` the batches applied when
    version v was published; ``answers`` the sampled answers, each
    {"q", "ids", "scores", "clusters", "version"}."""
    N = X.shape[0]
    forced = np.full(N, -1, np.int64)
    ent = sys_state["entries"]
    if ent.shape[0]:
        docs = ent[:, 2]
        if docs.min() < 0 or docs.max() >= N:
            return ({"label_miss": float("inf"), "forced_miss": float("inf"),
                     "state_diff": float("inf")},
                    {"bad": "a stored document id was never ingested"})
        forced[docs] = ent[:, 0]
    rep = Replay(dep, warm, seed, precision, forced=forced,
                 label_tol=LABEL_TOL, keep_tol=KEEP_TOL, gross_tol=GROSS_TOL)
    by_batch = collections.defaultdict(list)
    for v, b in enumerate(pub_batches):
        by_batch[b].append(v)
    by_version = collections.defaultdict(list)
    for a in answers:
        by_version[int(a["version"])].append(a)
    unknown = set(by_version) - set(range(len(pub_batches)))
    score_err = answer_gap = float("inf") if unknown else 0.0
    judged = 0
    nb = bounds.shape[0] - 1
    for b in range(nb + 1):
        if b > 0:
            lo, hi = int(bounds[b - 1]), int(bounds[b])
            rep.ingest(X[lo:hi], np.arange(lo, hi), U[lo:hi])
        for v in by_batch.get(b, ()):
            for a in by_version.get(v, ()):
                e, g = judge_answer(rep, X, a["q"], a["ids"], a["scores"],
                                    a["clusters"])
                score_err, answer_gap = max(score_err, e), max(answer_gap, g)
                judged += 1
    ref_state = rep.final_state(X)
    diff, bad_rows = compare_state(sys_state, ref_state, X)
    numbers = {"label_miss": rep.label_miss, "forced_miss": rep.forced_miss,
               "state_diff": sum(diff.values())}
    if answers:
        numbers["score_err"] = score_err
        numbers["answer_gap"] = answer_gap
    detail = {"diff": diff, "judged": judged, "bad_rows": bad_rows,
              "worst_label_gap": rep.worst_label_gap,
              "worst_keep_gap": rep.worst_keep_gap,
              "ref_counters": ref_state["counters"],
              "sys_counters": {k: int(sys_state["counters"][k])
                               for k in COUNTER_KEYS}}
    return numbers, detail
