"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window (CUDA activity only, so the host pays little for it), its device
operations put on the host's ``time.perf_counter`` clock by a marker
kernel launched at a known host time as the trace stops, and the breakdown the result line
carries: device time by operation, and idle time by the innermost host
span open when the device went idle."""
from __future__ import annotations

import collections
import heapq
import re
import time

import torch

MARK = "spin_kernel"   # torch.cuda._sleep's kernel


class DeviceTrace:
    """The profiler over the window, and the offset of its clock from the
    host's, read from a marker kernel launched at a known host time when
    the trace stops (the activity collection starts late on a cold
    machine, so a marker at the start can go unseen)."""

    def __init__(self):
        self.prof = None
        self.t_mark = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # let the collection come up before the window opens
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.2)

    def stop(self) -> list[tuple[str, float, float]]:
        """[(name, start, end)] of every device operation, in seconds on
        the host's perf_counter clock, sorted by start."""
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                t0, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                t0, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
            raw.append((e.name(), t0, dur))
        marks = [t for n, t, _ in raw if MARK in n]
        if not marks:
            raise RuntimeError("the trace holds no marker kernel")
        off = self.t_mark - max(marks)
        return sorted(((n, t + off, t + off + d) for n, t, d in raw
                       if MARK not in n), key=lambda e: e[1])


def busy_union(events, lo: float, hi: float) -> list[tuple[float, float]]:
    """The device-busy intervals inside [lo, hi], merged."""
    out = []
    for _, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template
    arguments or parameters."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n.split("::")[-1] or name[:64]


def device_ops(events, lo: float, hi: float, top: int = 10):
    by = collections.Counter()
    for n, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by[short_name(n)] += b - a
    return [[n, s] for n, s in by.most_common(top)]


def idle_gaps(busy, spans, lo: float, hi: float, top: int = 10):
    """Idle device time by what the host threads were doing when the gap
    began: the innermost (latest-started) open span of each thread, the
    names joined by "+" ("no span" where none was open). ``spans`` are
    (name, start, end, thread)."""
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    spans = sorted(spans, key=lambda s: s[1])
    active: list = []      # heap of (end, start, name, thread)
    by = collections.Counter()
    i = 0
    for g0, g1 in gaps:
        while i < len(spans) and spans[i][1] <= g0:
            n, s0, s1, tid = spans[i][:4]
            heapq.heappush(active, (s1, s0, n, tid))
            i += 1
        while active and active[0][0] <= g0:
            heapq.heappop(active)
        inner = {}
        for _, s0, n, tid in active:
            if tid not in inner or s0 > inner[tid][0]:
                inner[tid] = (s0, n)
        name = "+".join(sorted(n for _, n in inner.values())) or "no span"
        by[name] += g1 - g0
    return [[n, s] for n, s in by.most_common(top)]
