"""Per-kernel observability: device time, the kernels a call launches,
and its modeled cost.

Kernels run inside larger serving calls, so they cannot be timed in
production without a device sync — exactly what the query hot path must
never pay. This module profiles kernels **out of band**: ``time_wall``
times warm calls of a zero-argument entry between CUDA events (host
wall clock on the CPU), and ``profile_kernel`` adds the kernels one warm
call queues, by name, as ``torch.profiler`` records them.

Results land in the active metrics registry (``kernel_<name>_wall_us``,
``kernel_<name>_modeled_hbm_bytes``, ...) when observability is enabled, so a profiling run exports kernel cost
next to serving metrics in one dump.

``modeled_cost`` is the reference's cost model of a call: modeled HBM
bytes, flops and collective bytes, counted op by op on PyTorch's
dispatch by ``analysis/hlo_cost.py`` (the port compiles no HLO); a kernel
entry inside the call counts as its model (``kernels/cost.py``).
"""
from __future__ import annotations

import re
import statistics
import time
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.analysis import hlo_cost


def modeled_cost(fn: Callable[[], object]) -> dict:
    """Run ``fn`` (a zero-arg callable closed over its example inputs)
    once under ``hlo_cost``'s counter: modeled HBM bytes, flops, and
    collective traffic."""
    cost = hlo_cost.analyze(fn)
    return {
        "modeled_hbm_bytes": float(cost["bytes"]),
        "modeled_flops": float(cost["flops"]),
        "modeled_collective_bytes": float(cost["collective_bytes"]),
    }


def _on_card(out) -> torch.device | None:
    """The CUDA device of the first tensor in ``out`` (a tensor or a
    nested tuple/list/dict of them), else None."""
    if torch.is_tensor(out):
        return out.device if out.device.type == "cuda" else None
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (tuple, list)) else ()
    for o in items:
        dev = _on_card(o)
        if dev is not None:
            return dev
    return None


def time_wall(fn: Callable[[], object], *, reps: int = 50,
              rounds: int = 3) -> float:
    """Median-of-rounds seconds per call of warm ``fn``: between CUDA
    events when it returns tensors on a card (device time of the stream
    it queued on), else on the host's clock."""
    dev = _on_card(fn())
    times = []
    if dev is not None:
        torch.cuda.synchronize(dev)
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3 / reps)
    else:
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) / reps)
    return float(statistics.median(times))


def launched_kernels(fn: Callable[[], object]) -> list[str]:
    """The CUDA kernels one warm call of ``fn`` queues, by their own
    identifiers (without scope or arguments), as torch.profiler records
    them; empty where the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]

    def short(name):
        ids = [i for i in re.findall(r"([A-Za-z_]\w*)(?:<[^()]*>)?\(", name)
               if i != "void"]
        return ids[0] if ids else name[:40]

    return [short(n) for n in names]


def profile_kernel(name: str, fn: Callable[[], object], *, reps: int = 50,
                   rounds: int = 3, time_it: bool = True) -> dict:
    """Modeled cost (``modeled_cost``), time per call (``wall_us``, when
    ``time_it``) and, on a card, the kernels a call launches
    (``kernels``, ``launches``) for one kernel entry, recorded into the
    active registry (if any) and returned as a plain dict.

    ``fn`` must be a zero-arg callable over device-resident inputs, so
    the timing measures the kernel launches, not host staging."""
    out: dict = modeled_cost(fn)
    if time_it:
        out["wall_us"] = 1e6 * time_wall(fn, reps=reps, rounds=rounds)
    if _on_card(fn()) is not None:
        out["kernels"] = launched_kernels(fn)
        out["launches"] = len(out["kernels"])
    reg = obs.metrics()
    if reg is not None:
        reg.set_many(f"kernel_{name}_",
                     {k: v for k, v in out.items() if k != "kernels"},
                     help="kernel profile (modeled cost, CUDA-event time, launches)")
    return out
