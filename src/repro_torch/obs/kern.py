"""Per-kernel observability: device time and the kernels a call launches.

Kernels run inside larger serving calls, so they cannot be timed in
production without a device sync — exactly what the query hot path must
never pay. This module profiles kernels **out of band**: ``time_wall``
times warm calls of a zero-argument entry between CUDA events (host
wall clock on the CPU), and ``profile_kernel`` adds the kernels one warm
call queues, by name, as ``torch.profiler`` records them.

Results land in the active metrics registry (``kernel_<name>_wall_us``)
when observability is enabled, so a profiling run exports kernel cost
next to serving metrics in one dump.

``modeled_cost`` is the reference's HLO cost model (modeled HBM bytes and
flops of the compiled program). The port compiles no HLO; its counterpart
waits on the rebuild of ``analysis/hlo_cost.py`` (ROADMAP A10), so it
raises until then.
"""
from __future__ import annotations

import re
import statistics
import time
from typing import Callable

import torch

from repro_torch import obs


def modeled_cost(fn: Callable[[], object]) -> dict:
    raise NotImplementedError(
        "modeled_cost reads XLA HLO cost; the port's counterpart waits on "
        "analysis/hlo_cost.py rebuilt for PyTorch (ROADMAP A10)")


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
                   rounds: int = 3) -> dict:
    """Time per call (``wall_us``) and, on a card, the kernels a call
    launches (``kernels``, ``launches``) for one kernel entry, recorded
    into the active registry (if any) and returned as a plain dict.

    ``fn`` must be a zero-arg callable over device-resident inputs, so
    the timing measures the kernel launches, not host staging."""
    out: dict = {"wall_us": 1e6 * time_wall(fn, reps=reps, rounds=rounds)}
    if _on_card(fn()) is not None:
        out["kernels"] = launched_kernels(fn)
        out["launches"] = len(out["kernels"])
    reg = obs.metrics()
    if reg is not None:
        reg.set_many(f"kernel_{name}_",
                     {k: v for k, v in out.items() if k != "kernels"},
                     help="kernel profile (CUDA-event time, launches)")
    return out
