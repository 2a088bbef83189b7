"""serve_roofline (%, device trace): the frozen bound of each ``serve``
call (bench/cost/serve.py, at its flush's query count) over the device
time of the kernel's launches (route tiles, selection, merge passes,
rerank), summed over the window's flushes."""
from bench.metrics._kernels import time_in_spans

NAMES = ("route_tile_kernel", "route_select_kernel", "route_merge_kernel",
         "serve_rerank_kernel")


def read(rec):
    from bench.cost import serve

    if rec.get("device_events") is None or rec.get("q") is None:
        return None
    t0, t1 = rec["window"]
    fl = [(a, b, n) for a, b, n in rec["flushes"] if a >= t0 and b <= t1]
    dev, hit = time_in_spans(rec["device_events"], NAMES,
                                [(a, b) for a, b, _ in fl])
    if not hit or dev <= 0:
        return None
    dep = rec["dep"]
    ms = sum(serve.bound(n, dep.dim, dep.B, dep.depth, dep.nprobe, dep.topk)
             for _, _, n in fl)
    return 100.0 * ms * 1e-3 / dev
