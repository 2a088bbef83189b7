"""The fused two-stage query (``serve``): Q queries against the ``cap``
prototype rows, then ``nprobe`` rings of ``depth`` slots each, top-k.

Operations: 2 Q (cap + nprobe depth) d. Bytes: both query sets, the
index (rows, valid flags, route labels), the outputs; the routed rings
are left out (they depend on the routes), so this is a lower bound."""
from bench.cost import bound_ms


def work(Q: int, d: int, cap: int, depth: int, nprobe: int, k: int):
    flops = 2.0 * Q * (cap + nprobe * depth) * d
    nbytes = 2 * Q * d * 4 + cap * (d * 4 + 5) + Q * (k * 8 + nprobe * 4)
    return flops, nbytes


def bound(Q: int, d: int, cap: int, depth: int, nprobe: int, k: int) -> float:
    return bound_ms(*work(Q, d, cap, depth, nprobe, k))
