"""ctypes wrapper of the hand-written CUDA ``heavy_hitter`` kernel
(``repro_torch/csrc/heavy_hitter.cu``): the counter's per-arrival update
over one microbatch as one launch of one block; the slots, the sketch, an
empty-slot bitmap and a label -> slot table in shared memory. Not in
place: it writes a new state."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import heavy_hitter as hh
from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv, round_up
from repro_torch.kernels.counts import COUNTS

SLOTS_PER_THREAD = 8   # slots a thread loads, stores and inserts into the table
CHUNK = 256            # arrivals staged a chunk (one thread each)
MAX_THREADS = 512      # leaves warp 0's chain 128 registers a thread
STATIC_SMEM = 1024     # bytes of static shared memory (barriers, warp counts)


@dataclasses.dataclass(frozen=True)
class HeavyHitterPlan:
    threads: int   # one block; a multiple of 32, at least CHUNK
    smem: int      # dynamic bytes, in the kernel's order (see smem_layout)
    table: int     # entries (2 bytes each) of the label -> slot table
    stage: bool    # two Gumbel rows staged in shared memory (RANDOM_EVICT)


def table_size(bmax: int) -> tuple[int, int]:
    """(preferred, least) entries of the label -> slot table: load factor
    0.5, or at most 0.8 where shared memory runs short; multiples of 8 (the
    kernel clears it in 16-byte stores)."""
    return round_up(2 * bmax, 8), round_up(bmax + cdiv(bmax, 4), 8)


def smem_layout(bmax: int, cms_cells: int, table: int, stage: bool) -> dict[str, int]:
    """Byte offset of each array in the kernel's dynamic shared memory (and
    ``end``, the total); every array starts on 16 bytes."""
    sizes = (("labels", 4 * round_up(bmax, 4)), ("counts", 4 * round_up(bmax, 4)),
             ("sketch", 4 * round_up(cms_cells, 4)),
             ("empty_bits", 4 * round_up(cdiv(bmax, 32), 4)),
             ("chunk", 4 * 4 * CHUNK),   # label, uniform, Morris uniform, index + flags
             ("gumbel_rows", 2 * 4 * round_up(bmax, 4) if stage else 0),
             ("table", 2 * table))
    out, at = {}, 0
    for name, size in sizes:
        out[name] = at
        at += size
    out["end"] = at
    return out


def heavy_hitter_plan(bmax: int, cms_cells: int, gumbel: bool = False) -> HeavyHitterPlan:
    """``cms_cells`` is depth * width for COUNT_MIN, else 0; ``gumbel`` for
    RANDOM_EVICT (its rows are staged where they fit beside the preferred
    table). Raises ``ValueError`` where the state and the least table do
    not fit one block's shared memory (bmax past ``MAX_BMAX`` with no
    sketch)."""
    threads = min(MAX_THREADS, max(CHUNK, round_up(cdiv(bmax, SLOTS_PER_THREAD), 32)))
    budget = build.SMEM_PER_BLOCK - STATIC_SMEM
    pref, least = table_size(bmax)
    stage = gumbel and smem_layout(bmax, cms_cells, pref, True)["end"] <= budget
    room = budget - smem_layout(bmax, cms_cells, 0, stage)["end"]
    table = min(pref, room // 16 * 8)
    if table < least:
        raise ValueError(
            f"heavy_hitter kernel holds bmax = {bmax} slots, {cms_cells} sketch cells and "
            f"a table of at least {least} entries in "
            f"{smem_layout(bmax, cms_cells, least, False)['end'] + STATIC_SMEM} B of shared "
            f"memory; a block has {build.SMEM_PER_BLOCK} B (the largest bmax with no "
            f"sketch is {MAX_BMAX})")
    return HeavyHitterPlan(threads=threads,
                           smem=smem_layout(bmax, cms_cells, table, stage)["end"],
                           table=table, stage=stage)


def max_bmax(cms_cells: int = 0) -> int:
    """The largest bmax the plan takes beside ``cms_cells`` sketch cells."""
    lo, hi = 0, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            heavy_hitter_plan(mid, cms_cells)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


MAX_BMAX = 0
MAX_BMAX = max_bmax()


def table_home(label: int, table: int) -> int:
    """The kernel's home entry of a label (>= 0) in a table of ``table``
    entries: the Fibonacci hash, scaled into the table (``table_home`` in
    ``csrc/heavy_hitter.cu``)."""
    return ((label * 0x9E3779B1) & 0xFFFFFFFF) * table >> 32


class HHPtrs(ctypes.Structure):
    """``struct HHPtrs`` of ``csrc/heavy_hitter.cu``, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "labels", "uniforms", "gumbel", "morris",
        "slot_labels", "slot_counts", "cms", "admit_prob", "active_capacity",
        "novel_in_window", "seen_in_window", "total_seen", "total_evictions",
        "total_writes",
        "out_labels", "out_counts", "out_cms", "out_admit_prob",
        "out_active_capacity", "out_novel_in_window", "out_seen_in_window",
        "out_total_seen", "out_total_evictions", "out_total_writes",
        "admitted", "hit", "evicted_label", "slot")]


class HHConf(ctypes.Structure):
    """``struct HHConf`` of ``csrc/heavy_hitter.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "bmax", "policy", "morris_on", "gate_below_capacity", "adaptive",
        "capacity", "cms_depth", "cms_width", "window", "b_step")]
        + [(n, ctypes.c_float) for n in ("u0", "novel_hi", "novel_lo", "u_growth", "u_max")]
        + [(n, ctypes.c_int) for n in ("table", "stage")])


def _fn():
    lib = build.load("heavy_hitter")
    fn = lib.heavy_hitter_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(HHPtrs), ctypes.POINTER(HHConf), build.I, build.L,
                       build.P]
        fn.restype = build.I
    return lib, fn


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"heavy_hitter kernel takes {name} {dtype} {tuple(shape)}, "
                         f"not {t.dtype} {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"heavy_hitter kernel takes {name} on a CUDA device, "
                         f"not {t.device}")


class _Launch:
    """What a call needs that depends only on (config, B, bmax): the plan,
    the kernel's config struct, the inputs' expected (dtype, shape, on a
    card, contiguous) and the output buffer's layout."""

    def __init__(self, cfg: "hh.HHConfig", B: int, bmax: int):
        self.cfg = cfg
        self.random = cfg.policy == hh.Policy.RANDOM_EVICT
        self.cells = cfg.cms_depth * cfg.cms_width if cfg.policy == hh.Policy.COUNT_MIN else 0
        self.plan = heavy_hitter_plan(bmax, self.cells, gumbel=self.random)
        self.conf = HHConf(
            B=B, bmax=bmax, policy=int(cfg.policy), morris_on=int(cfg.morris),
            gate_below_capacity=int(cfg.gate_below_capacity), adaptive=int(cfg.adaptive),
            capacity=cfg.capacity, cms_depth=cfg.cms_depth, cms_width=cfg.cms_width,
            window=cfg.window, b_step=cfg.b_step, u0=cfg.admit_prob, novel_hi=cfg.novel_hi,
            novel_lo=cfg.novel_lo, u_growth=cfg.u_growth, u_max=cfg.u_max,
            table=self.plan.table, stage=int(self.plan.stage))
        self.conf_ref = ctypes.byref(self.conf)
        i32, f32 = torch.int32, torch.float32
        # labels, uniforms, [gumbel], [morris], then the state's ten leaves
        self.expect = ([(i32, (B,)), (f32, (B,))]
                       + ([(f32, (B, bmax))] if self.random else [])
                       + ([(f32, (B,))] if cfg.morris else [])
                       + [(i32, (bmax,)), (i32, (bmax,)),
                          (i32, (cfg.cms_depth, cfg.cms_width)), (f32, ())]
                       + [(i32, ())] * 6)   # B_t, the window's counts, the totals
        self.sig = [(d, s, True, True) for d, s in self.expect]
        # one int32 buffer: labels, counts, the sketch and the scalars (each
        # on 16 bytes, so the kernel stores 16-byte vectors), the evicted
        # labels and the slots; one byte buffer for admitted and hit
        b4, c4 = round_up(bmax, 4), round_up(self.cells, 4)
        self.split = [bmax, b4 - bmax, bmax, b4 - bmax, self.cells, c4 - self.cells,
                      7, 1, B, B]
        self.size = sum(self.split)
        at = [0]
        for n in self.split:
            at.append(at[-1] + 4 * n)
        # byte offsets of the kernel's outputs in the buffer
        self.o_lab, self.o_cnt, self.o_cms, self.o_sc = at[0], at[2], at[4], at[6]
        self.o_ev, self.o_slot = at[8], at[9]


_LAUNCHES: dict[tuple, _Launch] = {}


def _launch_for(cfg, B: int, bmax: int) -> _Launch:
    key = (id(cfg), B, bmax)
    got = _LAUNCHES.get(key)
    if got is None or got.cfg is not cfg:
        if len(_LAUNCHES) >= 64:
            _LAUNCHES.clear()
        got = _LAUNCHES[key] = _Launch(cfg, B, bmax)
    return got


def _refuse(cfg, L: _Launch, ins: list, draws: dict) -> list:
    """The slow path of the checks: name what the kernel does not take, or
    return the inputs made contiguous."""
    if L.random and draws.get("gumbel") is None:
        raise ValueError("RANDOM_EVICT needs draws['gumbel'] [B, bmax]")
    if cfg.morris and draws.get("morris") is None:
        raise ValueError("Morris counting needs draws['morris'] [B]")
    names = (["labels", "uniforms"] + (["gumbel"] if L.random else [])
             + (["morris"] if cfg.morris else [])
             + [f"state.{n}" for n in hh.HHState._fields])
    for t, name, (dtype, shape) in zip(ins, names, L.expect):
        _check(t, name, dtype, shape)
    return [t.contiguous() for t in ins]


def update_batch_cuda(cfg: "hh.HHConfig", state: "hh.HHState", labels: torch.Tensor,
                      draws: dict):
    """Same function as ``ref.update_batch_ref``; every tensor on one CUDA
    device, of the dtypes ``core.heavy_hitter.init`` and ``draw`` make."""
    B = labels.shape[0]
    bmax = state.labels.shape[0]
    L = _launch_for(cfg, B, bmax)
    ins = [labels, draws["uniforms"]]
    if L.random:
        ins.append(draws.get("gumbel"))
    if cfg.morris:
        ins.append(draws.get("morris"))
    ins += state
    if any(t is None for t in ins) or [(t.dtype, t.shape, t.is_cuda, t.is_contiguous())
                                       for t in ins] != L.sig:
        ins = _refuse(cfg, L, ins, draws)
    dev = labels.device
    if B == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return state, {"admitted": empty.bool(), "hit": empty.bool(),
                       "evicted_label": empty, "slot": empty}
    out = torch.empty((L.size,), dtype=torch.int32, device=dev)
    flags = torch.empty((2, B), dtype=torch.bool, device=dev)
    base, fb = out.data_ptr(), flags.data_ptr()
    lab_in, u_in = ins[0], ins[1]
    g_in = ins[2] if L.random else None
    m_in = ins[2 + L.random] if cfg.morris else None
    st = ins[-10:]
    sc = base + L.o_sc
    ptrs = HHPtrs(
        lab_in.data_ptr(), u_in.data_ptr(), build.ptr(g_in), build.ptr(m_in),
        *[t.data_ptr() for t in st],
        base + L.o_lab, base + L.o_cnt, base + L.o_cms if L.cells else None,
        sc, sc + 4, sc + 8, sc + 12, sc + 16, sc + 20, sc + 24,
        fb, fb + B, base + L.o_ev, base + L.o_slot)
    lib, fn = _fn()
    err = fn(ctypes.byref(ptrs), L.conf_ref, L.plan.threads, L.plan.smem,
             build.stream_of(dev))
    build.check(lib, err, "heavy_hitter_launch")
    COUNTS["heavy_hitter"].kernel += 1
    o_lab, _, o_cnt, _, o_cms, _, o_sc, _, o_ev, o_slot = torch.split_with_sizes(out, L.split)
    scalars = o_sc.unbind()
    new_state = hh.HHState(
        o_lab, o_cnt, o_cms.view(cfg.cms_depth, cfg.cms_width) if L.cells else state.cms,
        scalars[0].view(torch.float32), *scalars[1:])
    admitted, hit = flags.unbind()
    return new_state, {"admitted": admitted, "hit": hit, "evicted_label": o_ev,
                       "slot": o_slot}
