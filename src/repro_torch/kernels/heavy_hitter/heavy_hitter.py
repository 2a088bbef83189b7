"""ctypes wrapper of the hand-written CUDA ``heavy_hitter`` kernel
(``repro_torch/csrc/heavy_hitter.cu``): the counter's per-arrival update
over one microbatch as one launch of one block, the slots (and the
Count-Min sketch) in shared memory. Not in place: it writes a new state."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import heavy_hitter as hh
from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv, round_up
from repro_torch.kernels.counts import COUNTS

SLOTS_PER_THREAD = 8   # slots a thread scans per arrival (at the largest block)
MAX_THREADS = 1024
STATIC_SMEM = 1024     # bytes of static shared memory (the warps' partials)


@dataclasses.dataclass(frozen=True)
class HeavyHitterPlan:
    threads: int   # one block; a multiple of 32
    smem: int      # dynamic bytes: labels and counts, the sketch, a chunk


def heavy_hitter_plan(bmax: int, cms_cells: int) -> HeavyHitterPlan:
    """``cms_cells`` is depth * width for COUNT_MIN, else 0. Raises
    ``ValueError`` where the state does not fit one block's shared
    memory."""
    threads = min(MAX_THREADS, max(32, round_up(cdiv(bmax, SLOTS_PER_THREAD), 32)))
    # labels + counts, the sketch, and a chunk of `threads` staged arrivals
    # (label, gate uniform, Morris uniform)
    smem = 4 * (2 * bmax + cms_cells + 3 * threads)
    if smem + STATIC_SMEM > build.SMEM_PER_BLOCK:
        raise ValueError(f"heavy_hitter kernel holds bmax = {bmax} slots and "
                         f"{cms_cells} sketch cells in {smem + STATIC_SMEM} B of "
                         f"shared memory; a block has {build.SMEM_PER_BLOCK} B")
    return HeavyHitterPlan(threads=threads, smem=smem)


class HHArgs(ctypes.Structure):
    """``struct HHArgs`` of ``csrc/heavy_hitter.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "labels", "uniforms", "gumbel", "morris",
        "slot_labels", "slot_counts", "cms", "admit_prob", "active_capacity",
        "novel_in_window", "seen_in_window", "total_seen", "total_evictions",
        "total_writes",
        "out_labels", "out_counts", "out_cms", "out_admit_prob",
        "out_active_capacity", "out_novel_in_window", "out_seen_in_window",
        "out_total_seen", "out_total_evictions", "out_total_writes",
        "admitted", "hit", "evicted_label", "slot")]
        + [(n, ctypes.c_int) for n in (
            "B", "bmax", "policy", "morris_on", "gate_below_capacity", "adaptive",
            "capacity", "cms_depth", "cms_width", "window", "b_step")]
        + [(n, ctypes.c_float) for n in (
            "u0", "novel_hi", "novel_lo", "u_growth", "u_max")])


_SCALARS = ("active_capacity", "novel_in_window", "seen_in_window", "total_seen",
            "total_evictions", "total_writes")


def _fn():
    lib = build.load("heavy_hitter")
    fn = lib.heavy_hitter_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(HHArgs), build.I, build.L, build.P]
        fn.restype = build.I
    return lib, fn


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"heavy_hitter kernel takes {name} {dtype} {tuple(shape)}, "
                         f"not {t.dtype} {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"heavy_hitter kernel takes {name} on a CUDA device, "
                         f"not {t.device}")


def update_batch_cuda(cfg: "hh.HHConfig", state: "hh.HHState", labels: torch.Tensor,
                      draws: dict):
    """Same function as ``ref.update_batch_ref``; every tensor on one CUDA
    device, of the dtypes ``core.heavy_hitter.init`` and ``draw`` make."""
    B = labels.shape[0]
    bmax = state.labels.shape[0]
    cells = cfg.cms_depth * cfg.cms_width if cfg.policy == hh.Policy.COUNT_MIN else 0
    plan = heavy_hitter_plan(bmax, cells)
    _check(labels, "labels", torch.int32, (B,))
    _check(state.labels, "state.labels", torch.int32, (bmax,))
    _check(state.counts, "state.counts", torch.int32, (bmax,))
    _check(state.cms, "state.cms", torch.int32, (cfg.cms_depth, cfg.cms_width))
    _check(state.admit_prob, "state.admit_prob", torch.float32, ())
    for name in _SCALARS:
        _check(getattr(state, name), f"state.{name}", torch.int32, ())
    _check(draws["uniforms"], "uniforms", torch.float32, (B,))
    gumbel = draws.get("gumbel") if cfg.policy == hh.Policy.RANDOM_EVICT else None
    morris = draws.get("morris") if cfg.morris else None
    if cfg.policy == hh.Policy.RANDOM_EVICT:
        if gumbel is None:
            raise ValueError("RANDOM_EVICT needs draws['gumbel'] [B, bmax]")
        _check(gumbel, "gumbel", torch.float32, (B, bmax))
    if cfg.morris:
        if morris is None:
            raise ValueError("Morris counting needs draws['morris'] [B]")
        _check(morris, "morris", torch.float32, (B,))
    dev = labels.device
    if B == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return state, {"admitted": empty.bool(), "hit": empty.bool(),
                       "evicted_label": empty, "slot": empty}
    ins = [t.contiguous() for t in (labels, draws["uniforms"], state.labels,
                                    state.counts, state.cms)]
    gumbel = None if gumbel is None else gumbel.contiguous()
    morris = None if morris is None else morris.contiguous()
    # one int32 buffer for the new state and the info's ints, one byte
    # buffer for the info's bools
    out = torch.empty((2 * bmax + cells + 7 + 2 * B,), dtype=torch.int32, device=dev)
    flags = torch.empty((2 * B,), dtype=torch.bool, device=dev)
    o_lab, o_cnt = out[:bmax], out[bmax:2 * bmax]
    o_cms = out[2 * bmax:2 * bmax + cells].view(cfg.cms_depth, cfg.cms_width) \
        if cells else state.cms
    o_sc = out[2 * bmax + cells:2 * bmax + cells + 7]
    o_ev, o_slot = out[-2 * B:-B], out[-B:]
    ptr = o_sc.data_ptr()
    args = HHArgs(
        labels=ins[0].data_ptr(), uniforms=ins[1].data_ptr(),
        gumbel=build.ptr(gumbel), morris=build.ptr(morris),
        slot_labels=ins[2].data_ptr(), slot_counts=ins[3].data_ptr(),
        cms=ins[4].data_ptr(), admit_prob=state.admit_prob.data_ptr(),
        **{n: getattr(state, n).data_ptr() for n in _SCALARS},
        out_labels=o_lab.data_ptr(), out_counts=o_cnt.data_ptr(),
        out_cms=o_cms.data_ptr() if cells else None, out_admit_prob=ptr,
        **{f"out_{n}": ptr + 4 * (1 + k) for k, n in enumerate(_SCALARS)},
        admitted=flags.data_ptr(), hit=flags.data_ptr() + B,
        evicted_label=o_ev.data_ptr(), slot=o_slot.data_ptr(),
        B=B, bmax=bmax, policy=int(cfg.policy), morris_on=int(cfg.morris),
        gate_below_capacity=int(cfg.gate_below_capacity), adaptive=int(cfg.adaptive),
        capacity=cfg.capacity, cms_depth=cfg.cms_depth, cms_width=cfg.cms_width,
        window=cfg.window, b_step=cfg.b_step, u0=cfg.admit_prob,
        novel_hi=cfg.novel_hi, novel_lo=cfg.novel_lo, u_growth=cfg.u_growth,
        u_max=cfg.u_max)
    lib, fn = _fn()
    err = fn(ctypes.byref(args), plan.threads, plan.smem, build.stream_of(dev))
    build.check(lib, err, "heavy_hitter_launch")
    COUNTS["heavy_hitter"].kernel += 1
    new_state = hh.HHState(
        labels=o_lab, counts=o_cnt, cms=o_cms,
        admit_prob=o_sc[0:1].view(torch.float32).reshape(()),
        **{n: o_sc[1 + k] for k, n in enumerate(_SCALARS)})
    info = {"admitted": flags[:B], "hit": flags[B:], "evicted_label": o_ev,
            "slot": o_slot}
    return new_state, info
