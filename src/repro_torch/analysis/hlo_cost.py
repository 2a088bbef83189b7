"""Cost model of a call, counted op by op on PyTorch's dispatch.

The reference walks the optimized HLO of a compiled program. The port
compiles nothing and has no HLO: this module keeps the reference's name
and its three roofline inputs, and counts them while the call runs once,
under a ``TorchDispatchMode`` that sees every aten op below autograd (so
a backward's ops too), on ``cpu``, ``cuda`` or ``meta`` alike (on
``meta`` nothing is computed or allocated, so a full-size step is
counted in seconds):

  flops            — products and convolutions only, as the reference's
                     (2·M·N·K), from ``torch.utils.flop_counter``'s
                     registry; ``flops_by_dtype`` splits them by the dtype
                     of the op's first operand
  bytes            — each op's tensor operands and outputs, as the
                     reference counts an instruction's operands and
                     result: a view moves nothing, and an output that
                     shares an operand's storage (an in-place or ``out=``
                     result) is that operand, not a second tensor.
                     Nothing is fused, so this is larger than XLA's count
                     over fused HLO (an elementwise tail counts its reads
                     and writes)
  collective bytes — result bytes of the port's collectives
                     (``distributed/collectives.py``), by type, while a
                     counter is active
  peak_bytes       — the bytes of the storages the call creates that are
                     alive at once, at their most, tracked through the
                     storages' lifetimes: the counterpart of XLA's
                     ``memory_analysis`` temp bytes

Loops need no trip-count recovery: eager execution counts every
iteration. A hand-written kernel's entry (``kernels/*/ops.py``) counts as
one op, its modeled work from ``kernels/cost.py``; the aten ops its
wrapper or plain version runs inside are not counted again.
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the counters now counting, innermost last (kernel entries and the
# collectives record into each)
ACTIVE: list["OpCounter"] = []

_ALLOCATE_ONLY = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted")
_DTYPE_CODE = {torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
               torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
               torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
               torch.bool: "pred"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # sparse and other layouts
        return None


def shape_str(t: torch.Tensor) -> str:
    """``f32[64,256]``: the HLO spelling of a tensor's type."""
    code = _DTYPE_CODE.get(t.dtype, str(t.dtype).removeprefix("torch."))
    return f"{code}[{','.join(map(str, t.shape))}]"


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes, collective bytes and the live-bytes peak of
    what runs inside ``with OpCounter() as c:``; ``c.result()`` is
    ``analyze``'s dict."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.flops_by_dtype: dict[str, float] = {}
        self.bytes = 0.0
        self.by_op: dict[tuple[str, str], float] = {}
        self.collective_bytes = 0.0
        self.collective_counts: dict[str, int] = {}
        self.muted = 0
        self.live = 0
        self.peak = 0
        self._known: weakref.WeakKeyDictionary | None = None

    def __enter__(self):
        from torch.utils.weak import WeakIdKeyDictionary

        self._known = WeakIdKeyDictionary()
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- storages ------------------------------------------------------------
    def _free(self, n: int) -> None:
        self.live -= n

    def _note(self, t: torch.Tensor, created: bool) -> None:
        """Remember ``t``'s storage; one the call created counts toward the
        live bytes until it is freed."""
        s = _storage(t)
        if s is None or s in self._known:
            return
        self._known[s] = True
        if created:
            n = s.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, n)

    # -- counting ------------------------------------------------------------
    def add_op(self, name: str, flops: float, nbytes: float, dtype: str | None,
               result: str) -> None:
        self.flops += flops
        if flops:
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + flops
        self.bytes += nbytes
        key = (name, result)
        self.by_op[key] = self.by_op.get(key, 0.0) + nbytes

    def add_collective(self, kind: str, nbytes: int) -> None:
        self.collective_bytes += nbytes
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if not self.muted:
            for t in ins:
                self._note(t, created=False)
        out = func(*args, **kwargs)
        if self.muted:
            return out
        outs = _tensors(out)
        for t in outs:
            self._note(t, created=True)
        packet = func.overloadpacket
        flops = 0.0
        if packet in self._flop_registry:
            flops = float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if not func.is_view and packet.__name__ not in _ALLOCATE_ONLY:
            storages = {id(_storage(t)) for t in ins}
            nbytes = sum(tensor_bytes(t) for t in ins)
            nbytes += sum(tensor_bytes(t) for t in outs
                          if id(_storage(t)) not in storages)
        dtype = str(ins[0].dtype).removeprefix("torch.") if ins else None
        self.add_op(f"aten.{packet.__name__}", flops, nbytes, dtype,
                    shape_str(outs[0]) if outs else "()")
        return out

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collective_counts": dict(self.collective_counts),
                "flops_by_dtype": dict(self.flops_by_dtype),
                "peak_bytes": float(self.peak)}


# ---------------------------------------------------------------------------
# Hooks for kernel entries and collectives
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def muted():
    """Inside, the active counters count no aten op (a kernel entry's
    wrapper or plain version; its cost is recorded as one op)."""
    counters = list(ACTIVE)
    for c in counters:
        c.muted += 1
    try:
        yield
    finally:
        for c in counters:
            c.muted -= 1


def record_entry(name: str, flops: float, nbytes: float, out) -> None:
    """One kernel entry's modeled work (fp32 operations, bytes) as one op
    of every active counter; its outputs' storages count as created."""
    outs = _tensors(out)
    for c in ACTIVE:
        if c.muted:
            continue
        for t in outs:
            c._note(t, created=True)
        c.add_op(f"kernel.{name}", flops, nbytes, "float32",
                 shape_str(outs[0]) if outs else "()")


_collective_depth = 0


def collective(kind: str):
    """Decorator: while a counter is active, a call of the decorated
    collective records its result's bytes under ``kind``. A collective
    called inside another is part of the outer one and records nothing."""
    assert kind in COLLECTIVES, kind

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            global _collective_depth
            _collective_depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _collective_depth -= 1
            if ACTIVE and _collective_depth == 0:
                nbytes = sum(tensor_bytes(t) for t in _tensors(out))
                for c in ACTIVE:
                    if not c.muted:
                        c.add_collective(kind, nbytes)
            return out
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# The reference's entry points
# ---------------------------------------------------------------------------
def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a counter: ``flops``,
    ``bytes``, ``collective_bytes``, ``collective_counts`` (the
    reference's keys), ``flops_by_dtype`` and ``peak_bytes``."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.result()


def bytes_breakdown(fn, *args, top: int = 15, **kwargs) -> list[tuple[str, float]]:
    """Bytes attributed to (op, result type) pairs over one run of
    ``fn(*args, **kwargs)``, the largest ``top`` first — the profiler
    substitute for the hypothesis loop, as the reference's."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    rows = sorted(c.by_op.items(), key=lambda kv: -kv[1])[:top]
    return [(f"{op} {shape}", b) for (op, shape), b in rows]
