"""Architecture API, the serving half: every ported arch implements this
protocol so a launcher treats them alike.

An Arch owns:
  * init(seed, device) -> params             (nested dicts of tensors)
  * shapes: {shape_name: ShapeDef}           (the assigned input-shape set)
  * step(shape_name) -> StepSpec             (the step + its input specs)

``StepSpec.fn(params, batch)`` runs where its tensors are. Abstract
params and logical axes wait for the sharding port (ROADMAP A8); the
train state and train step wait for training (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str                   # train | prefill | decode | serve | retrieval
    dims: tuple[tuple[str, int], ...]  # named dims, e.g. (("seq", 4096), ...)

    def dim(self, k: str) -> int:
        return dict(self.dims)[k]


class TensorSpec(NamedTuple):
    """Shape and dtype of one batch entry (``jax.ShapeDtypeStruct``'s part
    the port needs)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class StepSpec(NamedTuple):
    """The reference's StepSpec without its sharding and donation fields
    (logical batch axes come with A8; nothing is donated without jit)."""

    fn: Callable                       # (params, batch) -> out
    input_specs: dict[str, TensorSpec]
    kind: str                          # train | serve


class Arch:
    """Base: subclasses set .name, .shapes and implement init/step."""

    name: str = "base"
    shapes: dict[str, ShapeDef] = {}

    def init(self, seed: int = 0, device=None):
        """Params on ``device`` (``cuda`` unless given; raises without a
        card), drawn from a ``torch.Generator`` seeded with ``seed``."""
        raise NotImplementedError

    def step(self, shape_name: str) -> StepSpec:
        raise NotImplementedError


_REGISTRY: dict[str, Callable[..., Arch]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str, **overrides) -> Arch:
    if name not in _REGISTRY:
        # configs register lazily on import
        import importlib
        importlib.import_module("repro_torch.configs")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)


def list_archs() -> list[str]:
    import importlib
    importlib.import_module("repro_torch.configs")
    return sorted(_REGISTRY)


def spec(shape, dtype=torch.float32) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)
