"""Architecture API: every ported arch implements this protocol so the
launchers and the trainer treat them alike.

An Arch owns:
  * init(seed, device) -> params             (nested dicts of tensors)
  * shapes: {shape_name: ShapeDef}           (the assigned input-shape set)
  * step(shape_name) -> StepSpec             (the step + its input specs)
  * loss(params, batch) -> (loss, extras)    (the train objective)
  * optimizer, microbatches                  (the train step's settings)

``StepSpec.fn(state, batch)`` runs where its tensors are: ``state`` is the
params (serve) or a ``TrainState`` (train). ``param_axes`` and
``init_with_axes`` (logical axes for sharding rules) wait for
training-side distribution (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.train import optimizer as opt_lib


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
    (logical batch axes wait for training-side distribution, ROADMAP A10;
    nothing is donated without jit)."""

    fn: Callable                       # (state, batch) -> out
    input_specs: dict[str, TensorSpec]
    kind: str                          # train | serve


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.OptState


class Arch:
    """Base: subclasses set .name, .shapes and implement init/step/loss."""

    name: str = "base"
    optimizer = opt_lib.OptimizerConfig()
    shapes: dict[str, ShapeDef] = {}
    microbatches: int = 1   # gradient-accumulation splits inside train_step

    def init(self, seed: int = 0, device=None):
        """Params on ``device`` (``cuda`` unless given; raises without a
        card), drawn from a ``torch.Generator`` seeded with ``seed``."""
        raise NotImplementedError

    # -- train state ----------------------------------------------------------
    def init_train_state(self, seed: int = 0, device=None) -> TrainState:
        """Params and a fresh optimizer state on ``device`` (``cuda``
        unless given; raises without a card)."""
        p = self.init(seed, device)
        return TrainState(params=p, opt=opt_lib.init(self.optimizer, p))

    def abstract_train_state(self, device=None) -> TrainState:
        """The tree a checkpoint restores onto: a freshly initialised train
        state on ``device`` (``cuda`` unless given), since the restore puts
        each leaf on its abstract leaf's device with its dtype (an abstract
        tree on ``meta`` would restore nothing real)."""
        return self.init_train_state(0, device)

    def loss(self, params, batch):
        raise NotImplementedError

    def loss_and_grads(self, params, batch):
        """(loss, extras, grads): ``loss(params, batch)`` and its gradient
        with respect to every param leaf (zeros for a leaf the loss does not
        use), by autograd on detached leaves; ``params`` is not written."""
        live = opt_lib.tree_map(lambda t: t.detach().requires_grad_(True), params)
        flat = opt_lib.leaves(live)
        with torch.enable_grad():
            out = self.loss(live, batch)
            loss, extras = out if isinstance(out, tuple) else (out, {})
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_leaf = {id(t): torch.zeros_like(t) if g is None else g
                   for t, g in zip(flat, grads)}
        return (loss.detach(), {k: v.detach() for k, v in extras.items()},
                opt_lib.tree_map(lambda t: by_leaf[id(t)], live))

    def make_train_step(self):
        """``train_step(state, batch) -> (new_state, metrics)``: the loss's
        gradients by autograd, then ``optimizer.apply``. With
        ``microbatches`` M > 1 every batch entry whose leading dim is M is
        split along it and the gradients summed over a loop, each divided
        by M, into accumulators of the param dtype (the reference's scan);
        the rest is passed whole to every microbatch. Nothing in ``state``
        is written."""
        ocfg = self.optimizer
        M = max(1, int(self.microbatches))

        def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
            if M == 1:
                loss, extras, grads = self.loss_and_grads(state.params, batch)
            else:
                scanned, carried = {}, {}
                for k, v in batch.items():
                    if v.dim() >= 1 and v.shape[0] == M:
                        scanned[k] = v
                    else:
                        carried[k] = v
                grads = opt_lib.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device),
                    state.params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=opt_lib.leaves(state.params)[0].device)
                extras_all = []
                for i in range(M):
                    mb = {**{k: v[i] for k, v in scanned.items()}, **carried}
                    l, ex, g = self.loss_and_grads(state.params, mb)
                    grads = opt_lib.tree_map(lambda a, gi: a + gi.to(a.dtype) / M,
                                             grads, g)
                    loss = loss + l / M
                    extras_all.append(ex)
                extras = {k: torch.mean(torch.stack([ex[k] for ex in extras_all]))
                          for k in extras_all[0]}
            new_p, new_opt, metrics = opt_lib.apply(ocfg, state.params, grads, state.opt)
            metrics = {**metrics, **extras, "loss": loss}
            return TrainState(new_p, new_opt), metrics

        return train_step

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
