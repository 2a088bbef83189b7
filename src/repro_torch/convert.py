"""Carry pipeline state between the reference's layout and the port's.

The reference's ``PipelineState`` is given as nested dicts of numpy arrays
keyed by its field names (``{"pre": {"basis": ..., ...}, "clus": ...,
"route_labels": ..., ...}``); ``state_from_numpy`` builds the port's state
from that, and ``state_to_numpy`` goes the other way, for leaf-for-leaf
comparison. The reference's PRNG key is not carried: the port's state
gets a fresh ``torch.Generator`` seeded with ``seed``.

The baselines' states (``core/baselines.py``) cross the same way, by
method name: ``baseline_state_from_numpy`` builds the port's state from
the reference's NamedTuple state as nested dicts of numpy (host integers
become ints, a PRNG key becomes a fresh seeded generator), and
``state_to_numpy`` goes back for any of them.

Model params cross the same way: the reference's params tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) becomes the
port's nested dicts of tensors with ``params_from_numpy`` (stacked layer
blocks keep their leading layer axis), and ``params_to_numpy`` goes back.

A bf16 leaf crosses through a 16-bit integer view: numpy's
``ml_dtypes.bfloat16`` (what ``np.asarray`` of a JAX bf16 array gives)
becomes ``torch.bfloat16`` bit for bit, and back. Every other dtype stays
as it is.

Optimizer and train states cross as ``{"step", "mu", "nu"}`` and
``{"params", "opt"}`` nested dicts of numpy arrays: ``mu`` / ``nu`` are
param-shaped dicts or ``None``, and Adafactor's factored ``(row, col)``
leaves stay tuples (``opt_state_from_numpy``, ``train_state_from_numpy``
and their ``_to_numpy`` inverses).
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from repro_torch.core import clustering, heavy_hitter, index as index_lib, prefilter
from repro_torch.core.pipeline import PipelineState
from repro_torch.store import docstore


def _build(cls, sub: dict, dev, host_ints=()):
    vals = {}
    for name in cls._fields:
        a = np.asarray(sub[name])
        vals[name] = int(a) if name in host_ints else \
            torch.from_numpy(np.array(a)).to(dev)
    return cls(**vals)


def state_from_numpy(tree: dict, device="cpu", seed: int = 0) -> PipelineState:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return PipelineState(
        pre=_build(prefilter.PrefilterState, tree["pre"], dev,
                   ("write_ptr", "fill", "since_update")),
        clus=_build(clustering.ClusterState, tree["clus"], dev),
        hh=_build(heavy_hitter.HHState, tree["hh"], dev),
        index=_build(index_lib.FlatIndex, tree["index"], dev, ("version",)),
        store=_build(docstore.DocStore, tree["store"], dev),
        route_labels=torch.from_numpy(np.array(tree["route_labels"])).to(dev),
        rep_ids=torch.from_numpy(np.array(tree["rep_ids"])).to(dev),
        rep_sims=torch.from_numpy(np.array(tree["rep_sims"])).to(dev),
        arrivals=int(np.asarray(tree["arrivals"])),
        since_upsert=int(np.asarray(tree["since_upsert"])),
        kept=torch.from_numpy(np.array(tree["kept"])).to(dev),
        upserts=int(np.asarray(tree["upserts"])),
        gen=gen)


def _from_tree(cls, tree: dict, dev, gen_dev, seed: int):
    """``cls`` (a NamedTuple state) from the reference's leaves by field:
    nested states recurse, ``int``/``bool`` fields are host values, a
    generator field is a fresh one on ``gen_dev`` seeded with ``seed``."""
    hints = typing.get_type_hints(cls)
    vals = {}
    for name in cls._fields:
        t = hints[name]
        if t is torch.Generator:
            vals[name] = torch.Generator(device=gen_dev)
            vals[name].manual_seed(seed)
        elif isinstance(t, type) and hasattr(t, "_fields"):
            vals[name] = _from_tree(t, tree[name], dev, gen_dev, seed)
        elif t in (int, bool):
            vals[name] = t(np.asarray(tree[name]))
        else:
            vals[name] = torch.from_numpy(np.array(tree[name])).to(dev)
    return cls(**vals)


def baseline_state_from_numpy(method: str, tree: dict, device="cpu",
                              seed: int = 0):
    """The port's state of baseline ``method`` (a ``Method.name``) from the
    reference's state as nested dicts of numpy. The reservoir's generator
    lives on the host, every other one on ``device``."""
    from repro_torch.core import baselines

    if method in ("sakr", "streaming_rag", "streaming_rag_2stage"):
        return state_from_numpy(tree, device, seed)
    cls = {"static_rag": baselines.StaticState,
           "full_rebuild": baselines.RebuildState,
           "reservoir": baselines.ReservoirState,
           "heap_only": baselines.HeapOnlyState,
           "ivfpq_incremental": baselines.IVFPQState}[method]
    dev = torch.device(device)
    gen_dev = torch.device("cpu") if method == "reservoir" else dev
    return _from_tree(cls, tree, dev, gen_dev, seed)


def state_to_numpy(state) -> dict:
    """Nested dicts of numpy arrays by field name; host integers become
    int32 scalars, the generator is left out."""
    out = {}
    for name, v in zip(state._fields, state):
        if isinstance(v, torch.Generator):
            continue
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[name] = state_to_numpy(v)
        elif torch.is_tensor(v):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v, np.int32)
    return out


def _tensor(a, dev) -> torch.Tensor:
    """A numpy leaf as a tensor on ``dev``; bf16 by its 16-bit view."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor leaf as a numpy array; bf16 as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device="cpu"):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``, dtypes and shapes kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, torch.device(device))


def params_to_numpy(tree):
    """Nested dicts of tensors -> the same dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _array(tree)


def _moments_from_numpy(tree, dev):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _moments_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_moments_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev)


def _moments_to_numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _moments_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_moments_to_numpy(v) for v in tree)
    return _array(tree)


def opt_state_from_numpy(tree: dict, device="cpu"):
    """``{"step", "mu", "nu"}`` of numpy (the reference's ``OptState``) ->
    the port's ``OptState`` on ``device``; the step a 0-d int32 tensor."""
    from repro_torch.train.optimizer import OptState

    dev = torch.device(device)
    step = torch.from_numpy(np.array(tree["step"], np.int32)).to(dev)
    return OptState(step, _moments_from_numpy(tree["mu"], dev),
                    _moments_from_numpy(tree["nu"], dev))


def opt_state_to_numpy(state) -> dict:
    return {"step": np.asarray(state.step.detach().cpu().numpy(), np.int32),
            "mu": _moments_to_numpy(state.mu), "nu": _moments_to_numpy(state.nu)}


def train_state_from_numpy(tree: dict, device="cpu"):
    """``{"params", "opt"}`` of numpy -> the port's ``TrainState``."""
    from repro_torch.models.api import TrainState

    return TrainState(params_from_numpy(tree["params"], device),
                      opt_state_from_numpy(tree["opt"], device))


def train_state_to_numpy(state) -> dict:
    return {"params": params_to_numpy(state.params),
            "opt": opt_state_to_numpy(state.opt)}
