"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP / SP),
and the placement of a tree onto a mesh by them.

Every parameter carries logical axis names (``models/layers.Builder``);
this module maps them onto a concrete mesh per architecture strategy, as
the reference's ``distributed/sharding.py`` does:

  TP   : heads / mlp / vocab / experts dims -> "model"
  EP   : the experts dim of MoE weight stacks -> "model"
  FSDP : the embed dim of large archs -> "data" (``cfg.fsdp``)
  DP   : batch dims of activations -> ("pod", "data")
  SP   : decode KV caches shard their sequence dim over "model"

A dim is only sharded when its size divides the mesh axis (qwen2's 12
heads stay replicated on a 16-wide model axis). The specs read nothing of
a mesh but its axis names and sizes, and the abstract params they come
from live on ``meta``: deepseek-v3-671b's take no memory.

``PartitionSpec`` is the port's own (one entry per leading dim: ``None``,
an axis name or a tuple of names; trailing ``None``s trimmed). ``shard``
places a tree: each tensor leaf becomes a ``Sharded``, one piece per mesh
position on that position's device, its dims split over the spec's axes
and replicated over the others; ``unshard`` gathers it back. The
reference's ``leading_axis_pspecs`` / ``engine_state_shardings`` (the
streaming engine's layouts) have no counterpart: ``engine/sharded.py``
keeps its shards as per-shard lists.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, axis_sizes, data_axes
from repro_torch.train.optimizer import OptState
from repro_torch.train.optimizer import tree_map as map_dicts


class PartitionSpec:
    """An immutable spec: per leading dim ``None`` (replicated), a mesh
    axis name, or a tuple of names (the dim split over their product,
    row-major in the order given). As jax's, a tuple of one name is that
    name and an empty tuple is ``None``; trailing ``None``s are trimmed, so
    ``P(None) == P()``."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        norm = []
        for p in parts:
            if isinstance(p, tuple):
                if not all(isinstance(a, str) for a in p):
                    raise TypeError(f"a spec entry is None, a name or a tuple of names: {p!r}")
                p = None if not p else p[0] if len(p) == 1 else p
            elif not (p is None or isinstance(p, str)):
                raise TypeError(f"a spec entry is None, a name or a tuple of names: {p!r}")
            norm.append(p)
        while norm and norm[-1] is None:
            norm.pop()
        object.__setattr__(self, "_parts", tuple(norm))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self._parts)) + ")"

    def mesh_axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dim ``dim`` is split over (() where replicated)."""
        p = self._parts[dim] if dim < len(self._parts) else None
        return () if p is None else (p,) if isinstance(p, str) else p


P = PartitionSpec

# logical axis -> preferred mesh axis
TP_RULES = {
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "item_vocab": "model",
    # replicated by default: kv_heads (<=16 and rarely divisible), head_dim,
    # q_lora/kv_lora (latents), layers, gnn dims, small recsys towers
}
FSDP_RULES = {"embed": "data"}


def rules_for(arch) -> dict[str, str]:
    rules = dict(TP_RULES)
    if getattr(getattr(arch, "cfg", None), "fsdp", False):
        rules.update(FSDP_RULES)
    return rules


def _spec_for_leaf(shape, axes, rules, sizes) -> PartitionSpec:
    parts = []
    used = set()
    for dim, name in enumerate(axes):
        mesh_axis = rules.get(name)
        if (mesh_axis and mesh_axis not in used and mesh_axis in sizes
                and shape[dim] % sizes[mesh_axis] == 0):
            parts.append(mesh_axis)
            used.add(mesh_axis)
        else:
            parts.append(None)
    return P(*parts)


def param_pspecs(arch, mesh):
    """PartitionSpec tree matching ``arch.abstract_params()``."""
    sizes = axis_sizes(mesh)
    rules = rules_for(arch)
    shapes, axes = arch.init_with_axes(0, "meta")
    return map_dicts(lambda leaf, ax: _spec_for_leaf(leaf.shape, ax, rules, sizes),
                      shapes, axes)


def opt_pspecs(arch, mesh, pspecs):
    """OptState specs derived from param specs: a moment has its param's
    spec; Adafactor's factored ``(row, col)`` pair drops the last dim's
    entry (row) and the second to last one's (col)."""
    abstract = arch.abstract_train_state("meta")

    def moment(o, p_spec, p):
        if isinstance(o, tuple):  # factored (row, col)
            full = tuple(p_spec) + (None,) * (p.dim() - len(p_spec))
            return (P(*full[:-1]), P(*(full[:-2] + full[-1:])))
        return p_spec

    def moment_specs(tree):
        if tree is None:
            return None
        return map_dicts(moment, tree, pspecs, abstract.params)

    return OptState(step=P(), mu=moment_specs(abstract.opt.mu),
                    nu=moment_specs(abstract.opt.nu))


def train_state_pspecs(arch, mesh):
    from repro_torch.models.api import TrainState

    pspec = param_pspecs(arch, mesh)
    return TrainState(params=pspec, opt=opt_pspecs(arch, mesh, pspec))


def batch_pspecs(arch, step_spec, mesh):
    """Specs for the batch tree: batch dims over DP axes; graph dims over
    every axis where they divide it; KV caches get sequence-sharding over
    the model axis (SP)."""
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_total = math.prod(sizes[a] for a in dp)

    flat = dp + (("model",) if "model" in sizes else ())
    flat_total = dp_total * sizes.get("model", 1)

    out = {}
    for name, leaf in step_spec.input_specs.items():
        if name == "cache":
            out[name] = _cache_pspecs(leaf, dp, dp_total, sizes)
            continue
        axes = step_spec.batch_axes.get(name)
        parts = []
        for dim, ax in enumerate(axes or ()):
            if ax in ("nodes", "edges") and leaf.shape[dim] % flat_total == 0:
                # graph dims shard over every mesh axis (params replicated)
                parts.append(flat)
            elif ax in ("batch", "nodes", "edges") \
                    and leaf.shape[dim] % dp_total == 0 and leaf.shape[dim] > 0:
                parts.append(dp)
            else:
                parts.append(None)
        out[name] = P(*parts)
    return out


def _cache_pspecs(cache_tree, dp, dp_total, sizes):
    """KV cache: [L, B, S, ...] -> P(None, dp, 'model', ...)."""
    model = sizes.get("model", 1)

    def spec(leaf):
        shp = leaf.shape
        if len(shp) >= 3:  # [L, B, S, ...]
            b = dp if shp[1] % dp_total == 0 else None
            s = "model" if shp[2] % model == 0 else None
            return P(None, b, s)
        if len(shp) == 2:  # pos [B, S]
            b = dp if shp[0] % dp_total == 0 else None
            s = "model" if shp[1] % model == 0 else None
            return P(b, s)
        if len(shp) == 1:  # len [B]
            return P(dp if shp[0] % dp_total == 0 else None)
        return P()

    return map_dicts(spec, cache_tree)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
class NamedSharding(NamedTuple):
    """A spec on a mesh: where a leaf's pieces go."""

    mesh: Mesh
    spec: PartitionSpec


class Sharded:
    """A tensor on a mesh: ``pieces[ix]`` is mesh position ``ix``'s piece,
    on that position's device; ``shape``/``dtype`` are the global
    tensor's."""

    __slots__ = ("pieces", "sharding", "shape", "dtype")

    def __init__(self, pieces: np.ndarray, sharding: NamedSharding, shape, dtype):
        self.pieces = pieces
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={self.sharding.mesh.shape})")


def _block(spec: PartitionSpec, mesh: Mesh, shape, ix) -> tuple[slice, ...]:
    """The global slices that mesh position ``ix`` holds."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.axis_names, ix))
    out = []
    for dim, n in enumerate(shape):
        axes = spec.mesh_axes(dim)
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{axes} ({parts} parts)")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _check(spec: PartitionSpec, mesh: Mesh, ndim: int) -> None:
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than the leaf's {ndim} dims")
    used = [a for d in range(len(spec)) for a in spec.mesh_axes(d)]
    unknown = [a for a in used if a not in mesh.axis_names]
    if unknown or len(used) != len(set(used)):
        raise ValueError(f"{spec} on mesh axes {mesh.axis_names}")


def put(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``x`` as a ``Sharded``: each mesh position's block of it, copied onto
    that position's device (``device_put`` with a ``NamedSharding``)."""
    mesh, spec = sharding
    _check(spec, mesh, x.dim())
    pieces = np.empty(mesh.shape, dtype=object)
    for ix in np.ndindex(*mesh.shape):
        block = x[_block(spec, mesh, x.shape, ix)]
        pieces[ix] = block.to(device=mesh.devices[ix], copy=True)
    return Sharded(pieces, sharding, x.shape, x.dtype)


def gather(s: Sharded, device) -> torch.Tensor:
    """The global tensor of ``s`` on ``device``: every distinct block copied
    in once (the all-gather)."""
    mesh, spec = s.sharding
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    split = {a for d in range(len(spec)) for a in spec.mesh_axes(d)}
    for ix in np.ndindex(*mesh.shape):
        if any(c for a, c in zip(mesh.axis_names, ix) if a not in split):
            continue            # a replica of a block already copied
        out[_block(spec, mesh, s.shape, ix)] = s.pieces[ix]
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a state tree (NamedTuples, dicts, tuples,
    lists; ``None`` an empty subtree), the first tree's structure, taking
    the matching node of each of ``rest``."""
    if tree is None:
        return None
    if hasattr(tree, "_fields") and not isinstance(tree, NamedSharding):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def shardings_from_pspecs(pspecs, mesh: Mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), pspecs)


def shard(tree, pspecs, mesh: Mesh):
    """Every tensor leaf of ``tree`` placed on ``mesh`` by its spec in
    ``pspecs`` (a tree of the same structure)."""
    return place(tree, shardings_from_pspecs(pspecs, mesh))


def place(tree, shardings):
    """Every tensor leaf of ``tree`` placed by its ``NamedSharding``."""
    return tree_map(put, tree, shardings)


def unshard(tree, device):
    """Every ``Sharded`` leaf of ``tree`` gathered onto ``device``; other
    leaves as they are."""
    return tree_map(lambda x: gather(x, device) if isinstance(x, Sharded) else x, tree)


def piece_bytes(tree) -> dict[Any, int]:
    """Bytes of the pieces on each mesh position, over a placed tree."""
    out: dict[Any, int] = {}

    def add(x):
        if isinstance(x, Sharded):
            for ix in np.ndindex(*x.pieces.shape):
                p = x.pieces[ix]
                out[ix] = out.get(ix, 0) + p.numel() * p.element_size()
        return x

    tree_map(add, tree)
    return out


def per_device_bytes(tree, pspecs, mesh) -> int:
    """The bytes each mesh position would hold of ``tree`` (tensors, on
    ``meta`` or anywhere) placed by ``pspecs``: computed from shapes,
    nothing allocated or moved."""
    sizes = axis_sizes(mesh)
    total = 0

    def add(x, spec):
        nonlocal total
        n = x.numel()
        for d in range(len(spec)):
            n //= math.prod(sizes[a] for a in spec.mesh_axes(d))
        total += n * x.element_size()
        return x

    tree_map(add, tree, pspecs)
    return total
