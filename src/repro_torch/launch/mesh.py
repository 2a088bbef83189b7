"""The device grid of the sharded streaming engine.

A ``Mesh`` is a ``D x M`` grid of ``torch.device``s with axis names
(``data``, ``model``): ``data`` shards the ingest stream, ``model``
cluster-shards the serving doc store. One process drives every shard and
moves tensors between them explicitly (``distributed.collectives``).
On a card every shard shares that one card, as the reference forces
``D * M`` host devices onto one CPU; ``describe`` prints the map, so the
sharing is never hidden.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray                 # [D, M] object array of torch.device
    axis_names: tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> tuple[int, ...]:
        return self.devices.shape

    def device(self, data: int, model: int) -> torch.device:
        return self.devices[data, model]


def _grid(shape: tuple[int, int], devices) -> np.ndarray:
    n = shape[0] * shape[1]
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [devices]
    pool = [torch.device("cuda" if d is None else d) for d in devices]
    assert pool, "a mesh needs at least one device"
    # the kernels' wrappers launch on the current card, and the async
    # runtime keeps one ingest stream: every CUDA shard shares one card
    if any(d.type == "cuda" for d in pool) and len(set(pool)) > 1:
        raise ValueError(f"a mesh on a card places every shard on that one "
                         f"card, got {[str(d) for d in pool]}")
    pool = [resolve_device(d) for d in pool]
    if pool[0].type == "cuda" and pool[0].index is None:
        pool = [torch.device("cuda", torch.cuda.current_device())]
    grid = np.empty((n,), dtype=object)
    for i in range(n):
        grid[i] = pool[i % len(pool)]
    return grid.reshape(shape)


def make_streaming_mesh(data: int, model: int, devices=None) -> Mesh:
    """``data`` ingest shards x ``model`` store shards over ``devices``
    (a device, a device string or a list; None = the current ``cuda``
    card), assigned round-robin in row-major order. Host devices may
    differ from shard to shard; CUDA shards all share one card."""
    assert data >= 1 and model >= 1, (data, model)
    return Mesh(_grid((data, model), devices), ("data", "model"))


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), devices=None) -> Mesh:
    """A small mesh for tests (pass ``devices="cpu"`` there)."""
    assert len(shape) == 2 and tuple(axes) == ("data", "model"), (shape, axes)
    return Mesh(_grid(tuple(shape), devices), tuple(axes))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch/data-parallel axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def describe(mesh: Mesh) -> str:
    """The device map, one ``(data, model) -> device`` entry per shard."""
    D, M = mesh.shape
    cells = [f"({d},{m})->{mesh.devices[d, m]}" for d in range(D)
             for m in range(M)]
    distinct = len({str(x) for x in mesh.devices.ravel()})
    return (f"mesh {D}x{M} {mesh.axis_names} on {distinct} device(s): "
            + " ".join(cells))
