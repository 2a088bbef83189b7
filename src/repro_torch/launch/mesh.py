"""Device grids: the sharded streaming engine's and the train state's.

A ``Mesh`` is a grid of ``torch.device``s with one to three named axes
out of (``pod``, ``data``, ``model``), in that order. The streaming engine
takes ``D x M`` (``data``, ``model``): ``data`` shards the ingest stream,
``model`` cluster-shards the serving doc store. The trainer places its
state on any of them by the specs of ``distributed.sharding``. One
process drives every shard and moves tensors between them explicitly
(``distributed.collectives``). On a card every shard shares that one
card, as the reference forces its host devices onto one CPU; ``describe``
prints the map, so the sharing is never hidden. Production shapes
(2 x 16 x 16) are specs, not placements: ``sharding`` reads only a mesh's
axis names and sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray                 # object array of torch.device, one dim an axis
    axis_names: tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> tuple[int, ...]:
        return self.devices.shape

    def device(self, *index: int) -> torch.device:
        """The device at a mesh position (one index per axis)."""
        return self.devices[index]


def _grid(shape: tuple[int, ...], devices) -> np.ndarray:
    n = int(np.prod(shape))
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
    """A small mesh of one to three named axes, a subsequence of (``pod``,
    ``data``, ``model``), over ``devices`` as ``make_streaming_mesh``
    places them (None = the current ``cuda`` card; tests pass ``"cpu"``)."""
    axes = tuple(axes)
    it = iter(AXES)
    if not (len(shape) == len(axes) >= 1 and all(a in it for a in axes)):
        raise ValueError(f"a mesh takes 1-3 of the axes {AXES} in that order, "
                         f"got shape {tuple(shape)} over {axes}")
    assert all(int(s) >= 1 for s in shape), shape
    return Mesh(_grid(tuple(int(s) for s in shape), devices), axes)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch/data-parallel axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def describe(mesh: Mesh) -> str:
    """The device map, one ``(index, ...) -> device`` entry per position."""
    cells = [f"({','.join(map(str, ix))})->{mesh.devices[ix]}"
             for ix in np.ndindex(*mesh.shape)]
    distinct = len({str(x) for x in mesh.devices.ravel()})
    return (f"mesh {'x'.join(map(str, mesh.shape))} {mesh.axis_names} on "
            f"{distinct} device(s): " + " ".join(cells))
