"""Fault-tolerant checkpointing (no external deps).

Guarantees:
  * atomic     — writes go to ``<dir>/tmp.<step>`` then os.replace() into
                 ``<dir>/step_<n>``; a crash mid-write never corrupts the
                 latest checkpoint.
  * async      — ``save_async`` snapshots to host then hands the file write
                 to a background thread; the caller never blocks on disk.
  * bounded    — keep_n retention deletes the oldest checkpoints.
  * exactly-once streams — the checkpoint carries opaque metadata (stream
                 offsets, counter state) alongside the state tree.

Trees are the port's state types: NamedTuples, dicts, tuples and lists
of tensors, Python ints and ``torch.Generator``s; a ``None`` is an empty
subtree (no leaf is saved for it, and it restores as ``None``). ``flatten_tree`` names
each leaf by the reference's keystr form (``.clus.centroids``,
``.store.embs``, ``['w']``, ``[0]``), so paths read the same in both
packages. A Python int leaf (the host counters ``arrivals``,
``since_upsert``, ``upserts``, ...) goes out as a 0-d int64 array and
comes back as ``int``; a generator (``PipelineState.gen``, the port's
counterpart of the reference's typed PRNG key) goes out as its
``get_state()`` bytes and comes back as a new generator on the abstract
generator's device with that state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _items(tree):
    """(key suffix, child) pairs of a container node, else None."""
    if hasattr(tree, "_fields"):
        return [(f".{n}", v) for n, v in zip(tree._fields, tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _walk(tree, prefix: str = ""):
    """(keystr path, leaf) pairs; a ``None`` is no leaf (an empty subtree,
    as the reference's tree flatten drops it: Adafactor's and SGD's ``mu``)."""
    if tree is None:
        return
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for key, child in items:
        yield from _walk(child, prefix + key)


def _leaf_out(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int64)
    return leaf


def flatten_tree(tree) -> dict[str, Any]:
    """{keystr path: leaf}: tensors as they are, generators as their
    ``get_state()`` uint8 tensor, Python ints as 0-d int64 arrays (shared
    with ``serve.durability``)."""
    return {key: _leaf_out(leaf) for key, leaf in _walk(tree)}


def to_host(leaf) -> np.ndarray:
    """A flattened leaf as a numpy array that owns its memory. numpy has
    no bfloat16: a bf16 tensor goes out as its 16 bits, a 2-byte void
    array (the bytes and the dtype the reference's ``np.savez`` of an
    ``ml_dtypes.bfloat16`` leaf writes)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2").copy()
        return t.numpy().copy()
    return np.array(leaf)


def _leaf_in(abstract, arr):
    if isinstance(abstract, torch.Generator):
        gen = torch.Generator(device=abstract.device)
        gen.set_state(torch.from_numpy(np.array(arr, np.uint8)))
        return gen
    if torch.is_tensor(abstract):
        a = np.array(arr)
        if abstract.dtype == torch.bfloat16 and a.dtype.kind == "V" and a.dtype.itemsize == 2:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(abstract.device)
        return torch.from_numpy(a).to(abstract.dtype).to(abstract.device)
    if isinstance(abstract, bool):
        return bool(arr)
    if isinstance(abstract, int):
        return int(arr)
    return arr


def _rebuild(tree, leaves):
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def unflatten_arrays(abstract_tree, arrays: dict[str, Any]):
    """Rebuild ``abstract_tree``'s structure from a {keystr path: numpy
    array} dict: tensors on the abstract leaf's device with its dtype,
    ints as ints, generators with the saved state. The restore half of
    :func:`flatten_tree`."""
    leaves = []
    for key, leaf in _walk(abstract_tree):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        leaves.append(_leaf_in(leaf, arrays[key]))
    return _rebuild(abstract_tree, iter(leaves))


def fsync_path(path: str) -> None:
    """fsync a written file so a post-crash recovery can trust it (best
    effort: platforms without dir/file fsync just proceed)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def fsync_dir(path: str) -> None:
    """fsync a directory entry (the rename itself must be durable, not
    just the renamed files)."""
    fsync_path(path)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, metadata: dict | None = None,
             blocking: bool = True):
        # snapshot to host first: later steps write the state in place
        flat = {k: to_host(v) for k, v in flatten_tree(tree).items()}
        meta = dict(metadata or {})
        meta["step"] = int(step)

        def write():
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:012d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{k.replace("/", "╱"): v for k, v in flat.items()})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._retain()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree, metadata: dict | None = None):
        self.save(step, tree, metadata, blocking=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, abstract_tree, step: int | None = None,
                shardings=None) -> tuple[Any, dict]:
        """Restore onto the abstract tree's devices, then, given a tree of
        ``sharding.NamedSharding``s, place it on their mesh (the elastic
        restore: a checkpoint holds global arrays, so it restores onto any
        mesh, or none)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(d, "arrays.npz"))
        arrays = {k.replace("╱", "/"): z[k] for k in z.files}
        tree = unflatten_arrays(abstract_tree, arrays)
        if shardings is not None:
            from repro_torch.distributed.sharding import place
            tree = place(tree, shardings)
        return tree, meta
