"""Shared helpers for smoke checks: dummy batches from specs.

A dummy batch looks every id up at row 0 (one row, always in cache), so
it serves shape and finiteness checks only, never timing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


def dummy_batch(input_specs, seed: int = 0, device=None) -> dict:
    """Concrete batch matching a StepSpec's input_specs (nested dicts of
    specs too, such as a decode step's cache), on ``device`` (``cuda``
    unless given). ints -> zeros (always-valid indices), floats -> N(0, 1)
    from numpy (drawn in sorted key order, as the reference's tree walk
    draws them), bools -> True."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def make(specs):
        out = {}
        for name in sorted(specs):
            if isinstance(specs[name], dict):
                out[name] = make(specs[name])
                continue
            shape, dtype = specs[name]
            if dtype == torch.bool:
                out[name] = torch.ones(shape, dtype=dtype, device=dev)
            elif dtype.is_floating_point:
                out[name] = torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
            else:
                out[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return out

    return make(input_specs)


def assert_finite(tree, where: str = "") -> None:
    """Every float leaf of nested dicts/tuples/lists is finite."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            assert_finite(v, f"{where}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            assert_finite(v, f"{where}[{i}]")
    elif torch.is_tensor(tree) and tree.is_floating_point():
        assert bool(torch.isfinite(tree).all()), f"non-finite values at {where}"
