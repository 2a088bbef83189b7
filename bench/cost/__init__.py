"""Frozen work formulas and peaks: each kernel's least time on the card
(``bound``), from the operations and bytes its call needs. Copied from
the program's ``kernels/cost.py`` and ``analysis/roofline.py`` so that a
change to the program cannot move the yardstick."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "h100.json").read_text())


def bound_ms(flops: float, nbytes: float) -> float:
    """The larger of fp32 operations over the fp32 peak and bytes over
    the HBM rate, in ms."""
    return max(flops / PEAKS["fp32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"]) * 1e3
