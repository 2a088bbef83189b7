#!/usr/bin/env python3
"""Markdown table of a ``python -m repro_torch.launch.dryrun --all`` run.

    python3 tools/dryrun_table.py DRYRUN_DIR

One row per arch x shape, in the order ``--all`` walks the cells: the
counted flops, bytes and live-bytes peak (the same on both meshes: the
port's step runs whole on one card), the compute and memory terms, and
each mesh's collective term and dominant term. The terms are modeled
against the H100 SXM's published peaks at 700 W
(``analysis/roofline.py``), not measured. A skipped shape shows its
reason.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.models.api import get_arch  # noqa: E402


def main(out_dir: str) -> int:
    print("| arch | shape | flops | bytes | peak B | compute s | memory s | "
          "collective s 16x16 / 2x16x16 | dominant 16x16 / 2x16x16 |")
    print("|---|---|---|---|---|---|---|---|---|")
    bad = 0
    for arch in ASSIGNED:
        for shape in get_arch(arch).shapes:
            cells = []
            for mesh in ("single", "multi"):
                with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")) as f:
                    cells.append(json.load(f))
            s, m = cells
            if s["status"] == "skipped" and m["status"] == "skipped":
                print(f"| {arch} | {shape} | skipped: {s['reason']} ||||||| ")
                continue
            if s["status"] != "ok" or m["status"] != "ok":
                bad += 1
                print(f"| {arch} | {shape} | {s['status']} / {m['status']} ||||||| ")
                continue
            assert (s["flops_per_chip"], s["bytes_per_chip"]) == \
                (m["flops_per_chip"], m["bytes_per_chip"]), (arch, shape)
            print(f"| {arch} | {shape} | {s['flops_per_chip']:.3e} | "
                  f"{s['bytes_per_chip']:.3e} | {s['memory_per_chip']:.3e} | "
                  f"{s['compute_term']:.3e} | {s['memory_term']:.3e} | "
                  f"{s['collective_term']:.3e} / {m['collective_term']:.3e} | "
                  f"{s['dominant']} / {m['dominant']} |")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
