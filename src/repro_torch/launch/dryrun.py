"""Dry run: count every (architecture x input shape x mesh) cell at full
size, allocating nothing, and record memory, cost and collective bytes
for the roofline.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all --out-dir dryrun_results [--archs ...] [--meshes single multi]

A cell builds its state on ``meta`` (``abstract_train_state("meta")``
for a train step, ``abstract_params()`` otherwise), makes the batch from
the step's ``input_specs`` on ``meta`` and runs the step once under
``analysis.hlo_cost``'s counter: ``meta`` stands where the reference
puts 512 placeholder host devices, and nothing is computed, allocated or
placed on a card. Kernel entries count their modeled work
(``kernels/cost.py``; on ``meta`` the part that does not depend on the
data). The meshes are the stand-ins 16 x 16 (``data``, ``model``) and 2 x
16 x 16 (``pod``, ``data``, ``model``) on ``meta`` devices: the specs
(``distributed/sharding.py``) read only axis names and sizes.

What the port does on a mesh, and so what a cell reports: the
``Trainer`` gathers the state onto the card that steps, runs the
one-device step and places the new state back (``train/trainer.py``).
So flops, bytes and the peak are the whole step's, run by one card
(``chips`` 1); ``argument_bytes`` is the state and batch bytes one mesh
position holds by the specs (``sharding.per_device_bytes``); and the
collective bytes are what that gather and split move for the stepping
position, from the specs:

    gather = (state + batch bytes) - (the state and batch bytes it holds)
    split  = (positions - 1) x (the state bytes one position holds)
    collective bytes = gather + split    (a serve step: gather alone)

counted as ``all-gather`` and ``scatter``, one each per leaf.

A cell never initialises CUDA: its process asserts so at its end.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def meta_batch(specs):
    from repro_torch.models.api import TensorSpec

    if isinstance(specs, TensorSpec):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    return {k: meta_batch(v) for k, v in specs.items()}


def _leaves(tree) -> list[torch.Tensor]:
    from repro_torch.distributed import sharding

    out: list = []
    sharding.tree_map(lambda x: out.append(x) if torch.is_tensor(x) else None, tree)
    return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def collective_model(state, state_pspecs, batch, batch_pspecs, mesh, train: bool):
    """(bytes, counts) the stepping position moves on ``mesh``: the gather
    of the state and batch, and for a train step the split of the new
    state (module docstring)."""
    from repro_torch.distributed import sharding

    held = sharding.per_device_bytes(state, state_pspecs, mesh)
    held_batch = sharding.per_device_bytes(batch, batch_pspecs, mesh)
    gather = tree_bytes(state) + tree_bytes(batch) - held - held_batch
    counts = {"all-gather": len(_leaves(state)) + len(_leaves(batch))}
    split = 0
    if train:
        split = (mesh.devices.size - 1) * held
        counts["scatter"] = len(_leaves(state))
    return float(gather + split), counts, held + held_batch


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_path: str | None = None, verbose: bool = True) -> dict:
    from repro_torch.analysis import hlo_cost, roofline
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.api import get_arch

    arch = get_arch(arch_name)
    sh = arch.shapes[shape_name]
    if sh.skip:
        result = {"arch": arch_name, "shape": shape_name,
                  "mesh": "multi_pod" if multi_pod else "single_pod",
                  "status": "skipped", "reason": sh.skip}
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
        return result

    shape, axes = MESHES[multi_pod]
    mesh = make_debug_mesh(shape, axes, devices="meta")
    spec = arch.step(shape_name)
    train = spec.kind == "train"
    t0 = time.time()
    if train:
        state = arch.abstract_train_state("meta")
        state_pspecs = sharding.train_state_pspecs(arch, mesh)
    else:
        state = arch.abstract_params()
        state_pspecs = sharding.param_pspecs(arch, mesh)
    batch = meta_batch(spec.input_specs)
    batch_pspecs = sharding.batch_pspecs(arch, spec, mesh)
    t_lower = time.time() - t0

    with hlo_cost.OpCounter() as counter:
        out = spec.fn(state, batch)
    t_compile = time.time() - t0
    cost = counter.result()
    coll_bytes, coll_counts, held = collective_model(
        state, state_pspecs, batch, batch_pspecs, mesh, train)
    mem = {"argument_bytes": held, "output_bytes": tree_bytes(out),
           "temp_bytes": cost["peak_bytes"], "alias_bytes": 0}
    if verbose:
        print("memory_analysis:", mem)
        print("op count:", {k: (f"{v:.3e}" if isinstance(v, float) else v)
                            for k, v in cost.items()})

    report = roofline.RooflineReport(
        arch=arch_name, shape=shape_name,
        mesh="multi_pod_2x16x16" if multi_pod else "single_pod_16x16",
        chips=1,
        flops_per_chip=cost["flops"],
        bytes_per_chip=cost["bytes"],
        collective_bytes_per_chip=coll_bytes,
        collectives=coll_counts,
        model_flops=roofline.model_flops_for(arch, shape_name),
        memory_per_chip=cost["peak_bytes"],
        compile_seconds=t_compile,
        flops_by_dtype=cost["flops_by_dtype"],
    )
    result = {
        "status": "ok", "lower_seconds": t_lower,
        "memory_analysis": mem,
        "cost_analysis": {k: v for k, v in cost.items() if isinstance(v, (int, float))},
        **report.to_json(),
    }
    if verbose:
        print(f"[{arch_name} × {shape_name} × "
              f"{'2x16x16' if multi_pod else '16x16'}] "
              f"compute={report.compute_term:.3e}s "
              f"memory={report.memory_term:.3e}s "
              f"collective={report.collective_term:.3e}s "
              f"dominant={report.dominant} "
              f"(counted in {t_compile:.1f}s)")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result


def run_all(out_dir: str, meshes=("single", "multi"), archs=None,
            per_cell_timeout: int = 3000):
    """Drive every cell in its own subprocess (crash isolation, memory
    hygiene); a cell already ``ok`` or ``skipped`` in ``out_dir`` is
    kept."""
    os.makedirs(out_dir, exist_ok=True)
    from repro_torch.configs import ASSIGNED
    from repro_torch.models.api import get_arch

    cells = []
    for arch_name in (archs or ASSIGNED):
        arch = get_arch(arch_name)
        for shape_name in arch.shapes:
            for m in meshes:
                cells.append((arch_name, shape_name, m == "multi"))

    failures = []
    for arch_name, shape_name, multi in cells:
        tag = f"{arch_name}__{shape_name}__{'multi' if multi else 'single'}"
        out_path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(out_path):
            with open(out_path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[cached] {tag}")
                    continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch_name, "--shape", shape_name, "--out", out_path]
        if multi:
            cmd.append("--multi-pod")
        print(f"[run] {tag}", flush=True)
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=per_cell_timeout)
            if proc.returncode != 0:
                failures.append(tag)
                with open(out_path, "w") as f:
                    json.dump({"status": "failed",
                               "stderr": proc.stderr[-4000:]}, f, indent=2)
                print(f"[FAIL] {tag}\n{proc.stderr[-2000:]}")
            else:
                print(f"[ok] {tag} ({time.time()-t0:.0f}s)")
        except subprocess.TimeoutExpired:
            failures.append(tag)
            with open(out_path, "w") as f:
                json.dump({"status": "timeout"}, f)
            print(f"[TIMEOUT] {tag}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--meshes", nargs="*", default=("single", "multi"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default="dryrun_results")
    args = ap.parse_args(argv)

    if args.all:
        failures = run_all(args.out_dir, meshes=args.meshes, archs=args.archs)
        print("FAILURES:", failures or "none")
        sys.exit(1 if failures else 0)

    try:
        run_cell(args.arch, args.shape, args.multi_pod, args.out)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    assert not torch.cuda.is_initialized(), "a dry-run cell initialised CUDA"


if __name__ == "__main__":
    main()
