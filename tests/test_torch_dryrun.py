"""The port's dry run (``repro_torch/launch/dryrun.py``): cells at full
size on ``meta``, in-process on the 16 x 16 stand-in mesh (status ok,
CUDA never initialised, the reference's JSON keys, the collective model
from the specs), a skipped shape written as the reference writes it, and
``--all`` as a subprocess with its cache of finished cells."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import roofline as j_roofline
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import get_arch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KEYS = {"status", "lower_seconds", "memory_analysis", "cost_analysis",
        *j_roofline.RooflineReport.__dataclass_fields__, "flops_by_dtype", "compute_term",
        "memory_term", "collective_term", "dominant", "useful_flops_fraction",
        "step_time_bound", "roofline_fraction"}


@pytest.mark.parametrize("arch,shape", [("fm", "train_batch"), ("mind", "serve_p99"),
                                        ("bert4rec", "train_batch"),
                                        ("meshgraphnet", "molecule"),
                                        ("qwen2-1.5b", "decode_32k")])
def test_cell_runs_at_full_size_on_meta(arch, shape, tmp_path):
    out = tmp_path / "cell.json"
    r = dryrun.run_cell(arch, shape, False, str(out), verbose=False)
    assert not torch.cuda.is_initialized()
    assert r["status"] == "ok" and set(r) == KEYS
    assert json.loads(out.read_text()) == json.loads(json.dumps(r, default=float))
    assert (r["mesh"], r["chips"]) == ("single_pod_16x16", 1)
    assert r["bytes_per_chip"] > 0 and r["memory_per_chip"] > 0
    assert r["flops_per_chip"] == sum(r["flops_by_dtype"].values())
    assert r["cost_analysis"]["flops"] == r["flops_per_chip"]
    mem = r["memory_analysis"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert mem["temp_bytes"] == r["memory_per_chip"]
    # the collective model: the stepping position gathers what it does not
    # hold, and a train step splits the new state back to the 255 others
    a = get_arch(arch)
    spec = a.step(shape)
    mesh = make_debug_mesh((16, 16), ("data", "model"), devices="meta")
    train = spec.kind == "train"
    state = a.abstract_train_state("meta") if train else a.abstract_params()
    specs = (sharding.train_state_pspecs if train else sharding.param_pspecs)(a, mesh)
    batch = dryrun.meta_batch(spec.input_specs)
    held = sharding.per_device_bytes(state, specs, mesh)
    held_batch = sharding.per_device_bytes(batch, sharding.batch_pspecs(a, spec, mesh), mesh)
    assert mem["argument_bytes"] == held + held_batch
    want = dryrun.tree_bytes(state) + dryrun.tree_bytes(batch) - held - held_batch \
        + (255 * held if train else 0)
    assert r["collective_bytes_per_chip"] == want
    assert set(r["collectives"]) == ({"all-gather", "scatter"} if train else {"all-gather"})


def test_skipped_shape_is_written_as_the_reference_writes_it(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    for multi in (False, True):
        flag = ["--multi-pod"] if multi else []
        ref, port = tmp_path / f"ref{multi}.json", tmp_path / f"port{multi}.json"
        out = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch",
                              "qwen2-1.5b", "--shape", "long_500k", "--out", str(ref), *flag],
                             env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        r = dryrun.run_cell("qwen2-1.5b", "long_500k", multi, str(port), verbose=False)
        assert r["status"] == "skipped"
        assert port.read_text() == ref.read_text()


def test_all_runs_each_cell_in_its_own_process_and_caches(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out-dir",
           str(tmp_path), "--archs", "fm", "--meshes", "single"]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "FAILURES: none" in out.stdout
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(f"fm__{s}__single.json" for s in get_arch("fm").shapes)
    for f in files:
        assert json.loads((tmp_path / f).read_text())["status"] == "ok"
    again = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0 and again.stdout.count("[cached]") == len(files)
