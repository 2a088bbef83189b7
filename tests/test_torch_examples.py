"""The port's examples (``examples/torch/``) run on the CPU, each in its
own process as a user starts it: exit 0 and the reference example's
lines, in its order; quickstart's memory budget, computed from the config
alone, equals the reference's."""
import os
import re
import subprocess
import sys

from repro.configs.streaming_rag import paper_pipeline_config as j_config
from repro.core import pipeline as j_pipeline

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# each example's argument list and the line prefixes the reference example
# prints, in order
EXAMPLES = {
    "quickstart": ([], ["state memory budget: ", "arrivals=", "active clusters=",
                        "index refreshes="] + ["query topic "] * 5
                   + ["", "doc store: "] + ["query topic "] * 5),
    "recsys_retrieval": ([], ["clicks ingested: "] + [f"user {u}: candidates from "
                                                      for u in range(4)]
                         + ["full-table MIPS top-5 (user 0): "]),
    "streaming_news_serve": ([], ["docs ingested           : ",
                                  "time-sensitive QA (EM)  : streaming=",
                                  "query batch latency (ms): mean=", "example: '"]),
    "train_embedder": (["--steps", "4"], ["loss trajectory:", "  step    4: loss=",
                                          "loss "]),
}


def test_examples_run_on_the_cpu_and_print_the_reference_lines(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "2"}
    procs = {}
    for name, (args, _) in EXAMPLES.items():
        extra = ["--ckpt-dir", str(tmp_path / "ckpt")] if name == "train_embedder" else []
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", "torch", f"{name}.py"),
             "--device", "cpu", *args, *extra],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
        outs[name] = out.splitlines()
    for name, (_, prefixes) in EXAMPLES.items():
        lines = outs[name]
        assert len(lines) == len(prefixes), (name, lines)
        for line, prefix in zip(lines, prefixes):
            assert line.startswith(prefix), (name, line, prefix)
    budget = float(re.match(r"state memory budget: ([\d.]+) MB", outs["quickstart"][0])[1])
    want = j_pipeline.state_memory_bytes(j_config(
        dim=64, k=150, capacity=100, update_interval=256, alpha=0.1, store_depth=8))
    assert budget == round(want / 1e6, 2)
    assert outs["streaming_news_serve"][0].endswith(f": {256 + 30 * 128}")
