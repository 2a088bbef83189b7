"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU: each mode exits 0, answers every query it submitted, and prints
the reference launcher's summary lines for the flags it was given; a
second durable run on the same directory recovers first."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = ["--device", "cpu", "--batches", "4", "--batch", "64", "--qps", "8",
         "--topk", "5"]
ALWAYS = ("docs ingested", "queries answered", "batch latency ms",
          "index size")


def _launch(*flags: str) -> str:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *SMALL, *flags], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _labels(stdout: str) -> dict[str, str]:
    return {line.split(":", 1)[0].strip(): line.split(":", 1)[1].strip()
            for line in stdout.splitlines() if " : " in line}


def _answered_all(lines: dict) -> None:
    got, want = lines["queries answered"].split(" submitted")[0].split(" / ")
    assert int(got) == int(want) == 32, lines["queries answered"]


@pytest.mark.parametrize("flags,labels", [
    ((), ()),
    (("--two-stage", "--adaptive"), ("plan ladder", "queries shed")),
    (("--mesh", "2,2", "--two-stage"), ("store bytes/dev", "device map")),
])
def test_launcher_sync_modes(flags, labels):
    lines = _labels(_launch(*flags))
    for label in ALWAYS + labels:
        assert label in lines, (label, sorted(lines))
    _answered_all(lines)
    assert int(lines["index size"].split()[0]) > 0
    if "--mesh" in flags:
        assert lines["device map"].startswith("mesh 2x2")


def test_launcher_sharded_async_cached_durable_then_recovers(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    flags = ("--mesh", "2,2", "--two-stage", "--async", "--cache-entries",
             "64", "--hotset", "--checkpoint-dir", ckpt, "--metrics-json",
             str(tmp_path / "m.json"), "--trace-out", str(tmp_path / "t.json"))
    first = _labels(_launch(*flags))
    want = ("durability", "supervision", "serving cache", "hot tier",
            "state memory", "store bytes/dev", "metrics json", "chrome trace",
            "freshness")
    for label in ALWAYS + want:
        assert label in first, (label, sorted(first))
    assert "recovered" not in first
    _answered_all(first)
    assert "lag=0 docs" in first["freshness"]
    # store bytes per device == the full store's over M = 2
    from repro_torch.configs.streaming_rag import paper_pipeline_config
    from repro_torch.store import docstore

    cfg = paper_pipeline_config(dim=64, k=150, store_depth=8)
    assert int(first["store bytes/dev"]) * 2 == docstore.memory_bytes(cfg.store)
    metrics = json.load(open(tmp_path / "m.json"))
    assert metrics["counters"]["publish_total"] >= 1
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]

    second = _labels(_launch(*flags))
    assert "recovered" in second, sorted(second)
    assert second["recovered"].startswith("checkpoint_seq=3")
    _answered_all(second)


def test_launcher_async_single_device():
    lines = _labels(_launch("--two-stage", "--async", "--cache-entries", "32"))
    for label in ALWAYS + ("serving cache", "hot tier", "state memory"):
        assert label in lines, label
    assert "store bytes/dev" not in lines and "device map" not in lines
    _answered_all(lines)

