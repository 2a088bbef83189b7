"""The benchmark's own rules: what a run may import, what the reference
may import, that a cell's files are found by name alone, and that every
name in BENCHMARK.json keeps to the allowed characters."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

from bench.tests import _tiny

REPO = _tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from bench import run

    fake = {"repro_torch": None, "repro_torch.core": None, "reprox": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "repro.core": None,
                                         "jax.numpy": None, "flax": None})
    assert run.forbidden_modules() == ["flax", "jax.numpy", "repro.core"]


def test_a_run_imports_neither_jax_nor_repro(tmp_path):
    root = _tiny.make(tmp_path)
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from bench import run\n"
        "run.setup_env()\n"
        "from bench.tests import _tiny\n"
        "from pathlib import Path\n"
        "res = _tiny.run(Path(%r), 'query', trace=True)\n"
        "assert res['correct']\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
    ) % (str(REPO), str(REPO / "src"), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "bench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax"), (path, n)


def test_files_added_to_a_copy_are_found_by_name(tmp_path):
    root = _tiny.make(tmp_path)
    b = root / "bench"
    cfg = json.loads((b / "configs/tiny.json").read_text())
    cfg["server"]["nprobe"] = 2
    (b / "configs/tiny2.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic/tiny-query.json").read_text())
    tr["queries"]["rate_per_s"] = 200.0
    (b / "traffic/tiny-rare.json").write_text(json.dumps(tr))
    (b / "limits/tiny2.rare.json").write_text(
        (b / "limits/tiny.query.json").read_text())
    (b / "metrics/answered_share.py").write_text(
        "import numpy as np\n\n\ndef read(rec):\n"
        "    q = rec['q']\n"
        "    return 100.0 * np.isfinite(q['answered']).mean()\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "tiny2",
                             "file": "bench/configs/tiny2.json"})
    bench["workloads"].append({"name": "tiny2.rare", "config": "tiny2",
                               "traffic": "tiny-rare", "chips": 1,
                               "why": "test size"})
    bench["end_to_end"].append({"name": "answered_share", "unit": "%",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny2.rare"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    import time

    from bench import cell

    res = cell.run(root, "tiny2.rare", 3000000005, 1.0, False,
                   time.perf_counter(), device="cpu", log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["answered_share"]["value"] == 100.0
    assert "query_p50_ms" not in res["metrics"]   # listed for other cells


def test_benchmark_names_and_units():
    from bench import cell

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert (REPO / "bench/traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "bench/limits" / f"{w['name']}.json").exists()
    for c in bench["configs"]:
        names += c["reduced"]
        assert (REPO / c["file"]).exists() and c["file"].startswith("bench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert cell.metric_file(REPO / "bench", m["name"]).exists(), m
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len({*names}) >= len(set(names))
    assert len([c["name"] for c in bench["configs"]]) == len(
        {c["name"] for c in bench["configs"]})
    assert len(json.dumps(bench)) <= 64 * 1024


def test_breakdown_names_idle_time_by_each_threads_innermost_span():
    import threading

    from bench import run

    main = threading.main_thread().ident
    rec = {"window": (0.0, 5.0),
           "device_events": [("void admit_prologue_kernel<4, true>(float*)", 1.0, 2.0),
                             ("Memcpy DtoD (Device -> Device)", 3.0, 4.0)],
           "busy": [(1.0, 2.0), (3.0, 4.0)],
           "bench_spans": [("bench.ingest", 1.4, 2.6)],
           "program_spans": [("ingest.admit", 0.5, 3.5, {}, 7),
                             ("ingest.enqueue", 1.5, 2.5, {}, main),
                             ("query", 0.0, 5.0, {}, main)]}
    out = run.breakdown(rec)
    assert out["device_ops"] == [["admit_prologue_kernel", 1.0],
                                 ["Memcpy DtoD", 1.0]]
    assert out["idle_gaps"] == [["no span", 2.0],
                                ["ingest.admit+ingest.enqueue", 1.0]]
