"""The port's streaming data pipeline (``repro_torch/data/pipeline.py``)
and its training launcher (``python -m repro_torch.launch.train``) on the
CPU: the prefetch queue sheds its oldest batch when the consumer lags, an
``OffsetTracker`` round-trips its state, ``skip_to`` lands on the batch
the reference's does; the launcher trains with ``--device cpu``, prints
the reference launcher's lines and resumes on a second run, without
``--ckpt-dir`` it starts fresh in a new directory each run, and without a
card and without ``--device cpu`` it exits non-zero."""
import itertools
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.data.pipeline import skip_to as j_skip_to
from repro.data.streams import make_stream as j_make_stream
from repro_torch.data.pipeline import OffsetTracker, PrefetchLoader, skip_to
from repro_torch.data.streams import make_stream

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _wait(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.01)


def test_prefetch_loader_drops_the_oldest():
    counter = itertools.count()
    loader = PrefetchLoader(lambda: {"i": next(counter)}, depth=2)
    try:
        _wait(lambda: loader.dropped >= 3)
        first = next(loader)["i"]
        # the queue holds the newest two: everything older was shed
        assert first >= loader.dropped >= 3
        assert next(loader)["i"] > first
    finally:
        loader.close()


def test_prefetch_loader_without_drops_keeps_every_batch_in_order():
    counter = itertools.count()
    loader = PrefetchLoader(lambda: {"i": next(counter)}, depth=2, drop_oldest=False)
    try:
        _wait(lambda: len(loader._q) == 2)
        assert [next(loader)["i"] for _ in range(5)] == [0, 1, 2, 3, 4]
        assert loader.dropped == 0
    finally:
        loader.close()


def test_offset_tracker_state_round_trip():
    t = OffsetTracker()
    t.advance(64)
    t.advance(32)
    u = OffsetTracker()
    u.load_state_dict(t.state_dict())
    assert u.offset == t.offset == 96 and u.state_dict() == {"offset": 96}


@pytest.mark.parametrize("offset,batch", [(64, 32), (70, 32), (0, 16)])
def test_skip_to_matches_reference(offset, batch):
    a = skip_to(make_stream("nyt", dim=16), offset=offset, batch=batch).next_batch(32)
    b = j_skip_to(j_make_stream("nyt", dim=16), offset=offset, batch=batch).next_batch(32)
    for k in ("embedding", "topic", "doc_id"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    if offset % batch == 0:   # the stream read batch by batch from the start
        seq = make_stream("nyt", dim=16)
        want = [seq.next_batch(batch) for _ in range(offset // batch)] + [seq.next_batch(32)]
        np.testing.assert_allclose(a["embedding"], want[-1]["embedding"], rtol=1e-6)


def _launch(*flags, env_extra=None):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), **(env_extra or {})}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *flags],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)


def test_launcher_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _launch("--arch", "fm", "--steps", "4", "--device", "cpu", "--ckpt-dir", ckpt,
                  "--ckpt-interval", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "final checkpoint: 4", lines
    assert lines[-2].startswith("step 4: loss=") and "steps/s)" in lines[-2]
    assert np.isfinite(float(lines[-2].split("loss=")[1].split()[0]))
    saved = {n: os.stat(os.path.join(ckpt, n)).st_mtime_ns for n in os.listdir(ckpt)}
    again = _launch("--arch", "fm", "--steps", "6", "--device", "cpu", "--ckpt-dir", ckpt,
                    "--ckpt-interval", "2")
    assert again.returncode == 0, again.stderr[-3000:]
    steps = [ln.split(":")[0] for ln in again.stdout.splitlines() if ln.startswith("step ")]
    assert steps == ["step 6"] and again.stdout.splitlines()[-1] == "final checkpoint: 6"
    # the second run resumed at step 4: it wrote step 6 alone, and left
    # steps 2 and 4 as the first run wrote them
    after = {n: os.stat(os.path.join(ckpt, n)).st_mtime_ns for n in os.listdir(ckpt)}
    assert sorted(saved) == ["step_000000000002", "step_000000000004"]
    assert sorted(after) == sorted(saved) + ["step_000000000006"]
    assert all(after[n] == saved[n] for n in saved)


def test_launcher_without_a_directory_starts_fresh_each_run(tmp_path):
    """No ``--ckpt-dir``: each run checkpoints into a new directory under
    the temp dir, printed first, and trains from step 0."""
    dirs = []
    for _ in range(2):
        out = _launch("--arch", "fm", "--steps", "2", "--device", "cpu", "--ckpt-interval", "1",
                      env_extra={"TMPDIR": str(tmp_path)})
        assert out.returncode == 0, out.stderr[-3000:]
        lines = out.stdout.splitlines()
        assert lines[0].startswith("checkpoints in ") and lines[-1] == "final checkpoint: 2"
        dirs.append(lines[0].split("checkpoints in ", 1)[1])
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert os.path.dirname(d) == str(tmp_path)
        assert sorted(os.listdir(d)) == ["step_000000000001", "step_000000000002"]


def test_launcher_refuses_to_run_without_a_card(tmp_path):
    out = _launch("--arch", "fm", "--steps", "1", "--ckpt-dir", str(tmp_path),
                  env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "no CUDA device" in out.stderr
