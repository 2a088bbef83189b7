"""Thread safety of the port's kernel build: two or more threads that
reach their first launch together (an ``AsyncServer``'s ingest and query
threads) must start one ``nvcc`` per source between them, not one each.
``nvcc`` and ``ctypes.CDLL`` are replaced by recording fakes, so this
runs without a compiler or a card."""
import ctypes
import sys
import threading
import time
import types

import pytest

from repro_torch.kernels import build


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.repro_error_string = types.SimpleNamespace(argtypes=None, restype=None)


@pytest.mark.parametrize("n_threads", [2, 8])
def test_concurrent_loads_compile_each_source_once(tmp_path, monkeypatch, n_threads):
    compiled = []
    rec_lock = threading.Lock()

    class FakePopen:
        """Records the source; ``communicate`` takes a while (so a second
        thread would start its own compile meanwhile) and writes the
        output file nvcc would."""

        def __init__(self, cmd, **kw):
            with rec_lock:
                compiled.append(cmd[-1])
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = None

        def communicate(self):
            time.sleep(0.05)
            with open(self.out, "wb"):
                pass
            self.returncode = 0
            return "", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_BUILT", {})
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=_FakeLib, c_int=ctypes.c_int, c_char_p=ctypes.c_char_p))
    names = [build.SOURCES[i % len(build.SOURCES)] for i in range(n_threads)]
    start = threading.Barrier(n_threads)
    got, errors = {}, []

    def first_launch(i, name):
        try:
            start.wait(timeout=10)
            got[i] = build.load(name)
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_launch, args=(i, n))
                   for i, n in enumerate(names)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(compiled) == sorted(str(build.CSRC / f"{n}.cu") for n in build.SOURCES)
    for i, name in enumerate(names):
        assert got[i] is build._LIBS[name]
        assert got[i].path.endswith(".so") and f"lib{name}-" in got[i].path
