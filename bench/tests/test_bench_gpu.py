"""On the card only: the device trace's operations land on the host's
clock, inside the host interval that launched and awaited them."""
from __future__ import annotations

import time

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace reads CUPTI")


@pytest.mark.gpu
def test_device_trace_lands_on_the_host_clock(cuda):
    from bench.trace import DeviceTrace, busy_union

    dt = DeviceTrace()
    dt.start()
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    time.sleep(0.05)
    t0 = time.perf_counter()
    for _ in range(20):
        x = x @ x * 1e-3
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = dt.stop()
    inside = [e for e in ev if e[1] >= t0 - 2e-4 and e[2] <= t1 + 2e-4]
    assert len(inside) >= 20
    busy = busy_union(ev, t0, t1)
    assert 0 < sum(b - a for a, b in busy) <= t1 - t0
