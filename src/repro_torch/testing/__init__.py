"""Deterministic test/benchmark machinery that ships with the library.

``faults`` — seeded, named fault-injection points threaded through the
serving runtime and the durability layer, activated via context manager
(tests) or the ``REPRO_FAULTS`` env var (CI, benchmarks, launchers), so
every harness drives the exact same failure machinery.
"""
from repro_torch.testing import faults  # noqa: F401
