"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``.

They find what they need by name, as the harness does, so a new
configuration or generator brings its test files as files of its own:
``toy_sizes/<config>.json`` (its small sizes on the CPU),
``toy_mixes/<generator module>.json`` (the generator's small mix) and
``faults/<generator module>.py`` (its planted faults, ``FAULTS``, three or
more).  The cell, fault and reference tests are parametrised over
``BENCHMARK.json``.

The card-marked test runs on a machine with an NVIDIA GPU; elsewhere it
skips, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")
