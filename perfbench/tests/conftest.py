"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``.

The card-marked test runs on a machine with an NVIDIA GPU; elsewhere it
skips, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")
