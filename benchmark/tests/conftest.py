"""CPU tests of the benchmark (python -m pytest benchmark/tests -q); the
`cuda` ones run a cell on the card and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
