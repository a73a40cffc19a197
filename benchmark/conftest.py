"""pytest settings of the benchmark's own tests (``benchmark/tests``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (decided "
        "inside the test)")


def pytest_sessionstart(session):
    # several test workers on one host: few threads each, or their small
    # tensor ops contend for the cores
    import torch
    torch.set_num_threads(2)
