"""Tests of the benchmark. Those marked ``card`` need a CUDA card and skip
without one; the ``card`` fixture decides, never an import."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    import torch

    # the toy runs' CPU products: a few threads a test process, so that
    # several workers do not oversubscribe the cores
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"
