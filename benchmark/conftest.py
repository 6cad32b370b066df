"""pytest settings of the benchmark's own tests (`benchmark/tests/`):
its folders on the import path, and the `card` marker of the tests that
need an NVIDIA card, which skip where there is none (the fixture
`card` decides, when the test runs)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.join(HERE, "tests"), os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where torch sees "
        "no CUDA device")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")
