"""The benchmark's own tests (CPU).  Tests marked ``cuda`` need an sm_90
card and skip where there is none; on the card they run with
``python3 -m pytest -p no:cacheprovider accord_bench/tests -m cuda``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an sm_90 CUDA card; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)
