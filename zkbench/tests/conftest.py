"""CPU tests of the benchmark. They are not part of the repository's tier-1
run (`tests/`): run them with `python -m pytest zkbench/tests -q`.

Tests that need a CUDA card carry the `card` marker and skip without one;
whether there is a card is decided inside the `card` fixture, never while a
module is imported.
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
