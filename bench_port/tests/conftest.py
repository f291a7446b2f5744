"""The benchmark's own tests (CPU, and `cuda` ones that skip without a
card). Run from the repository root:

    python -m pytest bench_port/tests -q            # CPU
    python -m pytest bench_port/tests -q -m cuda    # on a card
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda:0"
