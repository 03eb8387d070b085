"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository.  Tests marked ``cuda`` need an NVIDIA card and skip
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
