"""The benchmark's own tests. ``card`` marks a test that needs a CUDA card;
the ``card`` fixture skips it elsewhere (decided when the test runs, never
at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
