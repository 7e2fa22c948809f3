import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """Skips the test on a machine without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card with "
                    "`python -m pytest mmrp_bench/tests -m cuda`")
