import pytest


@pytest.fixture
def card():
    """Skip a test that needs an NVIDIA GPU where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
