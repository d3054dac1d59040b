import pytest


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU through torch.cuda")
    return torch.device("cuda")
