import pytest
import torch


@pytest.fixture
def cuda_card():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
