"""The ``cuda`` fixture of the benchmark's tests that need a card."""
from __future__ import annotations

import pytest


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
