"""Where a public entry point puts its input."""
from __future__ import annotations

import torch

__all__ = ["as_input"]


def as_input(x) -> torch.Tensor:
    """A signal or coefficient argument as a tensor.

    A ``torch.Tensor`` stays on its own device: the caller chose it.
    Anything else (a NumPy array, a list, a number) becomes a tensor on
    ``torch.device("cuda")``, as the JAX package puts such an input on its
    default device.  There is no check for a card first: without one,
    torch's own error is raised, and nothing silently runs on the CPU.
    """
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=torch.device("cuda"))
