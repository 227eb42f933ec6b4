"""Additive information costs of the wavelet packet best basis.

Counterpart of the cost functions of ``jwave_pro_tpu/ops/wpt.py``
(``:267-301``, Coifman–Wickerhauser 1992), which
:func:`ops.modwpt.modwpt_best_basis` uses.  The decimated packet transform
itself is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["shannon_entropy_cost", "log_energy_cost", "threshold_cost",
           "sure_cost"]


def shannon_entropy_cost(c: torch.Tensor, axis=-1) -> torch.Tensor:
    """-Σ c² ln c² (0·ln 0 := 0)."""
    c2 = c * c
    safe = torch.where(c2 > 0, c2, 1.0)
    return -torch.sum(torch.where(c2 > 0, c2 * torch.log(safe), 0.0), dim=axis)


def log_energy_cost(c: torch.Tensor, axis=-1) -> torch.Tensor:
    """Σ ln c² (0 term := 0)."""
    c2 = c * c
    safe = torch.where(c2 > 0, c2, 1.0)
    return torch.sum(torch.where(c2 > 0, torch.log(safe), 0.0), dim=axis)


def threshold_cost(c: torch.Tensor, axis=-1, *, threshold=1e-6
                   ) -> torch.Tensor:
    """Count of |c| above threshold (sparsity cost)."""
    return torch.sum((torch.abs(c) > threshold).to(c.dtype), dim=axis)


def sure_cost(c: torch.Tensor, axis=-1, *, threshold=1.0) -> torch.Tensor:
    """Stein's unbiased risk estimate for soft thresholding at ``threshold``."""
    n = c.shape[axis]
    c2 = c * c
    t2 = threshold * threshold
    risk = torch.sum(torch.clamp_max(c2, t2), dim=axis)
    n_small = torch.sum((c2 <= t2).to(c.dtype), dim=axis)
    return n - 2.0 * n_small + risk


_COSTS = {
    "shannon": shannon_entropy_cost,
    "logenergy": log_energy_cost,
    "threshold": threshold_cost,
    "sure": sure_cost,
}
