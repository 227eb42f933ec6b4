"""Ridge extraction from time-frequency planes (CWT / synchrosqueezed).

Counterpart of ``jwave_pro_tpu/ops/ridge.py``; same semantics and names.
Given a magnitude plane |Tx|(bin, t) (or a CWT scalogram), find the
curve(s) b(t) that maximize energy along the ridge subject to a smoothness
penalty — the penalized forward/backtrack dynamic program of the
synchrosqueezing literature (Meignen et al.).  The reference has no ridge
tier (its CWT stops at scalograms, ``ContinuousWaveletTransform.java``).

* The leading dimensions are flattened to one batch B; the forward pass
  loops over the N − 1 time steps, each a batched Bellman update
  ``E[l, t] = −U[l, t] + min_k (E[k, t−1] + λ·(l−k)²)`` over a (B, L, L)
  cost (one min with its argmin, the first minimum on ties, as
  ``jnp.argmin``).
* The backtrack loops over the stored (N − 1, B, L) argmin tables in
  reverse, one gather a step.
* Multiple ridges: extract, mask ``±mask_width`` bins around the found
  curve to −∞ (+∞ cost), repeat.

Both loops run on the tensor's device, some 2·N small launches a ridge.
Energy convention: ``U = log(|plane|² + eps)``.
"""
from __future__ import annotations

import typing

import torch

from ..utils.device import as_input

__all__ = ["RidgeResult", "extract_ridges"]


class RidgeResult(typing.NamedTuple):
    """Extracted ridges.

    ``indices``: (..., n_ridges, N) int32 — bin index per time step.
    ``frequencies``: (..., n_ridges, N) — bin frequency (or scale) values if
    an axis was provided, else a float copy of ``indices``.
    ``energy``: (..., n_ridges) — mean log-energy along each ridge (ridges
    come out strongest-first).
    """

    indices: torch.Tensor
    frequencies: torch.Tensor
    energy: torch.Tensor


def _ridge_once(u: torch.Tensor, penalty_mat: torch.Tensor) -> torch.Tensor:
    """Batched single-ridge DP: u (B, L, N) log-energy → (B, N) int64."""
    n = u.shape[-1]
    e = -u[..., 0]                                        # (B, L)
    args = []
    for t in range(1, n):
        # cost[b, k, l] = e[b, k] + penalty[k, l]
        best, arg = torch.min(e[:, :, None] + penalty_mat, dim=1)
        args.append(arg)
        e = best - u[..., t]
    path = [torch.argmin(e, dim=-1, keepdim=True)]        # (B, 1)
    for arg in reversed(args):
        path.append(torch.gather(arg, 1, path[-1]))
    return torch.cat(path[::-1], dim=-1)


def _extract_impl(u: torch.Tensor, n_ridges: int, penalty: float,
                  mask_width: int):
    l, n = u.shape[-2], u.shape[-1]
    lead = tuple(u.shape[:-2])
    cur = u.reshape((-1, l, n))
    # scale-free penalty: λ·(Δbin)² normalized by the bin count
    dl = torch.arange(l, dtype=u.dtype, device=u.device)
    pen = penalty * ((dl[:, None] - dl[None, :]) / l) ** 2 * l
    bins = torch.arange(l, device=u.device)[None, :, None]
    idxs, energies = [], []
    for _ in range(n_ridges):
        p = _ridge_once(cur, pen)                         # (B, N)
        idxs.append(p)
        energies.append(torch.mean(torch.gather(cur, 1, p[:, None, :])[:, 0],
                                   dim=-1))
        band = torch.abs(bins - p[:, None, :]) <= mask_width
        cur = torch.where(band, -torch.inf, cur)
    idx = torch.stack(idxs, dim=1).to(torch.int32)
    return (idx.reshape(lead + (n_ridges, n)),
            torch.stack(energies, dim=1).reshape(lead + (n_ridges,)))


def extract_ridges(plane, axis_values=None, n_ridges: int = 1,
                   penalty: float = 2.0, mask_width: int = 2,
                   eps: float = 1e-12) -> RidgeResult:
    """Extract ``n_ridges`` smooth maximum-energy curves from ``plane``.

    ``plane``: (..., L, N) — complex or real coefficients over (bin, time);
    pass ``SSQResult.Tx``, ``CWTResult.coefficients``, or any magnitude
    plane.  ``axis_values``: optional (L,) bin→frequency (or scale) map used
    to fill ``RidgeResult.frequencies`` (e.g. ``SSQResult.ssq_freqs``).
    ``penalty``: smoothness weight λ of the (Δbin/L)²·L transition cost —
    0 reduces to per-column argmax; larger values rigidify the curve.
    ``mask_width``: bins masked on each side of an extracted ridge before
    searching for the next one.  Batches over leading axes.
    """
    plane = as_input(plane)
    if plane.is_complex():
        mag2 = plane.real ** 2 + plane.imag ** 2
    else:
        rdt = (plane.dtype if plane.dtype in (torch.float32, torch.float64)
               else torch.float32)
        mag2 = plane.to(rdt) ** 2
    u = torch.log(mag2 + eps)
    if plane.ndim < 2:
        raise ValueError("plane must have shape (..., bins, time)")
    if not 1 <= int(n_ridges) <= plane.shape[-2]:
        raise ValueError(f"n_ridges must be in [1, {plane.shape[-2]}]")
    if (int(n_ridges) - 1) * (2 * int(mask_width) + 1) >= plane.shape[-2]:
        raise ValueError(
            f"n_ridges={n_ridges} with mask_width={mask_width} can mask all "
            f"{plane.shape[-2]} bins before the last ridge is extracted; "
            f"reduce one of them")
    idx, energy = _extract_impl(u, int(n_ridges), float(penalty),
                                int(mask_width))
    if axis_values is not None:
        vals = torch.as_tensor(axis_values, device=idx.device)
        freqs = vals[idx.long()]
    else:
        freqs = idx.to(u.dtype)
    return RidgeResult(indices=idx, frequencies=freqs, energy=energy)
