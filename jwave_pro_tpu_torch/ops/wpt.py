"""Wavelet Packet Transform (full binary tree) and best-basis selection.

Counterpart of ``jwave_pro_tpu/ops/wpt.py``; same semantics and names.
Reference: ``jwave/transforms/WaveletPacketTransform.java:73-189`` — at
each level every packet of width h is transformed by one filter-bank step;
packets live contiguously in the flat array, so level l holds 2^l packets
of width N/2^l in natural (Paley) order.  A level here is one batched step
over ``(..., packets, h)``; widths divisible by 256 run up to
``_fused_levels_limit`` levels of the whole tree as one banded matmul.

Best basis: the classic Coifman–Wickerhauser dynamic program over additive
information costs (the four below), with the JAX package's strict
``children < parent`` rule and bottom-up order, so ties resolve the same
way.  Masks are lists of bool tensors on the input's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import as_input, as_signal
from ..utils.profiling import spanned
from ..utils.validation import check_power_of_two
from ..wavelets.base import DiscreteWavelet
from .fwt import (_BLK, _const, _fused_levels_limit, _fused_synth_limit, _mm,
                  _resolve_level, _up, analysis_step, synthesis_step)

__all__ = [
    "wpt", "iwpt", "wpt2", "iwpt2", "wpt3", "iwpt3", "wpt_tree",
    "best_basis", "basis_coefficients", "basis_reconstruct",
    "wpt2_tree", "best_basis2", "basis_coefficients2", "basis_reconstruct2",
    "shannon_entropy_cost", "log_energy_cost", "threshold_cost", "sure_cost",
]


def _level_widths(n: int, level: int, twl: int):
    widths = []
    h = n
    lvl = 0
    while h >= max(twl, 2) and lvl < level:
        widths.append(h)
        h >>= 1
        lvl += 1
    return widths


def _paley_paths(lo, hi, levels: int):
    """Composite per-packet filters in Paley order: the children of path P
    are ``[P ⊛ (lo ↑ 2^i), P ⊛ (hi ↑ 2^i)]`` (index bit appended as LSB —
    the recursive ``[lo | hi]`` split of the flat layout)."""
    paths = [np.ones(1)]
    for i in range(levels):
        d = 1 << i
        paths = [np.convolve(p, _up(f, d)) for p in paths for f in (lo, hi)]
    return paths


@functools.lru_cache(maxsize=None)
def _wpt_analysis_matrix_fused(wavelet: DiscreteWavelet, levels: int
                               ) -> np.ndarray:
    """(2·BLK, BLK) constant running ``levels`` full-tree packet steps in
    one matmul: per input block the columns hold all 2^levels
    Paley-ordered segments (cnt = BLK/2^L each)."""
    paths = _paley_paths(np.asarray(wavelet.dec_lo, dtype=np.float64),
                         np.asarray(wavelet.dec_hi, dtype=np.float64),
                         levels)
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    cnt = _BLK >> levels
    for q, taps in enumerate(paths):
        for p in range(cnt):
            base = (1 << levels) * p
            for s, t in enumerate(taps):
                w[base + s, q * cnt + p] += t
    return w


@functools.lru_cache(maxsize=None)
def _wpt_synthesis_matrix_fused(wavelet: DiscreteWavelet, levels: int
                                ) -> np.ndarray:
    """(2·BLK, BLK) adjoint over the REC banks: rows index the (previous,
    current) block pair in segment-major order; every contribution passes
    ``levels`` synthesis steps, so the energy correction enters as
    ``correction^levels``."""
    paths = _paley_paths(np.asarray(wavelet.rec_lo, dtype=np.float64),
                         np.asarray(wavelet.rec_hi, dtype=np.float64),
                         levels)
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    cnt = _BLK >> levels
    scale = float(wavelet.energy_correction) ** levels
    for u in range(2 * _BLK):
        half, rem = divmod(u, _BLK)
        q, p_in = divmod(rem, cnt)
        p_rel = p_in - (cnt if half == 0 else 0)
        base = (1 << levels) * p_rel
        for s, tap in enumerate(paths[q]):
            t = base + s
            if 0 <= t < _BLK:
                w[u, t] += tap * scale
    return w


def _wpt_fused_step(x: torch.Tensor, wavelet: DiscreteWavelet, levels: int
                    ) -> torch.Tensor:
    """``levels`` tree levels on per-packet rows ``(..., h)`` in one pass."""
    h = x.shape[-1]
    k = h // _BLK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (k, _BLK))
    w = _const(_wpt_analysis_matrix_fused, wavelet, levels, like=x)
    out = _mm(xb, w[:_BLK]) + _mm(torch.roll(xb, -1, dims=-2), w[_BLK:])
    out = out.reshape(lead + (k, 1 << levels, _BLK >> levels))
    out = torch.swapaxes(out, -3, -2)          # segment-contiguous layout
    return out.reshape(lead + (h,))


def _wpt_fused_istep(y: torch.Tensor, wavelet: DiscreteWavelet, levels: int
                     ) -> torch.Tensor:
    """Inverse of :func:`_wpt_fused_step` (same per-packet rows)."""
    h = y.shape[-1]
    k = h // _BLK
    lead = y.shape[:-1]
    yb = y.reshape(lead + (1 << levels, k, _BLK >> levels))
    yb = torch.swapaxes(yb, -3, -2).reshape(lead + (k, _BLK))
    w = _const(_wpt_synthesis_matrix_fused, wavelet, levels, like=y)
    out = _mm(torch.roll(yb, 1, dims=-2), w[:_BLK]) + _mm(yb, w[_BLK:])
    return out.reshape(lead + (h,))


def wpt(x: torch.Tensor, wavelet: DiscreteWavelet, level=None
        ) -> torch.Tensor:
    """Forward WPT on the last axis to ``level`` (default: full depth).
    Integer input is transformed in torch's default float dtype."""
    x = as_signal(x)
    n = x.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    lead = x.shape[:-1]
    widths = _level_widths(n, level, wavelet.transform_wavelength)
    i = 0
    while i < len(widths):
        h = widths[i]
        lf = 1
        if h % _BLK == 0 and wavelet.length <= _BLK:
            lf = min(_fused_levels_limit(wavelet), len(widths) - i)
        xp = x.reshape(lead + (n // h, h))
        xp = (_wpt_fused_step(xp, wavelet, lf) if lf > 1
              else analysis_step(xp, wavelet))
        x = xp.reshape(lead + (n,))
        i += lf
    return x


def iwpt(y: torch.Tensor, wavelet: DiscreteWavelet, level=None
         ) -> torch.Tensor:
    """Inverse WPT (``WaveletPacketTransform.reverse``, ``:141-189``)."""
    y = as_signal(y)
    n = y.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    lead = y.shape[:-1]
    widths = _level_widths(n, level, wavelet.transform_wavelength)
    i = len(widths)
    while i > 0:
        lf = 1
        if wavelet.length <= _BLK:
            lf = min(_fused_synth_limit(wavelet), i)
            while lf > 1 and widths[i - lf] % _BLK != 0:
                lf -= 1
        h = widths[i - lf]  # chunk-top width
        yp = y.reshape(lead + (n // h, h))
        yp = (_wpt_fused_istep(yp, wavelet, lf) if lf > 1
              else synthesis_step(yp, wavelet))
        y = yp.reshape(lead + (n,))
        i -= lf
    return y


def wpt2(m: torch.Tensor, wavelet: DiscreteWavelet, level_rows=None,
         level_cols=None) -> torch.Tensor:
    """2D WPT: the packet transform along the last axis, then along the
    second-to-last (``BasicTransform.java:361-399``'s separable pattern)."""
    r = wpt(m, wavelet, level_cols)
    return torch.swapaxes(wpt(torch.swapaxes(r, -1, -2), wavelet,
                              level_rows), -1, -2)


def iwpt2(m: torch.Tensor, wavelet: DiscreteWavelet, level_rows=None,
          level_cols=None) -> torch.Tensor:
    """Inverse of :func:`wpt2`."""
    m = as_signal(m)
    r = torch.swapaxes(iwpt(torch.swapaxes(m, -1, -2), wavelet, level_rows),
                       -1, -2)
    return iwpt(r, wavelet, level_cols)


def wpt3(s: torch.Tensor, wavelet: DiscreteWavelet,
         levels=(None, None, None)) -> torch.Tensor:
    """3D WPT over the last three axes (``BasicTransform.java:509-566``'s
    generic dispatch applied to the packet engine)."""
    lp, lq, lr = levels
    s = wpt(s, wavelet, lr)                                   # last axis
    s = torch.swapaxes(wpt(torch.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    return torch.swapaxes(wpt(torch.swapaxes(s, -1, -3), wavelet, lp), -1, -3)


def iwpt3(s: torch.Tensor, wavelet: DiscreteWavelet,
          levels=(None, None, None)) -> torch.Tensor:
    """Inverse of :func:`wpt3` (``BasicTransform.java:602-659`` pattern)."""
    s = as_signal(s)
    lp, lq, lr = levels
    s = torch.swapaxes(iwpt(torch.swapaxes(s, -1, -3), wavelet, lp), -1, -3)
    s = torch.swapaxes(iwpt(torch.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    return iwpt(s, wavelet, lr)


@spanned("jwave.wpt.tree")
def wpt_tree(x: torch.Tensor, wavelet: DiscreteWavelet, level=None
             ) -> torch.Tensor:
    """Full packet tree: shape ``(level+1, ..., N)``.

    Row l is the WPT at depth l (row 0 = input).  Packet (l, p) occupies
    ``row[l][p·N/2^l : (p+1)·N/2^l]`` in natural order.
    """
    x = as_signal(x)
    n = x.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    lead = x.shape[:-1]
    rows = [x]
    for h in _level_widths(n, level, wavelet.transform_wavelength):
        xp = rows[-1].reshape(lead + (n // h, h))
        rows.append(analysis_step(xp, wavelet).reshape(lead + (n,)))
    return torch.stack(rows, dim=0)


# ---------------------------------------------------------------------------
# Information costs (additive, per Coifman–Wickerhauser 1992)
# ---------------------------------------------------------------------------

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


def _masks_on(masks, device) -> list:
    """Leaf masks as bool tensors on ``device`` (a caller may hand back
    NumPy arrays or lists)."""
    return [torch.as_tensor(m, dtype=torch.bool, device=device)
            for m in masks]


def best_basis(x: torch.Tensor, wavelet: DiscreteWavelet, level=None,
               cost: str = "shannon", per_sample: bool = False):
    """Coifman–Wickerhauser best-basis selection over the full WPT tree.

    Returns ``(masks, total_cost, tree)``: ``masks`` is a list over levels
    0..L of bool tensors of shape ``(2^l,)`` — True where packet (l, p) is
    a leaf of the optimal basis; ``tree`` is the full :func:`wpt_tree`.

    For batched input the cost is summed over leading axes, so one basis
    is chosen for the whole batch — unless ``per_sample=True``: the DP then
    runs vectorized over the batch and every sample gets its own basis
    (masks shaped ``(batch…, 2^l)``, cost ``(batch…,)``).
    :func:`basis_coefficients` and :func:`basis_reconstruct` accept both.
    """
    x = as_signal(x)
    n = x.shape[-1]
    level = _resolve_level(n, level, wavelet)
    level = min(level, len(_level_widths(n, level,
                                         wavelet.transform_wavelength)))
    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = wpt_tree(x, wavelet, level)
    masks, best = _select(tree, cost_fn, per_sample)
    return masks, best, tree


@spanned("jwave.wpt.basis")
def _select(tree: torch.Tensor, cost_fn, per_sample: bool):
    """The Coifman–Wickerhauser program over a :func:`wpt_tree`: per-packet
    costs, the bottom-up choice, the top-down leaf masks.  Returns
    ``(masks, total_cost)``."""
    level = tree.shape[0] - 1
    n = tree.shape[-1]
    lead = tree.shape[1:-1] if per_sample else ()

    # per-packet costs: costs[l] has shape (batch…,) + (2^l,)
    costs = []
    for l in range(level + 1):
        width = n >> l
        row = tree[l].reshape(lead + (1 << l, width) if per_sample
                              else (-1, 1 << l, width))
        c = cost_fn(row, axis=-1)
        costs.append(c if per_sample else torch.sum(c, dim=0))

    # bottom up: best[l][p] = min(cost[l][p], best[l+1][2p] + best[l+1][2p+1])
    best = costs[level]
    split = []  # split[l][p] True → descend into the children
    for l in range(level - 1, -1, -1):
        children = best.reshape(lead + (-1, 2)).sum(dim=-1)
        take_children = children < costs[l]
        split.append(take_children)
        best = torch.where(take_children, children, costs[l])
    split.reverse()

    # top down: a packet is a leaf iff every ancestor splits and it does not
    masks = []
    reach = torch.ones(lead + (1,), dtype=torch.bool, device=tree.device)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            reach = torch.repeat_interleave(reach & split[l], 2, dim=-1)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[..., 0]


@spanned("jwave.wpt.reconstruct")
def basis_reconstruct(flat: torch.Tensor, masks, wavelet: DiscreteWavelet
                      ) -> torch.Tensor:
    """Reconstruct the signal from a best-basis coefficient array.

    ``flat`` is the mixed-level representation from
    :func:`basis_coefficients`; ``masks`` the per-level leaf masks from
    :func:`best_basis`.  At each level a full synthesis pass runs and the
    masks select, per span, whether that span was represented deeper.
    """
    flat = as_signal(flat)
    n = flat.shape[-1]
    masks = _masks_on(masks, flat.device)
    level = len(masks) - 1
    lead = flat.shape[:-1]
    cur = flat
    for l in range(level, 0, -1):
        # active[pos] iff the leaf covering pos sits at level ≥ l
        active = torch.zeros((n,), dtype=torch.bool, device=flat.device)
        for lp in range(l, level + 1):
            active = active | torch.repeat_interleave(masks[lp], n >> lp,
                                                      dim=-1)
        width = n >> (l - 1)  # parent packet width after synthesis
        packets = cur.reshape(lead + (n // width, width))
        syn = synthesis_step(packets, wavelet).reshape(lead + (n,))
        cur = torch.where(active, syn, cur)
    return cur


def basis_coefficients(tree: torch.Tensor, masks) -> torch.Tensor:
    """Flatten a best-basis selection into one length-N coefficient array:
    each selected packet contributes its span of its tree row (the spans
    of a valid basis tile [0, N) exactly)."""
    tree = as_input(tree)
    masks = _masks_on(masks, tree.device)
    n = tree.shape[-1]
    out = torch.zeros_like(tree[0])
    for l, m in enumerate(masks):
        sel = torch.repeat_interleave(m, n >> l, dim=-1)
        out = torch.where(sel, tree[l], out)
    return out


# ---------------------------------------------------------------------------
# 2D best basis (quad-tree Coifman–Wickerhauser)
# ---------------------------------------------------------------------------

def _step2(x: torch.Tensor, wavelet: DiscreteWavelet, h_r: int, h_c: int
           ) -> torch.Tensor:
    """One quad-tree level: every (h_r, h_c) packet gets one separable
    analysis step on both axes."""
    lead = x.shape[:-2]
    r, c = x.shape[-2:]
    xp = x.reshape(lead + (r // h_r, h_r, c // h_c, h_c))
    xp = torch.swapaxes(xp, -3, -2)            # (..., pR, pC, hR, hC)
    xp = analysis_step(xp, wavelet)            # along hC
    xp = torch.swapaxes(xp, -1, -2)
    xp = analysis_step(xp, wavelet)            # along hR
    xp = torch.swapaxes(torch.swapaxes(xp, -1, -2), -3, -2)
    return xp.reshape(lead + (r, c))


def _synth2(x: torch.Tensor, wavelet: DiscreteWavelet, h_r: int, h_c: int
            ) -> torch.Tensor:
    """Inverse of :func:`_step2` at packet size (h_r, h_c)."""
    lead = x.shape[:-2]
    r, c = x.shape[-2:]
    xp = x.reshape(lead + (r // h_r, h_r, c // h_c, h_c))
    xp = torch.swapaxes(torch.swapaxes(xp, -3, -2), -1, -2)
    xp = synthesis_step(xp, wavelet)           # along hR
    xp = torch.swapaxes(xp, -1, -2)
    xp = synthesis_step(xp, wavelet)           # along hC
    xp = torch.swapaxes(xp, -3, -2)
    return xp.reshape(lead + (r, c))


def _resolve_level2(r: int, c: int, level, wavelet: DiscreteWavelet) -> int:
    lv_r = len(_level_widths(r, r.bit_length(), wavelet.transform_wavelength))
    lv_c = len(_level_widths(c, c.bit_length(), wavelet.transform_wavelength))
    lv = min(lv_r, lv_c)
    if level is None:
        return lv
    level = int(level)
    if not 1 <= level <= lv:
        raise ValueError(
            f"level {level} out of range [1, {lv}] for shape ({r}, {c}) "
            f"with {wavelet.name}")
    return level


def wpt2_tree(x: torch.Tensor, wavelet: DiscreteWavelet, level=None
              ) -> torch.Tensor:
    """Full 2D packet quad tree: shape ``(level+1, ..., R, C)``.

    Row l is the depth-l quad-tree 2D WPT (both axes at equal depth).
    Packet (l, i, j) occupies the block ``row[l][i·R/2^l:(i+1)·R/2^l,
    j·C/2^l:(j+1)·C/2^l]``.
    """
    x = as_signal(x)
    r, c = x.shape[-2], x.shape[-1]
    check_power_of_two(r)
    check_power_of_two(c)
    level = _resolve_level2(r, c, level, wavelet)
    rows = [x]
    for l in range(level):
        rows.append(_step2(rows[-1], wavelet, r >> l, c >> l))
    return torch.stack(rows, dim=0)


def best_basis2(x: torch.Tensor, wavelet: DiscreteWavelet, level=None,
                cost: str = "shannon", per_sample: bool = False):
    """Quad-tree Coifman–Wickerhauser best basis for images.

    Returns ``(masks, total_cost, tree)``: ``masks[l]`` is a bool
    ``(2^l, 2^l)`` grid — True where packet (l, i, j) is a leaf of the
    optimal basis; ``tree`` the :func:`wpt2_tree`.  A batch selects one
    basis (costs summed over leading axes) unless ``per_sample=True``:
    every image then gets its own basis (masks ``(batch…, 2^l, 2^l)``).
    """
    x = as_signal(x)
    r, c = x.shape[-2], x.shape[-1]
    level = _resolve_level2(r, c, level, wavelet)
    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = wpt2_tree(x, wavelet, level)
    lead = x.shape[:-2] if per_sample else ()

    costs = []
    for l in range(level + 1):
        hr, hc = r >> l, c >> l
        head = lead if per_sample else (-1,)
        row = tree[l].reshape(head + (1 << l, hr, 1 << l, hc))
        blocks = torch.swapaxes(row, -3, -2)     # (…, 2^l, 2^l, hr, hc)
        flat = blocks.reshape(blocks.shape[:-2] + (hr * hc,))
        cst = cost_fn(flat, axis=-1)             # (…, 2^l, 2^l)
        costs.append(cst if per_sample else torch.sum(cst, dim=0))

    best = costs[level]
    split = []
    for l in range(level - 1, -1, -1):
        p = 1 << l
        children = best.reshape(lead + (p, 2, p, 2)).sum(dim=(-3, -1))
        take = children < costs[l]
        split.append(take)
        best = torch.where(take, children, costs[l])
    split.reverse()

    masks = []
    reach = torch.ones(lead + (1, 1), dtype=torch.bool, device=x.device)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            nxt = reach & split[l]
            reach = torch.repeat_interleave(
                torch.repeat_interleave(nxt, 2, dim=-2), 2, dim=-1)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[..., 0, 0], tree


def _mask_to_pixels2(mask: torch.Tensor, r: int, c: int) -> torch.Tensor:
    # batched (per-sample) masks keep their leading axes
    p = mask.shape[-1]
    return torch.repeat_interleave(
        torch.repeat_interleave(mask, r // p, dim=-2), c // p, dim=-1)


def basis_coefficients2(tree: torch.Tensor, masks) -> torch.Tensor:
    """Flatten a 2D best-basis selection into one (..., R, C) array."""
    tree = as_input(tree)
    masks = _masks_on(masks, tree.device)
    r, c = tree.shape[-2], tree.shape[-1]
    out = torch.zeros_like(tree[0])
    for l, m in enumerate(masks):
        out = torch.where(_mask_to_pixels2(m, r, c), tree[l], out)
    return out


def basis_reconstruct2(flat: torch.Tensor, masks, wavelet: DiscreteWavelet
                       ) -> torch.Tensor:
    """Reconstruct the image from a 2D best-basis coefficient array."""
    flat = as_signal(flat)
    masks = _masks_on(masks, flat.device)
    r, c = flat.shape[-2], flat.shape[-1]
    level = len(masks) - 1
    cur = flat
    for l in range(level, 0, -1):
        active = torch.zeros((r, c), dtype=torch.bool, device=flat.device)
        for lp in range(l, level + 1):
            active = active | _mask_to_pixels2(masks[lp], r, c)
        syn = _synth2(cur, wavelet, r >> (l - 1), c >> (l - 1))
        cur = torch.where(active, syn, cur)
    return cur
