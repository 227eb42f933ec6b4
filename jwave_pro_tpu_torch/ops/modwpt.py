"""Maximal-Overlap Discrete Wavelet Packet Transform (MODWPT), 1D, 2D and 3D,
in PyTorch.

Counterpart of ``jwave_pro_tpu/ops/modwpt.py``; same semantics and names.
The shift-invariant analog of the wavelet packet
transform (Percival & Walden 2000, §6.1): the MODWT's filter pipeline
(unit-L2-normalized banks ÷ √2, ``MODWTTransform.java:452-484``), à-trous
dilation per level and circular boundary, applied to every node of the full
binary tree.

Sequency (frequency) ordering: node n at level j is produced from parent
⌊n/2⌋ by the *scaling* filter g̃ when ``n mod 4 ∈ {0, 3}`` and the *wavelet*
filter h̃ when ``n mod 4 ∈ {1, 2}``, so node n covers the frequency band
``[n, n+1) · fs / 2^(j+1)``.  As a permutation of the natural (filter-order)
tree this is ``nat = n XOR ((n >> 1) & 1)``, an involution shared by both
directions.

A level is one batched pair-convolution: all 2^(j-1) parents stack on the
leading axis and the (g̃, h̃) dilated circular convolutions share every
rolled copy (``ops.modwt._conv_channels``); the sequency reorder is one
index.  On a CUDA float32/bfloat16 tensor, ``method='auto'`` sends the
shapes the kernels support to the fused CUDA kernels
(``kernels/modwpt_cuda.py``); float64 and unsupported shapes take the plain
path below.  The 2D quad tree and the 3D oct tree run as two and three
big-batch 1D packet transforms (the orthogonal-axis samples flattened into
the batch), so they reach the same kernels.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import as_input
from ..wavelets.base import DiscreteWavelet
from .modwt import (
    _as_signal, _check_level, _combined_adjoint, _composite_shape,
    _level_conv, _spectral, _use_fft, _wrapped_filter_fft,
    modwt_base_filters, taps_as,
)

__all__ = [
    "modwpt", "imodwpt", "modwpt_tree", "modwpt_mra",
    "modwpt_best_basis", "modwpt_basis_reconstruct", "modwpt_node_path",
    "modwpt2", "imodwpt2", "modwpt2_tree", "modwpt2_best_basis",
    "modwpt2_basis_reconstruct", "modwpt3", "imodwpt3",
]


def _seq_perm(num_children: int) -> np.ndarray:
    """Sequency↔natural child permutation (involution): ``n ^ ((n>>1)&1)``."""
    n = np.arange(num_children)
    return n ^ ((n >> 1) & 1)


def modwpt_node_path(level: int, node: int) -> list[str]:
    """Filter path ('g'/'h' per level, root first) producing ``(level, node)``.

    Follows the sequency rule above; useful for interpreting which cascade
    of low/high-pass branches a packet corresponds to.
    """
    if not 0 <= node < (1 << level):
        raise ValueError(f"node {node} out of range for level {level}")
    path = []
    m = node
    for _ in range(level):
        path.append("g" if m % 4 in (0, 3) else "h")
        m //= 2
    return list(reversed(path))


def _try_kernel(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                inverse: bool = False):
    """Dispatch to the fused CUDA kernel when device, dtype and shape allow.

    Decided from device, dtype and shape before any launch: float64 and
    shapes :func:`kernels.modwt_cuda.kernel_supported` rejects return None
    (the plain path), as ``_try_pallas`` sends them to XLA.  Once decided,
    the call goes straight to the autograd pair.
    """
    from ..kernels import modwpt_cuda as kp
    from ..kernels._launch import DTYPE_CODES
    from ..kernels.modwt_cuda import kernel_supported

    # inverse: (2^L, B, N) or (2^L, N); forward: (B, N) or (N,)
    if (not x.is_cuda or x.dtype not in DTYPE_CODES
            or x.ndim not in ((2, 3) if inverse else (1, 2))):
        return None
    # a differentiable call also needs the other direction's kernel, which
    # is its backward
    kinds = ("pinv", "pfwd") if inverse else ("pfwd", "pinv")
    if not all(kernel_supported(x.shape[-1], level, wavelet.length, kind)
               for kind in kinds[:1 + x.requires_grad]):
        return None
    return (kp.ImodwptFused.apply(x, wavelet) if inverse
            else kp.ModwptFused.apply(x, wavelet, level))


@functools.lru_cache(maxsize=64)
def _composite_packet_multipliers(wavelet: DiscreteWavelet, level: int,
                                  n: int):
    """The whole packet cascade as one (2^level, F) multiplier stack.

    Replays :func:`_level_forward`'s recursion (child stack + sequency
    permutation) on host-side complex128 spectral multipliers — circular
    convolutions compose on the DFT grid, so the stack equals the per-level
    FFT cascade while costing 1 rfft + 1 batched irfft (the packet analog of
    ``ops.modwt._composite_fft_multipliers``).
    """
    g, h = modwt_base_filters(wavelet)
    mults = np.ones((1, n // 2 + 1), dtype=np.complex128)
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        gf = _wrapped_filter_fft(g, d, n)
        hf = _wrapped_filter_fft(h, d, n)
        nat = np.stack([mults * gf, mults * hf], axis=1)
        nat = nat.reshape(2 * mults.shape[0], -1)
        mults = nat[_seq_perm(nat.shape[0])]
    return mults


def _seq_index(count: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_seq_perm(count)).to(device)


def _level_forward(parents: torch.Tensor, g, h, j: int, method: str
                   ) -> torch.Tensor:
    """(P, ..., N) level-(j-1) nodes → (2P, ..., N) level-j nodes (sequency)."""
    gv, hv = _level_conv(parents, g, h, j, method)
    nat = torch.stack([gv, hv], dim=1)             # (P, 2, ..., N)
    nat = nat.reshape((2 * parents.shape[0],) + tuple(parents.shape[1:]))
    return nat[_seq_index(nat.shape[0], nat.device)]


def _level_inverse(children: torch.Tensor, g, h, j: int, method: str
                   ) -> torch.Tensor:
    """(2P, ..., N) level-j nodes (sequency) → (P, ..., N) parents."""
    nat = children[_seq_index(children.shape[0], children.device)]
    child_g, child_h = nat[0::2], nat[1::2]
    n = children.shape[-1]
    d = 1 << (j - 1)
    if _use_fft(method, n, g.shape[0], d):
        va, wa = _level_conv(child_g, g, h, j, method, adjoint=True,
                             w=child_h)
        return va + wa
    return _combined_adjoint(child_g, child_h, taps_as(g, children.dtype),
                             taps_as(h, children.dtype), d)


def modwpt(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
           method: str = "auto") -> torch.Tensor:
    """Forward MODWPT on the last axis: ``(..., N) → (2^level, ..., N)``.

    Node axis is sequency-ordered (node n ≈ band ``[n, n+1)·fs/2^(level+1)``).
    Works for arbitrary (non-pow2) N; every level preserves energy
    (``Σ_n ‖W_{level,n}‖² = ‖x‖²``).  Node 0 equals the MODWT's V_level and
    node 1 its W_level.  The result lies on ``x``'s device.

    ``method``: 'direct' (dilated à-trous conv), 'fft', 'pallas' (the fused
    CUDA kernel; the JAX package's spelling — raises where the kernel cannot
    run), 'auto' (fused kernel for CUDA f32/bf16 input when the shape
    allows, else the cost model), or 'auto_reference' — the
    :func:`..modwt.modwt` convolution engines.
    """
    x = _as_signal(x)
    _check_level(x.shape[-1], level)
    if method in ("auto", "pallas"):
        out = _try_kernel(x, wavelet, level)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused kernel unavailable for shape {tuple(x.shape)} dtype "
                f"{x.dtype} on device {x.device}")
        method = "auto"
    g, h = modwt_base_filters(wavelet)
    n = x.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        xf = torch.fft.rfft(x)
        mult = _composite_shape(_spectral(
            _composite_packet_multipliers(wavelet, level, n), xf), x.ndim - 1)
        return torch.fft.irfft(xf[None] * mult, n=n).to(x.dtype)
    nodes = x[None]
    for j in range(1, level + 1):
        nodes = _level_forward(nodes, g, h, j, method)
    return nodes


def imodwpt(coeffs: torch.Tensor, wavelet: DiscreteWavelet,
            method: str = "auto") -> torch.Tensor:
    """Inverse MODWPT: ``(2^level, ..., N) → (..., N)``.

    Adjoint cascade (the packet analog of ``MODWTTransform.inverseMODWT``,
    ``:337-375``): each parent is the sum of its two children's adjoint
    convolutions, filters assigned by the same sequency rule.
    """
    coeffs = as_input(coeffs)
    p = coeffs.shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(
            f"leading axis must be 2^level ≥ 2 packet nodes, got {p}")
    level = p.bit_length() - 1
    if method in ("auto", "pallas"):
        out = _try_kernel(coeffs, wavelet, level, inverse=True)
        if out is not None:
            return out
        if method == "pallas":
            raise ValueError(
                f"fused kernel unavailable for shape {tuple(coeffs.shape)} "
                f"dtype {coeffs.dtype} on device {coeffs.device}")
        method = "auto"
    g, h = modwt_base_filters(wavelet)
    n = coeffs.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        cf = torch.fft.rfft(coeffs)
        mult = _composite_shape(_spectral(np.conj(
            _composite_packet_multipliers(wavelet, level, n)), cf),
            coeffs.ndim - 2)
        return torch.fft.irfft(torch.sum(cf * mult, dim=0),
                               n=n).to(coeffs.dtype)
    nodes = coeffs
    for j in range(level, 0, -1):
        nodes = _level_inverse(nodes, g, h, j, method)
    return nodes[0]


def modwpt_tree(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                method: str = "direct") -> list[torch.Tensor]:
    """Full packet tree: list over levels 0..level of ``(2^l, ..., N)``.

    Row 0 is the input (one node); row l the sequency-ordered level-l nodes.
    Levels are nested analyses of the same signal (each preserves energy),
    so additive information costs are comparable across levels — the
    precondition for :func:`modwpt_best_basis`.
    """
    x = _as_signal(x)
    _check_level(x.shape[-1], level)
    g, h = modwt_base_filters(wavelet)
    rows = [x[None]]
    for j in range(1, level + 1):
        rows.append(_level_forward(rows[-1], g, h, j, method))
    return rows


def modwpt_mra(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
               method: str = "direct") -> torch.Tensor:
    """Per-node additive components: ``(2^level, ..., N)`` with Σ_n D_n = x.

    Component n is the adjoint cascade applied to node n alone (its unique
    root path), the packet analog of :func:`..modwt.modwt_mra` / MATLAB's
    ``modwptdetails``.  Batched: at adjoint level j every node's branch
    filter is fixed (g̃ when its level-j ancestor ``m = n >> (level-j)`` has
    ``m mod 4 ∈ {0, 3}``, else h̃), so one shared-roll pair-convolution over
    all 2^level components plus a per-node select replaces a per-node loop.
    """
    nodes = modwpt(x, wavelet, level, method)
    g, h = modwt_base_filters(wavelet)
    p = 1 << level
    comps = nodes
    for j in range(level, 0, -1):
        m = np.arange(p) >> (level - j)
        use_g = (m % 4 == 0) | (m % 4 == 3)
        cg, ch = _level_conv(comps, g, h, j, method, adjoint=True)
        sel = torch.from_numpy(use_g).to(comps.device).reshape(
            (p,) + (1,) * (comps.ndim - 1))
        comps = torch.where(sel, cg, ch)
    return comps


def modwpt_best_basis(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                      cost: str = "shannon", method: str = "direct"):
    """Coifman–Wickerhauser best basis over the shift-invariant packet tree.

    Returns ``(masks, total_cost, tree)``: ``masks[l]`` is a boolean
    ``(2^l,)`` tensor — True where node (l, n) is a leaf of the optimal
    basis; ``tree`` the :func:`modwpt_tree` list.  Costs are additive and
    every level preserves energy; node costs are whole-node costs over all
    N samples.  Batched input selects one basis for the whole batch.
    ``cost`` is a name of ``ops.wpt._COSTS`` or a callable ``f(c, axis=-1)``.
    """
    from .wpt import _COSTS

    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = modwpt_tree(x, wavelet, level, method)

    costs = []
    for l in range(level + 1):
        row = tree[l]                                    # (2^l, ..., N)
        costs.append(cost_fn(row.reshape(row.shape[0], -1), axis=-1))

    best = costs[level]
    split = []
    for l in range(level - 1, -1, -1):
        children = best.reshape(-1, 2).sum(dim=-1)
        take = children < costs[l]
        split.append(take)
        best = torch.where(take, children, costs[l])
    split.reverse()

    masks = []
    reach = torch.ones(1, dtype=torch.bool, device=best.device)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            reach = torch.repeat_interleave(reach & split[l], 2)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[0], tree


def modwpt_basis_reconstruct(tree, masks, wavelet: DiscreteWavelet,
                             method: str = "direct") -> torch.Tensor:
    """Reconstruct the signal from a best-basis selection.

    ``tree`` from :func:`modwpt_tree`, ``masks`` from
    :func:`modwpt_best_basis`.  Bottom-up: non-leaf deep nodes carry the
    running partial inverses; at each level the leaf nodes' own
    coefficients are added in (the adjoint is linear, so zeroed non-leaves
    contribute nothing).
    """
    level = len(masks) - 1
    g, h = modwt_base_filters(wavelet)

    def mask_mul(row, m):
        shape = (row.shape[0],) + (1,) * (row.ndim - 1)
        return row * torch.as_tensor(m, device=row.device).reshape(
            shape).to(row.dtype)

    cur = mask_mul(tree[level], masks[level])
    for l in range(level, 0, -1):
        parents = _level_inverse(cur, g, h, l, method)
        cur = parents + mask_mul(tree[l - 1], masks[l - 1])
    return cur[0]


# ---------------------------------------------------------------------------
# 2D MODWPT — shift-invariant quad-tree (tensor product of two 1D trees)
# ---------------------------------------------------------------------------

def modwpt2(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
            method: str = "auto") -> torch.Tensor:
    """2D MODWPT: ``(..., R, C) → (2^level, 2^level, ..., R, C)``.

    The undecimated quad tree: separability makes it the tensor product of
    two 1D packet trees, so node ``(n_r, n_c)`` applies the row cascade of
    1D node ``n_r`` and the column cascade of node ``n_c`` — both axes
    sequency-ordered.  Node (0, 0) equals the 2D MODWT's LL_level.  Exactly
    shift-invariant in both axes; every level preserves energy.

    Computed as two big-batch 1D transforms (rows, then columns, the
    orthogonal-axis samples flattened into the batch), so the fused packet
    kernel runs both passes under ``method='auto'`` on a CUDA f32/bf16
    tensor.  The result is a view with the node axes swapped into place.
    """
    x = _as_signal(x)
    if x.ndim < 2:
        raise ValueError("modwpt2 needs at least 2 dims (..., R, C)")
    *lead, r, c = x.shape
    _check_level(r, level)
    _check_level(c, level)
    p = 1 << level
    xt = x.swapaxes(-1, -2).reshape(-1, r)               # (B·C, R)
    nr = modwpt(xt, wavelet, level, method)              # (P, B·C, R)
    nr = nr.reshape([p] + lead + [c, r]).swapaxes(-1, -2)
    nc = modwpt(nr.reshape(-1, c), wavelet, level, method)   # (P, P·B·R, C)
    nc = nc.reshape([p, p] + lead + [r, c])              # (n_col, n_row, ...)
    return nc.swapaxes(0, 1)


def imodwpt2(coeffs: torch.Tensor, wavelet: DiscreteWavelet,
             method: str = "auto") -> torch.Tensor:
    """Inverse 2D MODWPT: ``(2^level, 2^level, ..., R, C) → (..., R, C)``."""
    coeffs = as_input(coeffs)
    if coeffs.ndim < 4:
        raise ValueError("imodwpt2 expects (nodes_r, nodes_c, ..., R, C)")
    pr, pc = coeffs.shape[0], coeffs.shape[1]
    if pr != pc or pr < 2 or pr & (pr - 1):
        raise ValueError(
            f"leading node axes must be equal powers of two ≥ 2, got "
            f"({pr}, {pc})")
    *lead, r, c = coeffs.shape[2:]
    t = coeffs.swapaxes(0, 1)                            # (n_col, n_row, ...)
    sig_r = imodwpt(t.reshape(pc, -1, c), wavelet, method)   # (P·B·R, C)
    sig_r = sig_r.reshape([pr] + lead + [r, c])
    t = sig_r.swapaxes(-1, -2)                           # (P, ..., C, R)
    sig = imodwpt(t.reshape(pr, -1, r), wavelet, method)     # (B·C, R)
    return sig.reshape(lead + [c, r]).swapaxes(-1, -2)


def _level_forward2(nodes: torch.Tensor, g, h, j: int, method: str
                    ) -> torch.Tensor:
    """One quad-tree level: (P, P, ..., R, C) → (2P, 2P, ..., R, C)."""
    t = nodes.swapaxes(-1, -2)                # rows to the conv axis
    t = _level_forward(t, g, h, j, method)    # (2P_r, P_c, ..., C, R)
    t = t.swapaxes(-1, -2).swapaxes(0, 1)
    t = _level_forward(t, g, h, j, method)    # (2P_c, 2P_r, ..., R, C)
    return t.swapaxes(0, 1)


def _level_inverse2(nodes: torch.Tensor, g, h, j: int, method: str
                    ) -> torch.Tensor:
    """One quad-tree adjoint level: (2P, 2P, ..., R, C) → (P, P, ...)."""
    t = nodes.swapaxes(0, 1)                  # (2P_c, 2P_r, ..., R, C)
    t = _level_inverse(t, g, h, j, method)    # (P_c, 2P_r, ..., R, C)
    t = t.swapaxes(0, 1).swapaxes(-1, -2)
    t = _level_inverse(t, g, h, j, method)    # (P_r, P_c, ..., C, R)
    return t.swapaxes(-1, -2)


def modwpt2_tree(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                 method: str = "auto") -> list[torch.Tensor]:
    """Full quad tree: list over levels 0..level of ``(2^l, 2^l, ..., R, C)``.

    Row 0 is the input under (1, 1) node axes; every level is a nested
    energy-preserving analysis — the precondition for
    :func:`modwpt2_best_basis`.
    """
    x = _as_signal(x)
    _check_level(x.shape[-2], level)
    _check_level(x.shape[-1], level)
    g, h = modwt_base_filters(wavelet)
    rows = [x[None, None]]
    for j in range(1, level + 1):
        rows.append(_level_forward2(rows[-1], g, h, j, method))
    return rows


def modwpt2_best_basis(x: torch.Tensor, wavelet: DiscreteWavelet,
                       level: int, cost: str = "shannon",
                       method: str = "auto"):
    """Quad-tree Coifman–Wickerhauser best basis over the shift-invariant
    2D packet tree.

    Returns ``(masks, total_cost, tree)``: ``masks[l]`` is a boolean
    ``(2^l, 2^l)`` grid — True where node (l, n_r, n_c) is a leaf of the
    optimal basis.  Node costs are whole-node costs over all R·C samples
    (summed over leading batch axes).
    """
    from .wpt import _COSTS

    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = modwpt2_tree(x, wavelet, level, method)

    costs = []
    for l in range(level + 1):
        row = tree[l]                                  # (2^l, 2^l, ..., R, C)
        flat = row.reshape((row.shape[0], row.shape[1], -1))
        costs.append(cost_fn(flat, axis=-1))           # (2^l, 2^l)

    best = costs[level]
    split = []
    for l in range(level - 1, -1, -1):
        p = 1 << l
        children = best.reshape(p, 2, p, 2).sum(dim=(1, 3))
        take = children < costs[l]
        split.append(take)
        best = torch.where(take, children, costs[l])
    split.reverse()

    masks = []
    reach = torch.ones((1, 1), dtype=torch.bool, device=best.device)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            nxt = reach & split[l]
            reach = nxt.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[0, 0], tree


def modwpt2_basis_reconstruct(tree, masks, wavelet: DiscreteWavelet,
                              method: str = "auto") -> torch.Tensor:
    """Reconstruct the image from a quad-tree best-basis selection.

    Bottom-up adjoint cascade mirroring :func:`modwpt_basis_reconstruct`.
    """
    level = len(masks) - 1
    g, h = modwt_base_filters(wavelet)

    def mask_mul(row, m):
        shape = tuple(row.shape[:2]) + (1,) * (row.ndim - 2)
        return row * torch.as_tensor(m, device=row.device).reshape(
            shape).to(row.dtype)

    cur = mask_mul(tree[level], masks[level])
    for l in range(level, 0, -1):
        parents = _level_inverse2(cur, g, h, l, method)
        cur = parents + mask_mul(tree[l - 1], masks[l - 1])
    return cur[0, 0]


# ---------------------------------------------------------------------------
# 3D MODWPT — shift-invariant oct tree (tensor product of three 1D trees)
# ---------------------------------------------------------------------------

def modwpt3(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
            method: str = "auto") -> torch.Tensor:
    """3D MODWPT: ``(..., D, R, C) → (2^L, 2^L, 2^L, ..., D, R, C)``.

    The undecimated oct tree: node ``(n_d, n_r, n_c)`` applies the depth
    cascade of 1D node ``n_d``, the row cascade of ``n_r`` and the column
    cascade of ``n_c`` — all axes sequency-ordered.  Node (0, 0, 0) equals
    the 3D MODWT's LLL_level; every level preserves energy.  Output is 8^L
    full-resolution volumes — keep ``level`` small (L1: 8 nodes, L2: 64).

    Computed as three big-batch 1D transforms (depth, rows, columns, the
    orthogonal axes flattened into the batch), so the fused packet kernel
    runs every pass under ``method='auto'`` on a CUDA f32/bf16 tensor.
    """
    x = _as_signal(x)
    if x.ndim < 3:
        raise ValueError("modwpt3 needs at least 3 dims (..., D, R, C)")
    *lead, dd, r, c = x.shape
    for n in (dd, r, c):
        _check_level(n, level)
    p = 1 << level
    # depth pass
    t = x.movedim(-3, -1)                                  # (..., R, C, D)
    nd = modwpt(t.reshape(-1, dd), wavelet, level, method)
    nd = nd.reshape([p] + lead + [r, c, dd]).movedim(-1, -3)
    # row pass
    t = nd.swapaxes(-1, -2)                          # (P_d, ..., D, C, R)
    nr = modwpt(t.reshape(-1, r), wavelet, level, method)
    nr = nr.reshape([p, p] + lead + [dd, c, r]).swapaxes(-1, -2)
    # column pass
    nc = modwpt(nr.reshape(-1, c), wavelet, level, method)
    nc = nc.reshape([p, p, p] + lead + [dd, r, c])         # (n_c, n_r, n_d, …)
    return nc.permute([2, 1, 0] + list(range(3, nc.ndim)))


def imodwpt3(coeffs: torch.Tensor, wavelet: DiscreteWavelet,
             method: str = "auto") -> torch.Tensor:
    """Inverse 3D MODWPT: ``(2^L, 2^L, 2^L, ..., D, R, C)`` →
    ``(..., D, R, C)``."""
    coeffs = as_input(coeffs)
    if coeffs.ndim < 6:
        raise ValueError(
            "imodwpt3 expects (nodes_d, nodes_r, nodes_c, ..., D, R, C)")
    pd, pr, pc = coeffs.shape[:3]
    if not (pd == pr == pc) or pd < 2 or pd & (pd - 1):
        raise ValueError(
            f"leading node axes must be equal powers of two ≥ 2, got "
            f"({pd}, {pr}, {pc})")
    *lead, dd, r, c = coeffs.shape[3:]
    # undo the column pass (consume n_c), then the rows, then the depth
    t = coeffs.permute([2, 1, 0] + list(range(3, coeffs.ndim)))
    sig_c = imodwpt(t.reshape(pc, -1, c), wavelet, method)
    sig_c = sig_c.reshape([pr, pd] + lead + [dd, r, c])    # (n_r, n_d, …)
    t = sig_c.swapaxes(-1, -2)                             # (…, D, C, R)
    sig_r = imodwpt(t.reshape(pr, -1, r), wavelet, method)
    sig_r = sig_r.reshape([pd] + lead + [dd, c, r]).swapaxes(-1, -2)
    t = sig_r.movedim(-3, -1)                              # (n_d, …, R, C, D)
    sig = imodwpt(t.reshape(pd, -1, dd), wavelet, method)
    return sig.reshape(lead + [r, c, dd]).movedim(-1, -3)
