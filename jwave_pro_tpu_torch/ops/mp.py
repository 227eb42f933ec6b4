"""Matching pursuit over the shift-invariant wavelet-packet dictionary.

Counterpart of ``jwave_pro_tpu/ops/mp.py``; same semantics and names.
Greedy sparse decomposition (Mallat & Zhang 1993): pick the dictionary atom
most correlated with the residual, subtract its projection, repeat.

Dictionary = the level-J MODWPT atoms: for node ``n`` and shift ``t`` the
atom is the node's effective circular filter time-reversed and rolled to t,

    atom[n, t][u] = f_n[(t − u) mod N] / ‖f_n‖₂ ,

so the correlation of the residual with every atom at once is one forward
MODWPT (``⟨r, atom[n,t]⟩ = W_n[t]/‖f_n‖``): no per-atom loop and no explicit
(2^J·N, N) dictionary matrix.  Each greedy step is one transform (or, on
the card, one fused select kernel that writes only the per-node arg-max),
one arg-max and one S-wide windowed subtraction (the atom's finite support
S = (M−1)(2^J−1)+1 ≪ N; see ``_subtract_atom_windowed``).  The JAX
package's ``lax.scan`` is a Python loop here.

The effective node filters come from the same host-side spectral cascade the
FFT path uses (``ops/modwpt._composite_packet_multipliers``), so the
dictionary is exactly consistent with :func:`..ops.modwpt.modwpt`.
"""
from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from ..utils.device import as_input
from ..wavelets.base import DiscreteWavelet
from .modwpt import _composite_packet_multipliers, modwpt

__all__ = ["matching_pursuit", "mp_reconstruct", "MPResult"]


class MPResult(typing.NamedTuple):
    """Greedy decomposition ``x ≈ Σ_k amps[k] · atom(nodes[k], shifts[k])``.

    ``nodes``/``shifts``/``amps``: ``(..., K)`` — packet node (sequency
    order), circular time shift, and coefficient on the unit-norm atom, in
    selection order.  ``residual``: ``(..., N)`` after all K subtractions.
    ``level``/``wavelet_name``: the dictionary parameters (needed to rebuild
    atoms in :func:`mp_reconstruct`).
    """

    nodes: torch.Tensor
    shifts: torch.Tensor
    amps: torch.Tensor
    residual: torch.Tensor
    level: int
    wavelet_name: str

    @property
    def energies(self):
        """Per-atom captured energy |α_k|² — **plain MP only** (unit atoms ⇒
        the greedy identity ‖r_k‖² = ‖r_{k-1}‖² − α_k² holds, so a post-hoc
        energy cutoff over these is exact).  For ``orthogonalize=True`` the
        amps are the final joint least-squares coefficients over a
        non-orthogonal atom set: amps² are not per-step captured energies
        and do not sum to ‖x‖² − ‖r‖²; rank atoms by re-running with
        increasing K and differencing ‖residual‖² instead."""
        return self.amps ** 2


@functools.lru_cache(maxsize=64)
def _atom_tables(wavelet: DiscreteWavelet, level: int, n: int):
    """Host f64 tables: reversed unit atoms ``(2^level, N)`` + filter norms.

    ``rev_unit[n, u] = f_n[(−u) mod N] / ‖f_n‖`` so the atom at shift t is
    ``roll(rev_unit[n], t)`` (equivalently a ``(u − t) mod N`` gather).
    """
    mults = _composite_packet_multipliers(wavelet, level, n)
    f = np.fft.irfft(mults, n=n, axis=-1)          # (2^L, N) effective filters
    norms = np.linalg.norm(f, axis=-1)
    rev = np.roll(f[:, ::-1], 1, axis=-1)          # rev[u] = f[(−u) mod N]
    return rev / norms[:, None], norms


@functools.lru_cache(maxsize=64)
def _gram_lag_table(wavelet: DiscreteWavelet, level: int, n: int):
    """Host f64 cross-correlation table ``(2^L, 2^L, 2S−1)``:
    ``tab[m, m', d+S−1] = ⟨atom(m, t), atom(m', t−d)⟩`` for circular lags
    ``d ∈ [−(S−1), S−1]`` — zero beyond (finite atom support S).

    Inner products of shift-invariant atoms depend only on
    (node_j, node_k, t_j − t_k), so OMP's per-pick Gram row is a K-element
    gather from this small table instead of a read of the whole (…, K, N)
    atom buffer.  Built from the compact (2^L, S) support windows with
    length-2S FFTs: zero-padding to 2S makes the circular correlation equal
    the linear one on every needed lag, and equality with the length-N form
    holds because atoms ≥ 2S apart never overlap (the caller gates on
    n ≥ 2S).
    """
    win, s = _support_window_table(wavelet, level, n)
    p = 2 * s
    spec = np.fft.rfft(win, n=p, axis=-1)
    cc = np.fft.irfft(np.conj(spec[:, None]) * spec[None, :], n=p, axis=-1)
    lags = np.arange(-(s - 1), s) % p
    return cc[:, :, lags], s


@functools.lru_cache(maxsize=64)
def _support_window_table(wavelet: DiscreteWavelet, level: int, n: int):
    """(2^L, S) window per node: the atom's only nonzero samples.

    A level-L MODWPT node's effective filter has finite support
    ``S = (M−1)(2^L−1)+1`` ≪ N, so the unit atom at shift t occupies just
    the S positions ``[t−S+1, t] mod N``.  ``win[node][i]`` is the atom
    value at position ``t − S + 1 + i`` (``rev_unit[node]`` values
    reordered): subtracting ``amp·atom`` is an S-wide windowed update, not
    an N-length roll.  Returns (win, S).
    """
    rev, _ = _atom_tables(wavelet, level, n)
    s = min((wavelet.length - 1) * ((1 << level) - 1) + 1, n)
    win = np.concatenate([rev[:, n - s + 1:], rev[:, :1]], axis=1)
    return win, s


def _subtract_atom_windowed(r: torch.Tensor, win_table: torch.Tensor, s: int,
                            node: torch.Tensor, t: torch.Tensor,
                            amp: torch.Tensor) -> torch.Tensor:
    """``r − amp·atom(node, t)`` via an S-wide scattered update.

    The window ``[t−S+1, t] mod N`` may wrap; S ≤ N, so its S positions are
    distinct and each sample of ``r`` receives at most one term.
    """
    n = r.shape[-1]
    vals = amp[..., None] * win_table[node]                    # (..., S)
    start = (t - (s - 1)) % n
    idx = (start[..., None] + torch.arange(s, device=r.device)) % n
    return r.scatter_add(-1, idx.to(torch.int64), -vals)


def _gather_atoms(rev_unit: torch.Tensor, nodes: torch.Tensor,
                  shifts: torch.Tensor, n: int) -> torch.Tensor:
    """Atom values ``(..., N)`` (or ``(..., K, N)``) for (node, shift) picks:
    ``roll(rev_unit[node], shift)`` as an exact gather."""
    rows = rev_unit[nodes]                                     # (..., N)
    idx = (torch.arange(n, device=shifts.device) - shifts[..., None]) % n
    return torch.gather(rows, -1, idx.to(torch.int64))


def matching_pursuit(x: torch.Tensor, wavelet: DiscreteWavelet, level: int,
                     n_atoms: int, method: str = "auto",
                     orthogonalize: bool = False) -> MPResult:
    """Greedy MP of ``x`` ``(..., N)`` over the level-``level`` MODWPT atoms.

    ``n_atoms``: iteration count K (the classic stopping rule; check
    ``result.energies`` to pick an energy cutoff post hoc — entries past the
    point of interest can be dropped before :func:`mp_reconstruct` by
    slicing all three coefficient arrays).  ``method`` is forwarded to the
    per-iteration :func:`..ops.modwpt.modwpt`.  Under ``'auto'`` a CUDA
    float32/bfloat16 (B, N) input runs each select stage as one fused CUDA
    kernel that writes only the per-node (max |W|, position, value); other
    inputs correlate through the transform, itself fused where it can be.

    ``orthogonalize=True`` runs Orthogonal Matching Pursuit (Pati–
    Rezaiifar–Krishnaprasad 1993): after each pick the residual is the
    least-squares remainder over all selected atoms, so it is orthogonal to
    their span and ``amps`` are the final joint LS coefficients (not the
    per-step correlations).  The Gram matrix's Cholesky factor grows by one
    row per step, identity-padded on unselected rows so every solve keeps
    its (K, K) shape.
    """
    x = as_input(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    if n_atoms < 1:
        raise ValueError("n_atoms must be >= 1")
    n = x.shape[-1]
    num_nodes = 1 << level
    rev_np, norms_np = _atom_tables(wavelet, level, n)
    rev_unit = torch.as_tensor(rev_np, dtype=x.dtype, device=x.device)
    inv_norms = torch.as_tensor(1.0 / norms_np, dtype=x.dtype,
                                device=x.device)
    # broadcast 1/‖f_n‖ over the (2^L, ..., N) coefficient stack
    inv_b = inv_norms.reshape((num_nodes,) + (1,) * x.ndim)

    from ..kernels._launch import DTYPE_CODES

    use_fused_select = False
    if (method == "auto" and x.ndim == 2 and x.is_cuda
            and x.dtype in DTYPE_CODES):
        from ..kernels.modwpt_cuda import (
            modwpt_select_fused, select_fused_supported)
        use_fused_select = select_fused_supported(x.shape[0], n, level,
                                                  wavelet.length)

    def select(r):
        """Best (node, shift, correlation) per batch element.

        Fused path: the kernel writes (2^L, B) reductions directly.
        Otherwise a two-stage arg-max on the native (2^L, ..., N) layout —
        per-node best shift, then best node — so the 2^L·N coefficient block
        is never transposed.
        """
        if use_fused_select:
            absv, t_all, v_all = modwpt_select_fused(r, wavelet, level)
            a = absv * inv_norms[:, None]                      # (2^L, B)
            node = torch.argmax(a, dim=0)                      # (B,)
            t = torch.gather(t_all, 0, node[None])[0]
            v = torch.gather(v_all, 0, node[None])[0]
            amp = v * inv_norms[node]
            return node.to(torch.int32), t.to(torch.int32), amp.to(r.dtype)
        w = modwpt(r, wavelet, level, method=method) * inv_b
        a = torch.abs(w)
        t_per = torch.argmax(a, dim=-1)                        # (2^L, ...)
        v_per = torch.amax(a, dim=-1)                          # (2^L, ...)
        node = torch.argmax(v_per, dim=0)                      # (...,)
        t = torch.gather(t_per, 0, node[None])[0]
        # signed amp: small (2^L·batch)-output gather, then the node pick
        w_bt = torch.gather(w, -1, t_per[..., None])[..., 0]
        amp = torch.gather(w_bt, 0, node[None])[0]
        return node.to(torch.int32), t.to(torch.int32), amp

    if not orthogonalize:
        win_np, s_win = _support_window_table(wavelet, level, n)
        win_tab = torch.as_tensor(win_np, dtype=x.dtype, device=x.device)
        r = x
        picks = []
        for _ in range(n_atoms):
            node, t, amp = select(r)
            r = _subtract_atom_windowed(r, win_tab, s_win, node.long(), t,
                                        amp)
            picks.append((node, t, amp))
        nodes, shifts, amps = (torch.stack(p, dim=-1) for p in zip(*picks))
        return MPResult(nodes, shifts, amps, r, level, wavelet.name)

    k_tot = n_atoms
    batch = tuple(x.shape[:-1])
    dev = x.device
    buf = torch.zeros(batch + (k_tot, n), dtype=x.dtype, device=dev)
    # the least-squares bookkeeping (chol, b, the solves, coef) runs in
    # float32 for bf16/f16 input: torch's triangular solves take neither;
    # coef and the residual come back in x's dtype, as JAX returns them
    lin = (torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
           else x.dtype)
    x_lin = x.to(lin)
    # identity-padded Cholesky factor of the Gram matrix: unselected rows
    # stay e_j, so the solves return 0 for slots not yet filled
    chol = torch.eye(k_tot, dtype=lin, device=dev).expand(
        batch + (k_tot, k_tot)).clone()
    b = torch.zeros(batch + (k_tot,), dtype=lin, device=dev)

    # Degenerate-pick guard: when n_atoms exceeds the signal's effective
    # sparsity the residual hits ~0 and the arg-max re-picks an
    # already-selected atom — the Gram then goes exactly singular.  OMP's
    # residual is ⊥ span(selected), so a re-picked atom's correlation is
    # ~0: gate on |amp| and park the slot (zero atom, identity row ⇒ coef
    # stays 0) instead of regularizing, which would bias the well-posed
    # steps.
    amp_tol = 50 * torch.finfo(x.dtype).eps * torch.linalg.norm(x, dim=-1)

    # Gram rows from the lag table when the signal is long enough that
    # clipped circular lags are unambiguous
    s_g = min((wavelet.length - 1) * ((1 << level) - 1) + 1, n)
    use_gram_tab = n >= 2 * s_g
    if use_gram_tab:
        gram_np, s_g = _gram_lag_table(wavelet, level, n)
        gram_tab = torch.as_tensor(gram_np, dtype=x.dtype, device=dev)
    nodes_a = torch.zeros(batch + (k_tot,), dtype=torch.int64, device=dev)
    ts_a = torch.zeros(batch + (k_tot,), dtype=torch.int64, device=dev)
    live_a = torch.zeros(batch + (k_tot,), dtype=torch.bool, device=dev)
    slots = torch.arange(k_tot, device=dev)

    r = x
    picks = []
    for k in range(k_tot):
        node, t, amp = select(r)
        node, t = node.long(), t.long()
        live = (torch.abs(amp) > amp_tol)[..., None]          # (..., 1)
        atom = _gather_atoms(rev_unit, node, t, n)            # (..., N)
        atom = torch.where(live, atom, torch.zeros_like(atom))
        buf[..., k, :] = atom
        ek = (slots == k).to(lin)
        if use_gram_tab:
            # ⟨atom_j, atom_k⟩ = tab[node_j, node_k, (t_j − t_k) + S−1]
            dt = ts_a - t[..., None]
            dt = (dt + n // 2) % n - n // 2
            idx = torch.clamp(dt, -(s_g - 1), s_g - 1) + (s_g - 1)
            val = gram_tab[nodes_a, node[..., None], idx]
            valid = (live_a & (torch.abs(dt) < s_g) & (slots < k) & live)
            row = torch.where(valid, val, 0.0) + ek   # diag: unit atoms ⇒ 1
        else:
            row = torch.einsum("...ln,...n->...l", buf, atom)
            # parked slot: keep the identity row's 1 on the diagonal
            row = row + (~live).to(lin) * ek
        nodes_a[..., k] = node
        ts_a[..., k] = t
        live_a[..., k] = live[..., 0]
        # rank-1 extension of chol: y = chol⁻¹·row gives the new row's
        # off-diagonal entries, the pivot is √(g_kk − ‖l_k‖²)
        y = torch.linalg.solve_triangular(chol, row[..., None],
                                          upper=False)[..., 0]
        yk = y[..., k]
        # ‖l_k‖² = ‖y‖² − y_k² (entries past k are exactly 0)
        d = yk - (torch.sum(y * y, dim=-1) - yk * yk)
        pivot = torch.sqrt(torch.clamp_min(d, torch.finfo(lin).tiny))
        chol[..., k, :] = y * (slots < k).to(lin) + pivot[..., None] * ek
        b[..., k] = torch.einsum("...n,...n->...", atom.to(lin), x_lin)
        z = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
        coef = torch.linalg.solve_triangular(chol.mT, z, upper=True)[..., 0]
        r = (x_lin - torch.einsum("...k,...kn->...n", coef, buf.to(lin))
             ).to(x.dtype)
        picks.append((node.to(torch.int32), t.to(torch.int32)))
    nodes, shifts = (torch.stack(p, dim=-1) for p in zip(*picks))
    # amps = the final joint LS coefficients, aligned with pick order
    return MPResult(nodes, shifts, coef.to(x.dtype), r, level, wavelet.name)


def mp_reconstruct(result: MPResult, wavelet: DiscreteWavelet,
                   n: int | None = None) -> torch.Tensor:
    """Rebuild ``Σ_k amps[k]·atom(nodes[k], shifts[k])`` → ``(..., N)``.

    ``x ≈ mp_reconstruct(r) + r.residual`` to working precision.  ``n``
    defaults to the residual length.
    """
    if n is None:
        n = result.residual.shape[-1]
    amps = torch.as_tensor(result.amps)
    rev_np, _ = _atom_tables(wavelet, int(result.level), n)
    rev_unit = torch.as_tensor(rev_np, dtype=amps.dtype, device=amps.device)
    atoms = _gather_atoms(rev_unit, torch.as_tensor(result.nodes).long(),
                          torch.as_tensor(result.shifts).long(), n)
    return torch.einsum("...k,...kn->...n", amps, atoms)
