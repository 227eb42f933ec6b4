"""Fast Wavelet Transform (Mallat pyramid) in PyTorch.

Counterpart of ``jwave_pro_tpu/ops/fwt.py``; same semantics and names.
The reference's per-level step is a scalar double loop with circular
indexing ``k = (2i + j) mod h`` (``jwave/transforms/wavelets/
Wavelet.java:236-303``) and the pyramid runs that step on a shrinking
prefix (``jwave/transforms/FastWaveletTransform.java:71-153``).  Each
level here is one batched op over all leading axes, picked by width as the
JAX package picks it:

  * width divisible by 256: a block-pair matmul (cuBLAS on the card) — the
    stride-2 downsample and the filter taps are absorbed into a banded
    ``(512, 256)`` constant; up to ``_fused_levels_limit`` pyramid levels
    fold into one such constant (composite taps built on the host in f64);
  * even width ≤ 256: the full ``(h, h)`` circulant step as one matmul;
  * other even widths: an even/odd polyphase roll form;
  * odd widths (synthesis only, reachable through the Shifting WT
    reverse): a strided scatter of the taps folded mod h.

The banded constants are built once per wavelet tuple in numpy float64 on
the host and kept on each device in each dtype they are used in (rounded
to that dtype, as the JAX package rounds them).  Every float32 product is
pinned to IEEE float32 whatever the process's TF32 setting, in the
forward and in its gradient (``_mm``) — the counterpart of the JAX
package's per-call ``Precision.HIGHEST``, whose transpose is HIGHEST too:
a TF32 product loses the 1e-5 forward bound.

Coefficient layout matches the reference: ``[approx | detail]`` halves
recursively on the prefix of the array.
"""
from __future__ import annotations

import collections
import contextlib
import functools

import numpy as np
import torch

from ..utils.device import as_input, as_signal, tensor_cache
from ..utils.validation import check_power_of_two, exponent
from ..wavelets.base import DiscreteWavelet
from .modwt import taps_as

__all__ = [
    "fwt", "ifwt", "fwt2", "ifwt2", "fwt3", "ifwt3",
    "analysis_step", "synthesis_step", "decompose", "recompose",
]

_BLK = 256  # input block width of the banded step (outputs 128 lo + 128 hi)

#: Forward products through :func:`_mm` by tier: ``"ieee"`` and ``"tf32"``
#: on the card (``jwave::f32_mm``), ``"cpu"`` off it (``torch.matmul``);
#: the counterpart of ``kernels/_launch.LAUNCHES`` for the decimated family.
PRODUCTS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def _f32_products(tf32: bool = False):
    """cuBLAS float32 products in IEEE float32 (or, with ``tf32``, in TF32)
    inside the block; the process's setting is restored after it.

    Torch keeps two settings, the float32 matmul precision and (newer) the
    per-backend ``fp32_precision``, and may refuse a product while they
    disagree; so the block sets the one the caller set.  The first reads
    back only while both agree: set through it, they agree.
    """
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:  # only the per-backend setting was used
        mm = torch.backends.cuda.matmul
        prev_backend = mm.fp32_precision
        mm.fp32_precision = "tf32" if tf32 else "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev_backend
        return
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@torch.library.custom_op("jwave::f32_mm", mutates_args=())
def f32_mm(a: torch.Tensor, b: torch.Tensor, tf32: int) -> torch.Tensor:
    """``a @ b`` (``torch.matmul``'s broadcasting) with its products in IEEE
    float32, or in TF32 where ``tf32`` is 1, whatever the process's setting
    (``torch.ops.jwave.f32_mm``).  An operator, so an exported graph records
    each product with its tier and a served graph keeps it; its gradient is
    two such products in the same tier (so a second derivative stays
    pinned too), summed back over the axes the forward broadcast, as the
    JAX package's ``Precision.HIGHEST`` product and its transpose are both
    HIGHEST."""
    with _f32_products(bool(tf32)):
        return torch.matmul(a, b)


@f32_mm.register_fake
def _(a, b, tf32):
    return torch.matmul(a, b)


def _f32_mm_context(ctx, inputs, output):
    a, b, tf32 = inputs
    ctx.save_for_backward(a, b)
    ctx.tf32 = tf32


def _f32_mm_backward(ctx, g):
    a, b = ctx.saved_tensors
    ga = gb = None
    if ctx.needs_input_grad[0]:
        ga = f32_mm(g, b.mH, ctx.tf32).sum_to_size(a.shape)
    if ctx.needs_input_grad[1]:
        gb = f32_mm(a.mH, g, ctx.tf32).sum_to_size(b.shape)
    return ga, gb, None


f32_mm.register_autograd(_f32_mm_backward, setup_context=_f32_mm_context)


def _mm(u: torch.Tensor, m: torch.Tensor, tf32: bool = False
        ) -> torch.Tensor:
    """``u @ m`` (``torch.matmul``'s broadcasting; either side may be the
    constant), float32 and complex64 kept in full float32 on the card — or
    in TF32 where ``tf32`` asks for it — in the forward and the backward
    alike (:func:`f32_mm`).  On the CPU, ``torch.matmul`` itself.  Each
    call counts one product in :data:`PRODUCTS` under its tier."""
    if not u.is_cuda:
        PRODUCTS["cpu"] += 1
        return torch.matmul(u, m)
    PRODUCTS["tf32" if tf32 else "ieee"] += 1
    if u.ndim == 1:
        return f32_mm(u[None], m, int(tf32))[..., 0, :]
    return f32_mm(u, m, int(tf32))


@tensor_cache(maxsize=256)
def _on(build, args: tuple, dtype: torch.dtype, device: torch.device):
    """The host constant ``build(*args)`` rounded to ``dtype`` on
    ``device`` (a tuple of arrays becomes a tuple of tensors).  Copied, so
    no tensor aliases the host cache; cached but while torch traces."""
    def put(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype, copy=True)

    host = build(*args)
    return put(host) if isinstance(host, np.ndarray) else tuple(
        put(a) for a in host)


def _const(build, *args, like: torch.Tensor):
    return _on(build, args, like.dtype, like.device)


def _up(f, d):
    out = np.zeros((len(f) - 1) * d + 1)
    out[::d] = f
    return out


@functools.lru_cache(maxsize=None)
def _analysis_matrix(wavelet: DiscreteWavelet) -> np.ndarray:
    """(2·BLK, BLK) banded constant: block-pair inputs → [lo(128) | hi(128)].

    Column v < 128: lo_i with i = 128·a + v ⇒ rows 2v + j weight
    dec_lo[j]; column v ≥ 128: hi likewise.
    """
    m = wavelet.length
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    for v in range(128):
        for j in range(m):
            w[(2 * v + j) % (2 * _BLK), v] += wavelet.dec_lo[j]
            w[(2 * v + j) % (2 * _BLK), 128 + v] += wavelet.dec_hi[j]
    return w


def _composite_bank(wavelets: tuple):
    """Host-f64 composite filters for stacked analysis steps, one wavelet
    per level (a uniform pyramid passes ``(w,)*L``; the dual tree passes
    ``(level1, qshift, qshift, …)``).

    ``C_j = C_{j-1} ⊛ (dec_lo_j ↑ 2^{j-1})`` (scaling chain), detail taps
    ``E_j = C_{j-1} ⊛ (dec_hi_j ↑ 2^{j-1})``, so ``hi_j[p] = Σ_s E_j[s] ·
    x[(2^j·p + s) mod h]`` equals j recursive steps.
    """
    c = np.ones(1)
    details = []
    for j, w in enumerate(wavelets, start=1):
        lo = np.asarray(w.dec_lo, dtype=np.float64)
        hi = np.asarray(w.dec_hi, dtype=np.float64)
        details.append(np.convolve(c, _up(hi, 1 << (j - 1))))
        c = np.convolve(c, _up(lo, 1 << (j - 1)))
    return c, details


def _fused_levels_limit(wavelet: DiscreteWavelet) -> int:
    """Max L with every composite row index inside the block pair:
    the worst output (p = BLK/2^j − 1) touches row BLK − 2^j +
    (2^j − 1)(M − 1), which must stay < 2·BLK."""
    m = wavelet.length
    lmax = 0
    for lev in range(1, 9):
        if _BLK - (1 << lev) + ((1 << lev) - 1) * (m - 1) < 2 * _BLK:
            lmax = lev
        else:
            break
    return lmax


def _seq_fits_analysis(wavelets: tuple) -> bool:
    """Block-pair fit test for a mixed filter sequence: span =
    Σ_j 2^{j−1}(M_j − 1); the worst row BLK − 2^L + span stays < 2·BLK."""
    lev = len(wavelets)
    if lev > 8:
        return False
    span = sum((1 << (j - 1)) * (w.length - 1)
               for j, w in enumerate(wavelets, start=1))
    return _BLK - (1 << lev) + span < 2 * _BLK


@functools.lru_cache(maxsize=None)
def _analysis_matrix_fused(wavelets: tuple) -> np.ndarray:
    """(2·BLK, BLK) banded constant running ``len(wavelets)`` pyramid steps
    in one matmul pass.

    Columns per input block of 256: ``[lo_L (256/2^L) | hi_L | … | hi_1
    (128)]``, the per-block slice of the packed pyramid ``[a_L | d_L | … |
    d_1]``, so the outputs reshape straight into the final layout.
    """
    levels = len(wavelets)
    c, details = _composite_bank(wavelets)
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    col = 0
    segs = [(levels, c)] + [(j, e) for j, e in
                            zip(range(levels, 0, -1), details[::-1])]
    for j, taps in segs:
        cnt = _BLK >> j
        for p in range(cnt):
            base = (1 << j) * p
            for s, t in enumerate(taps):
                w[base + s, col + p] += t
        col += cnt
    assert col == _BLK
    return w


def _analysis_fused_matmul(x: torch.Tensor, wavelets: tuple):
    """Apply the fused constant; returns ``(lo_L, [d_1, …, d_L])``."""
    levels = len(wavelets)
    h = x.shape[-1]
    k = h // _BLK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (k, _BLK))
    w = _const(_analysis_matrix_fused, wavelets, like=x)
    out = _mm(xb, w[:_BLK]) + _mm(torch.roll(xb, -1, dims=-2), w[_BLK:])
    lo = out[..., :_BLK >> levels].reshape(lead + (h >> levels,))
    col = _BLK >> levels
    details = []  # built deepest first, returned d_1 .. d_L
    for j in range(levels, 0, -1):
        cnt = _BLK >> j
        details.append(out[..., col:col + cnt].reshape(lead + (h >> j,)))
        col += cnt
    return lo, details[::-1]


def _composite_rec_bank(wavelets: tuple):
    """Synthesis twin of :func:`_composite_bank` over the REC banks.

    ``RC_j = RC_{j-1} ⊛ (rec_lo_j ↑ 2^{j-1})``, ``RE_j = RC_{j-1} ⊛
    (rec_hi_j ↑ 2^{j-1})``; each segment passes steps 1..j, so the
    Haar-orthogonal energy correction enters as ``Π_{i≤j} correction_i``.
    """
    c = np.ones(1)
    details = []
    corrections = []
    ec = 1.0
    for j, w in enumerate(wavelets, start=1):
        lo = np.asarray(w.rec_lo, dtype=np.float64)
        hi = np.asarray(w.rec_hi, dtype=np.float64)
        details.append(np.convolve(c, _up(hi, 1 << (j - 1))))
        c = np.convolve(c, _up(lo, 1 << (j - 1)))
        ec *= float(w.energy_correction)
        corrections.append(ec)
    return c, details, corrections


def _fused_synth_limit(wavelet: DiscreteWavelet) -> int:
    """Max L with the composite rec span inside one previous block:
    (2^L − 1)(M − 1) ≤ BLK."""
    m = wavelet.length
    lmax = 0
    for lev in range(1, 9):
        if ((1 << lev) - 1) * (m - 1) <= _BLK:
            lmax = lev
        else:
            break
    return lmax


def _seq_fits_synthesis(wavelets: tuple) -> bool:
    """(prev, cur) pair fit for a mixed rec sequence: span ≤ BLK."""
    if len(wavelets) > 8:
        return False
    span = sum((1 << (j - 1)) * (w.length - 1)
               for j, w in enumerate(wavelets, start=1))
    return span <= _BLK


@functools.lru_cache(maxsize=None)
def _synthesis_matrices_fused(wavelets: tuple) -> list:
    """Per-segment (2·cnt_r, BLK) constants for ``len(wavelets)`` fused
    synthesis steps, ordered ``[lo(L), hi(L), hi(L−1), …, hi(1)]``
    (deepest first, as the packed ``[a | d_deep | … | d_1]`` layout).

    Row u ↦ segment entry ``p_rel = u − cnt`` of the (previous, current)
    block pair; column t the output sample; weight ``taps[t − 2^r·p_rel]``
    times the accumulated energy correction of steps 1..r.
    """
    levels = len(wavelets)
    c, details, corrections = _composite_rec_bank(wavelets)
    mats = []
    segs = [(levels, c)] + [(r, e) for r, e in
                            zip(range(levels, 0, -1), details[::-1])]
    for r, taps in segs:
        cnt = _BLK >> r
        mat = np.zeros((2 * cnt, _BLK), dtype=np.float64)
        scale = corrections[r - 1]
        for u in range(2 * cnt):
            base = (1 << r) * (u - cnt)
            for s, tap in enumerate(taps):
                t = base + s
                if 0 <= t < _BLK:
                    mat[u, t] += tap * scale
        mats.append(mat)
    return mats


@functools.lru_cache(maxsize=None)
def _synthesis_matrix_fused_packed(wavelets: tuple):
    """The per-segment synthesis constants assembled into one (prev, cur)
    pair of (BLK, BLK) constants, row-offset by the packed per-block layout
    ``[a_L | d_L | … | d_1]`` (Σ cnt_r = BLK exactly), so the inverse chunk
    is two full-depth matmuls, like the analysis direction."""
    prev = np.zeros((_BLK, _BLK), dtype=np.float64)
    cur = np.zeros((_BLK, _BLK), dtype=np.float64)
    off = 0
    for mat in _synthesis_matrices_fused(wavelets):
        cnt = mat.shape[0] // 2
        prev[off:off + cnt] = mat[:cnt]
        cur[off:off + cnt] = mat[cnt:]
        off += cnt
    assert off == _BLK
    return prev, cur


def _synthesis_fused_matmul(lo: torch.Tensor, segs_desc: list,
                            wavelets: tuple) -> torch.Tensor:
    """Fused inverse chunk: ``lo`` the deepest approximation, ``segs_desc``
    the detail segments deepest first; returns the chunk-top approximation
    (width 2^len(segs_desc) · lo's).  The segments are packed per output
    block (one concatenation), then two matmuls against the packed
    constant."""
    levels = len(segs_desc)
    h = lo.shape[-1] << levels
    k = h // _BLK
    lead = lo.shape[:-1]
    w_prev, w_cur = _const(_synthesis_matrix_fused_packed, wavelets, like=lo)
    pack = torch.cat([seg.reshape(lead + (k, seg.shape[-1] // k))
                      for seg in [lo, *segs_desc]], dim=-1)  # (..., k, BLK)
    out = _mm(torch.roll(pack, 1, dims=-2), w_prev) + _mm(pack, w_cur)
    return out.reshape(lead + (h,))


@functools.lru_cache(maxsize=None)
def _synthesis_matrices(wavelet: DiscreteWavelet):
    """Two (2·128, BLK) constants A, B with x_blk = lo_pair@A + hi_pair@B.

    Row u indexes lo/hi element i = 128·(a−1) + u over the previous and
    current half-blocks; column k the output sample 256·a + k; weight
    rec_lo/rec_hi[k + 256 − 2u] where in range, times the energy
    correction.
    """
    m = wavelet.length
    a = np.zeros((2 * 128, _BLK), dtype=np.float64)
    b = np.zeros((2 * 128, _BLK), dtype=np.float64)
    for u in range(2 * 128):
        for k in range(_BLK):
            j = k + 256 - 2 * u
            if 0 <= j < m:
                a[u, k] += wavelet.rec_lo[j] * wavelet.energy_correction
                b[u, k] += wavelet.rec_hi[j] * wavelet.energy_correction
    return a, b


@functools.lru_cache(maxsize=None)
def _analysis_matrix_small(wavelet: DiscreteWavelet, h: int) -> np.ndarray:
    """Full (h, h) circulant-step constant for widths ≤ BLK:
    ``out = x @ W`` with ``W[(2v+j) mod h, v] += dec_lo[j]`` (columns
    v < h/2) and the high-pass in columns v ≥ h/2."""
    m = wavelet.length
    w = np.zeros((h, h), dtype=np.float64)
    for v in range(h // 2):
        for j in range(m):
            w[(2 * v + j) % h, v] += wavelet.dec_lo[j]
            w[(2 * v + j) % h, h // 2 + v] += wavelet.dec_hi[j]
    return w


@functools.lru_cache(maxsize=None)
def _synthesis_matrix_small(wavelet: DiscreteWavelet, h: int) -> np.ndarray:
    """Full (h, h) adjoint constant: ``x = y @ S`` with
    ``S[i, (2i+j) mod h] += rec_lo[j]`` (rows i < h/2) and rec_hi in rows
    i ≥ h/2, times the energy correction."""
    m = wavelet.length
    s = np.zeros((h, h), dtype=np.float64)
    for i in range(h // 2):
        for j in range(m):
            s[i, (2 * i + j) % h] += wavelet.rec_lo[j]
            s[h // 2 + i, (2 * i + j) % h] += wavelet.rec_hi[j]
    s *= wavelet.energy_correction
    return s


def _analysis_step_matmul(x: torch.Tensor, wavelet: DiscreteWavelet
                          ) -> torch.Tensor:
    h = x.shape[-1]
    lead = x.shape[:-1]
    xb = x.reshape(lead + (h // _BLK, _BLK))
    w = _const(_analysis_matrix, wavelet, like=x)
    # two products against the halves instead of a (…, k, 2·BLK) pairs
    # buffer; the next block's rows come in by a roll of the block axis
    out = _mm(xb, w[:_BLK]) + _mm(torch.roll(xb, -1, dims=-2), w[_BLK:])
    lo = out[..., :128].reshape(lead + (h // 2,))
    hi = out[..., 128:].reshape(lead + (h // 2,))
    return torch.cat([lo, hi], dim=-1)


def _synthesis_step_matmul(y: torch.Tensor, wavelet: DiscreteWavelet
                           ) -> torch.Tensor:
    h = y.shape[-1]
    half = h // 2
    k = half // 128
    lead = y.shape[:-1]
    lo = y[..., :half].reshape(lead + (k, 128))
    hi = y[..., half:].reshape(lead + (k, 128))
    a, b = _const(_synthesis_matrices, wavelet, like=y)
    out = (_mm(torch.roll(lo, 1, dims=-2), a[:128]) + _mm(lo, a[128:])
           + _mm(torch.roll(hi, 1, dims=-2), b[:128]) + _mm(hi, b[128:]))
    return out.reshape(lead + (h,))


def analysis_step(x: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """One filter-bank analysis step on the last axis (length h, even).

    ``out[..., :h/2]`` are scaling coefficients ``lo[i] = Σ_j x[(2i+j) mod
    h] · dec_lo[j]``, ``out[..., h/2:]`` the wavelet coefficients — the
    batched ``Wavelet.forward`` (``Wavelet.java:236-260``).

    Dispatch: h divisible by 256 → banded block-pair matmul; even h ≤ 256
    → full circulant matmul; other even h → an even/odd polyphase roll form
    (filters longer than the signal wrap correctly, because a roll is mod
    h/2).  An odd h raises ``ValueError``.
    """
    x = as_signal(x)
    h = x.shape[-1]
    m = wavelet.length
    if h % _BLK == 0 and m <= _BLK:
        return _analysis_step_matmul(x, wavelet)
    if h % 2:
        raise ValueError(f"analysis_step needs an even length, got {h}")
    if h <= _BLK:
        return _mm(x, _const(_analysis_matrix_small, wavelet, h, like=x))
    g = taps_as(wavelet.dec_lo, x.dtype)
    f = taps_as(wavelet.dec_hi, x.dtype)
    xe = x[..., 0::2]
    xo = x[..., 1::2]
    lo = hi = None
    for j in range(m):
        ph = xe if j % 2 == 0 else xo
        r = torch.roll(ph, -(j // 2), dims=-1) if j // 2 else ph
        tl = g[j] * r
        th = f[j] * r
        lo = tl if lo is None else lo + tl
        hi = th if hi is None else hi + th
    return torch.cat([lo, hi], dim=-1)


def synthesis_step(y: torch.Tensor, wavelet: DiscreteWavelet
                   ) -> torch.Tensor:
    """Adjoint of :func:`analysis_step` using the reconstruction banks.

    ``x[k] = Σ_{i,j: (2i+j)≡k (mod h)} lo[i]·rec_lo[j] + hi[i]·rec_hi[j]``
    — the batched ``Wavelet.reverse`` (``Wavelet.java:277-303``), including
    the unnormalized-Haar energy-correction factor
    (``Haar1Orthogonal.java:196-201``).

    Dispatch mirrors :func:`analysis_step`; an odd width (reachable through
    the Shifting WT reverse) reads lo = y[:h//2], hi = y[h//2:2·(h//2)],
    ignores the last element, and scatters the taps modulo h, as the
    reference does with integer halving.
    """
    y = as_signal(y)
    h = y.shape[-1]
    m = wavelet.length
    if h % _BLK == 0 and m <= _BLK:
        return _synthesis_step_matmul(y, wavelet)
    if h % 2 == 0 and h <= _BLK:
        return _mm(y, _const(_synthesis_matrix_small, wavelet, h, like=y))
    rl = taps_as(wavelet.rec_lo, y.dtype)
    rh = taps_as(wavelet.rec_hi, y.dtype)
    half = h // 2
    lo = y[..., :half]
    hi = y[..., half:2 * half]
    if h % 2 == 0:
        # polyphase adjoint: even outputs x_e[p] = Σ_m rl[2m]·roll(lo, m)[p]
        # + rh[2m]·roll(hi, m)[p], odd outputs likewise; interleaved last
        xe = xo = None
        for j in range(m):
            sh = j // 2
            rlo = torch.roll(lo, sh, dims=-1) if sh else lo
            rhi = torch.roll(hi, sh, dims=-1) if sh else hi
            t = rl[j] * rlo + rh[j] * rhi
            if j % 2 == 0:
                xe = t if xe is None else xe + t
            else:
                xo = t if xo is None else xo + t
        if xo is None:
            xo = torch.zeros_like(xe)
        x = torch.stack([xe, xo], dim=-1).reshape(y.shape[:-1] + (h,))
    else:
        # tap j of input i lands at 2i + j of the full (unwrapped) output of
        # length 2·half + m − 2, which then folds mod h
        total = 2 * half + m - 2
        reps = -(-total // h)
        ext = y.new_zeros(y.shape[:-1] + (reps * h,))
        for j in range(m):
            ext[..., j:j + 2 * half:2] += rl[j] * lo + rh[j] * hi
        x = ext.reshape(y.shape[:-1] + (reps, h)).sum(dim=-2)
    if wavelet.energy_correction != 1.0:
        x = x * wavelet.energy_correction
    return x


def _resolve_level(n: int, level, wavelet: DiscreteWavelet) -> int:
    # The reference accepts 0 ≤ level ≤ log2(N)
    # (FastWaveletTransform.java:80-84); the step loops additionally stop
    # when the width drops below the wavelet's transform_wavelength
    # (":90-97").
    maxl = exponent(n)
    if level is None:
        return maxl
    level = int(level)
    if level < 0 or level > maxl:
        raise ValueError(f"level {level} out of range [0, {maxl}] for "
                         f"length {n}")
    return level


def fwt(x: torch.Tensor, wavelet: DiscreteWavelet, level=None
        ) -> torch.Tensor:
    """Multi-level forward FWT on the last axis (length a power of 2).

    Equivalent to ``FastWaveletTransform.forward(arr, level)``
    (``FastWaveletTransform.java:71-101``).  Widths divisible by 256 run
    chunks of up to ``_fused_levels_limit`` levels as one fused matmul;
    narrower widths one step at a time.  The details are gathered and
    concatenated once.  Integer input is transformed in torch's default
    float dtype.
    """
    x = as_signal(x)
    n = x.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    h = n
    cur = x
    details = []
    done = 0
    while done < level and h >= wavelet.transform_wavelength and h >= 2:
        lf = 0
        if h % _BLK == 0 and wavelet.length <= _BLK:
            lf = min(_fused_levels_limit(wavelet), level - done)
            # sub-level ℓ of the chunk acts on width h >> (ℓ − 1): the
            # same stopping guard as the step loop
            while lf > 1 and (h >> (lf - 1)) < wavelet.transform_wavelength:
                lf -= 1
        if lf > 1:
            cur, segs = _analysis_fused_matmul(cur, (wavelet,) * lf)
            details.extend(segs)  # ascending level order
            h >>= lf
            done += lf
        else:
            out = analysis_step(cur, wavelet)
            cur = out[..., :h // 2]
            details.append(out[..., h // 2:])
            h //= 2
            done += 1
    if not details:
        return x
    # widths sum to n: [a_L | d_L | d_{L-1} | … | d_1]
    return torch.cat([cur, *reversed(details)], dim=-1)


def ifwt(y: torch.Tensor, wavelet: DiscreteWavelet, level=None
         ) -> torch.Tensor:
    """Multi-level inverse FWT (``FastWaveletTransform.reverse``,
    ``:119-153``).  Chunks of levels whose output width divides 256 run as
    one fused matmul; the others one step at a time, on the growing prefix
    with the detail segments read in place."""
    y = as_signal(y)
    n = y.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    # mirror the forward's widths, then synthesize in reverse order
    # (FastWaveletTransform.java:134-148)
    widths = []
    hh = n
    for _ in range(level):
        if hh < wavelet.transform_wavelength or hh < 2:
            break
        widths.append(hh)
        hh //= 2
    if not widths:
        return y
    cur = y[..., :widths[-1] // 2]  # a_L
    j = len(widths)  # deepest remaining synthesis step
    while j >= 1:
        lf = 0
        if wavelet.length <= _BLK:
            lf = min(_fused_synth_limit(wavelet), j)
            while lf > 1 and widths[j - lf] % _BLK != 0:
                lf -= 1
        if lf > 1:
            # detail segment of step jj sits at y[n>>jj : n>>(jj−1)]
            segs = [y[..., widths[jj - 1] // 2:widths[jj - 1]]
                    for jj in range(j, j - lf, -1)]
            cur = _synthesis_fused_matmul(cur, segs, (wavelet,) * lf)
            j -= lf
        else:
            h = widths[j - 1]
            cur = synthesis_step(torch.cat([cur, y[..., h // 2:h]], dim=-1),
                                 wavelet)
            j -= 1
    return cur


def fwt2(m: torch.Tensor, wavelet: DiscreteWavelet, level_rows=None,
         level_cols=None) -> torch.Tensor:
    """2D forward: all rows (last axis), then all columns (second-to-last).

    Matches ``BasicTransform.forward(double[][], lvlM, lvlN)``
    (``BasicTransform.java:361-399``).
    """
    m = fwt(m, wavelet, level_cols)
    return torch.swapaxes(fwt(torch.swapaxes(m, -1, -2), wavelet,
                              level_rows), -1, -2)


def ifwt2(m: torch.Tensor, wavelet: DiscreteWavelet, level_rows=None,
          level_cols=None) -> torch.Tensor:
    """2D inverse: columns first, then rows (``BasicTransform.java:436-474``)."""
    m = as_signal(m)
    m = torch.swapaxes(ifwt(torch.swapaxes(m, -1, -2), wavelet, level_rows),
                       -1, -2)
    return ifwt(m, wavelet, level_cols)


def fwt3(s: torch.Tensor, wavelet: DiscreteWavelet,
         levels=(None, None, None)) -> torch.Tensor:
    """3D forward over the last three axes (``BasicTransform.java:509-566``)."""
    lp, lq, lr = levels
    s = fwt(s, wavelet, lr)                                   # last axis
    s = torch.swapaxes(fwt(torch.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    return torch.swapaxes(fwt(torch.swapaxes(s, -1, -3), wavelet, lp), -1, -3)


def ifwt3(s: torch.Tensor, wavelet: DiscreteWavelet,
          levels=(None, None, None)) -> torch.Tensor:
    """3D inverse (mirror of :func:`fwt3`, ``BasicTransform.java:602-659``)."""
    s = as_signal(s)
    lp, lq, lr = levels
    s = torch.swapaxes(ifwt(torch.swapaxes(s, -1, -3), wavelet, lp), -1, -3)
    s = torch.swapaxes(ifwt(torch.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    return ifwt(s, wavelet, lr)


def decompose(x: torch.Tensor, wavelet: DiscreteWavelet) -> torch.Tensor:
    """All-level decomposition matrix, shape ``(maxLevel+1, ..., N)``.

    Row 0 is the input signal; row p is the FWT at level p
    (``WaveletTransform.decompose``, ``WaveletTransform.java:136-146``).
    """
    x = as_signal(x)
    n = x.shape[-1]
    check_power_of_two(n)
    rows = [x]
    for p in range(1, exponent(n) + 1):
        h = n >> (p - 1)
        prev = rows[-1]
        if h < max(wavelet.transform_wavelength, 2):
            rows.append(prev)
            continue
        head = analysis_step(prev[..., :h], wavelet)
        rows.append(torch.cat([head, prev[..., h:]], dim=-1)
                    if h < n else head)
    return torch.stack(rows, dim=0)


def recompose(mat: torch.Tensor, wavelet: DiscreteWavelet, level: int
              ) -> torch.Tensor:
    """Reconstruct the time signal from row ``level`` of a decompose matrix
    (``WaveletTransform.recompose``, ``WaveletTransform.java:173-182``)."""
    return ifwt(as_input(mat)[level], wavelet, level)
