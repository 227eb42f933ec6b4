"""The wavelet packet transform's best-basis denoise, plain.

JWave's decimated step (``Wavelet.java:236-260``) on a packet of even
width h, circular:

    lo[i] = Σ_j x[(2i + j) mod h]·g[j],   hi[i] = Σ_j x[(2i + j) mod h]·f[j]

with the high-pass f[j] = (−1)^j·g[M − 1 − j].  A packet's step writes
[lo | hi] over its own span, so level l of the full tree holds 2^l packets
of N/2^l samples in natural (Paley) order, the children of packet p being
2p (lo) and 2p + 1 (hi).  The banks are orthonormal, so the inverse step
is the adjoint:

    x[(2i + j) mod h] += lo[i]·g[j] + hi[i]·f[j].

Best basis (Coifman and Wickerhauser, 1992): each packet's cost is SURE
at t = 1 (Donoho and Johnstone, 1995), n − 2·#{c² ≤ 1} + Σ min(c², 1);
bottom up, a packet splits where its children's best costs sum strictly
below its own cost; top down, a packet is a leaf where every ancestor
splits and it does not.  One basis a row, or one for all rows over their
summed costs.

The denoise: σ = median(|d₁|)/0.6745 over a row's level-1 details (the
mean of the two middle values for an even count), t = σ·√(2·ln N), every
coefficient of the basis shrunk except those of the low-pass packet
(node 0 at its leaf level), then the mixed-level synthesis: a leaf gives
its shrunk coefficients, a packet that splits the inverse step of its
children's.

The float32 check (:func:`candidates`).  SURE jumps by 2 where a
coefficient crosses t = 1, so a program whose tree carries float32
rounding may take the other side of a decision the float64 tree takes by
a hair.  A packet is *open* where its float64 margin, |children − own
cost|, lies within what that rounding can move the two: its slack, the
sum over the packet and every packet below it of each cost's bound
(:func:`cost_bounds`).  At an open packet either choice is sound, so the
check builds every basis the open packets allow, at most MAX_BASES, and
keeps the nearest.

Everything is float64 on the input's device.  The Symlet 8 taps below
were computed for this file by the spectral factorisation of Daubechies'
polynomial at 60 digits (Daubechies, Ten Lectures on Wavelets, 1992,
§6.4 and §8.1.1: the Symlet's root choice), then rounded to float64; the
published 16-digit taps (PyWavelets' ``sym8``, JWave's ``Symlet8``)
agree with them to 9·10⁻¹³.
"""
from __future__ import annotations

import math

import torch

from .modwt import median

#: Symlet 8 (16 taps, 8 vanishing moments): the scaling filter g.
SYMLET_8_LO = (
    -0.0033824159510050028, -0.0005421323318000107, 0.03169508781152599,
    0.007607487324976609, -0.14329423835127267, -0.061273359067811076,
    0.4813596512590534, 0.777185751699628, 0.36444189483617895,
    -0.0519458381078818, -0.027219029917103486, 0.04913717967373029,
    0.0038087520138944896, -0.014952258337062199, -0.0003029205147241331,
    0.001889950332767689,
)


def highpass(lo) -> tuple:
    """f[j] = (−1)^j·g[M − 1 − j]."""
    m = len(lo)
    return tuple((-1) ** j * lo[m - 1 - j] for j in range(m))


SYMLET_8 = (SYMLET_8_LO, highpass(SYMLET_8_LO))
BY_NAME = {"Symlet 8": SYMLET_8}

#: float32's unit roundoff
U32 = 2.0 ** -24
#: roundings a float32 step makes of each output, at most one a product:
#: the variance of its error is taken as ROUNDINGS·u² times Σ_j (g_j·x_j)²
ROUNDINGS = 16
#: how many of the model's standard deviations a coefficient may move:
#: three times the largest |float32 − float64| / σ of 7.5·10⁷ coefficients
#: of 192 cell rows (2.80, the port on the CPU; the card's is printed by
#: chip_smoke.py's phase 39)
DEVIATIONS = 8.0
#: additions in sequence along the longest path of a float32 sum of a
#: packet's costs, the bound :func:`cost_bounds` assumes of its order
SUM_DEPTH = 64
#: the most bases the check builds for a row
MAX_BASES = 16


def step(x: torch.Tensor, bank) -> torch.Tensor:
    """One analysis step of every packet along the last axis: [lo | hi]."""
    g, f = bank
    lo = hi = 0.0
    for j in range(len(g)):
        r = torch.roll(x, -j, dims=-1)[..., 0::2]   # x[(2i + j) mod h]
        lo = lo + g[j] * r
        hi = hi + f[j] * r
    return torch.cat([lo, hi], dim=-1)


def unstep(y: torch.Tensor, bank) -> torch.Tensor:
    """The adjoint of :func:`step` along the last axis."""
    g, f = bank
    half = y.shape[-1] // 2
    lo, hi = y[..., :half], y[..., half:]
    out = torch.zeros_like(y)
    for j in range(len(g)):
        spread = torch.zeros_like(y)
        spread[..., 0::2] = g[j] * lo + f[j] * hi    # at 2i, then moved by j
        out += torch.roll(spread, j, dims=-1)
    return out


def tree(x: torch.Tensor, bank, level: int) -> torch.Tensor:
    """(level + 1, rows, N) float64: row l the 2^l packets of level l."""
    rows, n = x.shape
    levels = [x.double()]
    for l in range(level):
        packets = levels[-1].reshape(rows, 1 << l, n >> l)
        levels.append(step(packets, bank).reshape(rows, n))
    return torch.stack(levels)


def sure(c: torch.Tensor) -> torch.Tensor:
    """SURE at t = 1 along the last axis."""
    c2 = c * c
    return (c.shape[-1] - 2.0 * (c2 <= 1.0).sum(-1)
            + torch.clamp_max(c2, 1.0).sum(-1))


def packets(tr: torch.Tensor, l: int) -> torch.Tensor:
    """(rows, 2^l, N/2^l): level l's packets."""
    return tr[l].reshape(tr.shape[1], 1 << l, -1)


def choose(costs: list) -> tuple[list, list]:
    """(split, margin) of every packet above the last level, each a list
    over l of (rows, 2^l): whether it splits, and its children's best sum
    less its own cost."""
    best = costs[-1]
    split, margin = [], []
    for cost in costs[-2::-1]:
        children = best.reshape(cost.shape + (2,)).sum(-1)
        split.append(children < cost)
        margin.append(children - cost)
        best = torch.minimum(children, cost)
    return split[::-1], margin[::-1]


def leaves(split: list) -> list:
    """The leaf masks, a list over l = 0 … L of (rows, 2^l)."""
    out = []
    reach = torch.ones_like(split[0])
    for s in split:
        out.append(reach & ~s)
        reach = torch.repeat_interleave(reach & s, 2, dim=-1)
    out.append(reach)
    return out


def threshold(tr: torch.Tensor) -> torch.Tensor:
    """(rows,): σ·√(2·ln N), σ = median(|d₁|)/0.6745."""
    n = tr.shape[-1]
    d1 = tr[1][:, n // 2:]
    return median(d1.abs()) / 0.6745 * math.sqrt(2.0 * math.log(n))


def synthesize(tr: torch.Tensor, masks: list, t: torch.Tensor, bank,
               mode: str = "soft") -> torch.Tensor:
    """(rows, N): the shrunk basis coefficients of ``tr`` from its leaves
    up to the root; ``t`` a threshold a row."""
    if mode not in ("soft", "hard"):
        raise ValueError(f"unknown mode {mode!r}")
    tt = t.reshape(-1, 1, 1)
    rec = None
    for l in range(tr.shape[0] - 1, -1, -1):
        coef = packets(tr, l)
        if mode == "soft":
            cut = torch.sign(coef) * torch.clamp_min(coef.abs() - tt, 0.0)
        else:
            cut = torch.where(coef.abs() > tt, coef, 0.0)
        cut[:, 0] = coef[:, 0]              # the low-pass packet is kept
        if rec is not None:
            joined = unstep(rec.reshape(coef.shape), bank)
            cut = torch.where(masks[l][..., None], cut, joined)
        rec = cut
    return rec.reshape(tr.shape[1], -1)


def _costs(tr: torch.Tensor, per_sample: bool) -> list:
    costs = [sure(packets(tr, l)) for l in range(tr.shape[0])]
    if per_sample:
        return costs
    return [c.sum(0, keepdim=True).expand_as(c) for c in costs]


def denoise(x: torch.Tensor, bank, level: int, mode: str = "soft",
            per_sample: bool = True) -> tuple[torch.Tensor, list]:
    """(the denoised (rows, N), the leaf masks), float64."""
    tr = tree(x, bank, level)
    split, _ = choose(_costs(tr, per_sample))
    masks = leaves(split)
    return synthesize(tr, masks, threshold(tr), bank, mode), masks


# -- the float32 check --------------------------------------------------------

def deviation(tr: torch.Tensor, bank) -> torch.Tensor:
    """(level + 1, rows, N): σ of each coefficient's float32 rounding error
    in a program that computes ``tr`` in float32 a step at a time.

    Each step's roundings are taken as independent, ROUNDINGS of them an
    output, each uniform within u of the step's terms (u = 2⁻²⁴): a
    level-l coefficient's error variance is the variance its inputs
    carry, through the squared taps, plus ROUNDINGS·u²·Σ_j (g_j·t_j)²,
    t the level l − 1 coefficients it reads.  The signal itself is exact."""
    squared = tuple(tuple(v * v for v in b) for b in bank)
    rows, n = tr.shape[1:]
    var = [torch.zeros_like(tr[0])]
    for l in range(1, tr.shape[0]):
        parent = packets(tr, l - 1)
        v = (step(var[-1].reshape(parent.shape), squared)
             + ROUNDINGS * U32 ** 2 * step(parent * parent, squared))
        var.append(v.reshape(rows, n))
    return torch.stack(var).sqrt()


def cost_bounds(tr: torch.Tensor, bank) -> list:
    """How far a float32 program's SURE cost of each packet may lie from
    the float64 cost: a list over l of (rows, 2^l).

    A coefficient c moves by δ = DEVIATIONS·σ (:func:`deviation`).  SURE
    at t = 1 a coefficient is c² − 1 for |c| ≤ 1, else 2: a coefficient
    within δ of 1 (and the rounding of c², u) may cross, and adds 2; the
    others at or below 1 + δ move by 2|c|·σ a standard deviation, which
    independent roundings add in quadrature, DEVIATIONS of them.  The
    packet's float32 sum of its w terms, and the arithmetic after it, add
    (SUM_DEPTH + 8)·u·w: the partial sums of a float32 reduction take at
    most SUM_DEPTH additions in sequence."""
    sigma = deviation(tr, bank)
    out = []
    for l in range(tr.shape[0]):
        c = packets(tr, l).abs()
        s = packets(sigma, l)
        d = DEVIATIONS * s
        cross = ((c - 1.0).abs() <= d + U32).double().sum(-1)
        slope = torch.where(c <= 1.0 + d + U32, 2.0 * c * s, 0.0)
        out.append(2.0 * cross
                   + DEVIATIONS * torch.sqrt((slope * slope).sum(-1))
                   + (SUM_DEPTH + 8) * U32 * c.shape[-1])
    return out


def slack(bounds: list) -> list:
    """Each packet's bound summed over it and every packet below it: a
    list over l = 0 … L − 1 of (rows, 2^l)."""
    below = bounds[-1]
    out = []
    for b in bounds[-2::-1]:
        below = b + below.reshape(b.shape + (2,)).sum(-1)
        out.append(below)
    return out[::-1]


def _count(split, opened, l, p) -> int:
    """Bases of the subtree under packet (l, p)."""
    if l == len(split):
        return 1
    n = int(opened[l][p] or not split[l][p])
    if opened[l][p] or split[l][p]:
        n += (_count(split, opened, l + 1, 2 * p)
              * _count(split, opened, l + 1, 2 * p + 1))
    return n


def _enumerate(split, opened, l, p) -> list:
    """Every basis of the subtree under packet (l, p), as tuples of leaf
    (l, p)."""
    if l == len(split):
        return [((l, p),)]
    out = [((l, p),)] if opened[l][p] or not split[l][p] else []
    if opened[l][p] or split[l][p]:
        out += [a + b for a in _enumerate(split, opened, l + 1, 2 * p)
                for b in _enumerate(split, opened, l + 1, 2 * p + 1)]
    return out


def bases(split: list, opened: list, row: int) -> tuple[int, list]:
    """(how many bases the open packets of ``row`` allow, their leaf masks
    as a list over l of (k, 2^l) bool, or None past MAX_BASES)."""
    sp = [s[row].tolist() for s in split]
    op = [o[row].tolist() for o in opened]
    count = _count(sp, op, 0, 0)
    if count > MAX_BASES:
        return count, None
    found = _enumerate(sp, op, 0, 0)
    level = len(split)
    masks = [torch.zeros((count, 1 << l), dtype=torch.bool,
                         device=split[0].device) for l in range(level + 1)]
    for k, leaf_set in enumerate(found):
        for l, p in leaf_set:
            masks[l][k, p] = True
    return count, masks


def candidates(x: torch.Tensor, bank, level: int, mode: str = "soft",
               per_sample: bool = True) -> tuple[list, list, list]:
    """For each row of ``x``: the (k, N) denoised rows of the k bases its
    open packets allow (None past MAX_BASES), k, and the count of its open
    packets.  Without ``per_sample`` all rows share each basis."""
    tr = tree(x, bank, level)
    split, margin = choose(_costs(tr, per_sample))
    bound = cost_bounds(tr, bank)
    if not per_sample:
        bound = [b.sum(0, keepdim=True).expand_as(b) for b in bound]
    opened = [m.abs() <= s for m, s in zip(margin, slack(bound))]
    t = threshold(tr)
    outs, counts, opens = [], [], []
    for row in range(x.shape[0]):
        k, masks = bases(split, opened, row)
        counts.append(k)
        opens.append(int(sum(int(o[row].sum()) for o in opened)))
        if masks is None:
            outs.append(None)
            continue
        rows = tr[:, row:row + 1].expand(-1, k, -1)
        outs.append(synthesize(rows, masks, t[row:row + 1].expand(k),
                               bank, mode))
    return outs, counts, opens


def error(got: torch.Tensor, x: torch.Tensor, bank, level: int,
          mode: str = "soft", per_sample: bool = True
          ) -> tuple[float, int, int]:
    """(the check's number, the most bases of a row, the most open packets
    of a row) of the program's denoised rows ``got`` of ``x``.

    The number is the largest gap between a row of ``got`` and its
    nearest candidate (the nearest basis shared by every row without
    ``per_sample``) over the largest magnitude of the candidates;
    infinite where a row allows more than MAX_BASES bases."""
    outs, counts, opens = candidates(x, bank, level, mode, per_sample)
    if any(o is None for o in outs):
        return math.inf, max(counts), max(opens)
    gaps = [(o - g).abs().amax(-1) for o, g in zip(outs, got.double())]
    if per_sample:
        gap = max(float(g.min()) for g in gaps)
    else:                     # every row has the same bases, in one order
        gap = float(torch.stack(gaps).amax(0).min())
    top = max(float(o.abs().max()) for o in outs)
    return gap / top, max(counts), max(opens)
