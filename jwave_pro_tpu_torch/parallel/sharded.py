"""Sharded transforms on ``torch.distributed``: signal-axis MODWT, FWT and
DTCWT through ring halo hops, overlap-save CWT, scale-sharded CWT, SSQ and
scattering, packet-sharded WPT and MODWPT, row-sharded 2D MODWT and FWT.

Counterpart of ``jwave_pro_tpu/parallel/sharded.py``; same names and
results.  JAX runs one controller and a ``shard_map`` body on each device;
here every rank is a process that runs the body on its own shard, and the
collectives go to the process group of the mesh dim the JAX body names:

  * a ring hop (``lax.ppermute``) is one ``batch_isend_irecv`` pair per
    step, addressed to global ranks; over a mesh dim of one rank it is the
    identity and posts nothing;
  * a tiled ``lax.all_gather``, ``lax.psum`` / ``lax.pmax`` and XLA's
    all-to-all are ``all_gather``, ``all_reduce`` and ``all_to_all``.

Every collective the tier posts goes through this module and is counted in
:data:`COLLECTIVES` by kind, with the bytes this rank handed it in
:data:`COLLECTIVE_BYTES` (the JAX tests read the same facts off the
compiled HLO).  Spans (``utils/profiling.span``) mark the signal-sharded
MODWT (``jwave.sharded.modwt``), each fetch of ring context
(``jwave.sharded.halo``) and each ring hop (``jwave.sharded.hop``).  A
function takes a DTensor or a plain tensor; a plain tensor is the global
value, the same on every rank (as JAX takes a host array), and each rank
keeps its own slice of it.  Results are DTensors placed as the JAX
function's ``out_specs``; ``.full_tensor()`` gathers one.
Hops and all-gathers are differentiable (the backward of a hop is the
opposite hop), so are the transforms built on them.  The gradient of a
plain-tensor input holds this rank's part; that of a DTensor is whole.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial

from ..ops.cwt import CWTResult, _host_grid, _on_device, cwt as _cwt
from ..ops.modwt import (
    _check_level, _combined_adjoint, _level_conv, _use_fft,
    modwt_base_filters, taps_as,
)
from ..kernels.modwt_cuda import halo as _halo, modwt_shard
from ..utils.device import as_input
from ..utils.profiling import spanned
from ..wavelets.base import DiscreteWavelet
from .mesh import P, mesh_device, placements

__all__ = [
    "modwt_sharded", "imodwt_sharded", "cwt_sharded", "cwt_signal_sharded",
    "cwt2_sharded", "wpt_sharded", "iwpt_sharded", "fwt2_sharded",
    "fwt_sharded", "ifwt_sharded", "gather_fwt_layout",
    "modwpt_sharded", "imodwpt_sharded",
    "scattering_sharded", "scattering2d_sharded", "ssq_sharded",
    "modwt2_sharded", "imodwt2_sharded", "dtcwt_sharded", "idtcwt_sharded",
    "COLLECTIVES", "COLLECTIVE_BYTES", "reset_collectives",
]

_KINDS = ("hop", "all_gather", "all_reduce_sum", "all_reduce_max",
          "all_to_all")

#: Collectives this tier has posted, by kind: ring hops, tiled all-gathers,
#: SUM and MAX all-reduces, all-to-alls.  An op over a group of one rank
#: posts nothing and counts nothing.  :func:`reset_collectives` sets them
#: to 0 (backward passes post and count theirs too).
COLLECTIVES = dict.fromkeys(_KINDS, 0)

#: Bytes this rank handed the collectives it posted, by kind: a hop's sent
#: block, an all-gather's shard, an all-reduce's operand, an all-to-all's
#: whole input.  Counted and reset with :data:`COLLECTIVES`.
COLLECTIVE_BYTES = dict.fromkeys(_KINDS, 0)


def reset_collectives() -> None:
    for kind in _KINDS:
        COLLECTIVES[kind] = COLLECTIVE_BYTES[kind] = 0


def _posted(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Placement: mesh axes, local shards, results.
# ---------------------------------------------------------------------------

def _axis(mesh: DeviceMesh, name: str):
    """(size, this rank's index, process group) of mesh dim ``name``."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes {names})")
    return (mesh.size(names.index(name)), mesh.get_local_rank(name),
            mesh.get_group(name))


def _has(mesh: DeviceMesh, name) -> bool:
    return bool(name) and name in (mesh.mesh_dim_names or ())


def _input(x, mesh: DeviceMesh):
    """A DTensor as it is; anything else a tensor on this rank's device."""
    if isinstance(x, DTensor):
        return x
    return as_input(x).to(mesh_device(mesh))


def _local(x, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's shard of ``x`` placed by ``spec``.

    A DTensor is redistributed to the spec first (DTensor's own
    collectives, where its placements differ); its gradient is Partial
    over the mesh dims the spec replicates.  A plain tensor is sliced:
    nothing is sent."""
    if isinstance(x, DTensor):
        pl = placements(mesh, spec)
        grads = [Partial() if p.is_replicate() else p for p in pl]
        return x.redistribute(mesh, pl).to_local(grad_placements=grads)
    for name in mesh.mesh_dim_names or ():
        if name not in spec:
            continue
        d = spec.index(name)
        n, i, _ = _axis(mesh, name)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} is not "
                             f"divisible by mesh axis {name}={n}")
        s = x.shape[d] // n
        x = x.narrow(d, i * s, s)
    return x


def _wrap(t: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """The local shards ``t`` as one DTensor placed by ``spec``."""
    return DTensor.from_local(t, mesh, placements(mesh, spec),
                              run_check=False)


def _specs(mesh: DeviceMesh, ndim: int, signal_axis: str,
           batch_axis: str | None) -> P:
    """PartitionSpec for (..., N) data: batch on leading, signal on last."""
    names = [None] * ndim
    if _has(mesh, batch_axis) and ndim > 1:
        names[0] = batch_axis
    names[-1] = signal_axis
    return P(*names)


def _batch_spec(mesh: DeviceMesh, ndim: int, batch_axis, min_ndim: int
                ) -> list:
    """``[batch_axis, None, …]`` of length ``ndim`` when the mesh has the
    batch axis and ``ndim`` exceeds ``min_ndim``, else all None."""
    spec = [None] * ndim
    if _has(mesh, batch_axis) and ndim > min_ndim:
        spec[0] = batch_axis
    return spec


# ---------------------------------------------------------------------------
# The ring and collective layer.
# ---------------------------------------------------------------------------

def _size(group) -> int:
    return dist.get_world_size(group)


@spanned("jwave.sharded.hop")
def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` ``shift`` places along the ring, receive from ``-shift``
    places: one ``batch_isend_irecv`` pair to global ranks."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    i = ranks.index(dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _posted("hop", x)
    return out


class _Hop(torch.autograd.Function):
    """A ring hop; its transpose is the opposite hop."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _send_recv(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _send_recv(grad, ctx.group, -ctx.shift), None, None


def _hop(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Every rank's ``x`` moved ``shift`` places along the ring of
    ``group`` (``lax.ppermute``); the identity on a one-rank ring, where
    gloo could not even address the send."""
    if _size(group) == 1:
        return x
    return _Hop.apply(x, group, shift)


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_real(out), op=op, group=group)
    _posted("all_reduce_sum" if op == dist.ReduceOp.SUM
            else "all_reduce_max", out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group into a replicated result (``lax.psum``).  Each
    rank's loss reads its own copy, so a rank's summand gets that copy's
    gradient: the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """MAX over the group (``lax.pmax``); no gradient flows through it."""
    return x.detach() if _size(group) == 1 else _reduce(
        x, group, dist.ReduceOp.MAX)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; its transpose sums the gradient over
    the group and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x, group=group)
        _posted("all_gather", x)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        i = dist.get_group_rank(ctx.group, dist.get_rank())
        total = _reduce(grad, ctx.group, dist.ReduceOp.SUM)
        return total.narrow(ctx.dim, i * ctx.width, ctx.width), None, None


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if _size(group) == 1 else _AllGather.apply(x, group, dim)


def _exchange(x: torch.Tensor, group, split: int, cat: int) -> torch.Tensor:
    n = _size(group)
    ins = [c.contiguous() for c in x.chunk(n, dim=split)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    _posted("all_to_all", x)
    return torch.cat(outs, dim=cat)


class _AllToAll(torch.autograd.Function):
    """Split ``split`` into the group's ranks, send part r to rank r,
    concatenate what arrives along ``cat``; the transpose swaps the two."""

    @staticmethod
    def forward(ctx, x, group, split, cat):
        ctx.group, ctx.split, ctx.cat = group, split, cat
        return _exchange(x, group, split, cat)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.cat, ctx.split), None, None, \
            None


def _all_to_all(x: torch.Tensor, group, split: int, cat: int):
    return x if _size(group) == 1 else _AllToAll.apply(x, group, split, cat)


@spanned("jwave.sharded.halo")
def _left_context(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Fetch ``halo`` samples of circular left context along the ring.

    Each hop sends only the samples the next rank keeps: one hop of the
    last ``halo`` samples when the halo fits in a shard.  A longer halo
    takes more hops: hop t brings a rank the tail of shard (i − t), which
    it passes on at the next hop."""
    s = x.shape[-1]
    pieces = []
    got = 0
    send = x
    while got < halo:
        take = min(halo - got, s)
        send = _hop(send[..., send.shape[-1] - take:], group, 1)
        pieces.append(send)
        got += take
    # nearest context first: the signal order is the reverse
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces[::-1],
                                                        dim=-1)


@spanned("jwave.sharded.halo")
def _right_context(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Fetch ``halo`` samples of circular right context along the ring,
    as :func:`_left_context` fetches the left."""
    s = x.shape[-1]
    pieces = []
    got = 0
    send = x
    while got < halo:
        take = min(halo - got, s)
        send = _hop(send[..., :take], group, -1)
        pieces.append(send)
        got += take
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


def _extend(x: torch.Tensor, halo: int, group, adjoint: bool):
    """(``x`` with ``halo`` samples of ring context, offset of ``x`` in
    it): left context for a convolution, right for its adjoint."""
    if adjoint:
        return torch.cat([x, _right_context(x, halo, group)], dim=-1), 0
    return torch.cat([_left_context(x, halo, group), x], dim=-1), halo


def _taps(xe: torch.Tensor, f, d: int, base: int, s: int, adjoint: bool):
    """Dilated conv on an extended block: y[n] = Σ_k f[k]·x[n − k·d]
    (adjoint: x[n + k·d]) for the ``s`` samples at ``base``."""
    step = d if adjoint else -d
    acc = None
    for k, c in enumerate(f):
        off = base + k * step
        t = c * xe[..., off:off + s]
        acc = t if acc is None else acc + t
    return acc


def _halo_adjoint(v, w, g, h, d: int, group):
    """One inverse MODWT level on the sharded last axis: V and W share one
    context fetch; returns adj(V, g) + adj(W, h)."""
    s = v.shape[-1]
    e, _ = _extend(torch.stack([v, w]), (len(g) - 1) * d, group,
                   adjoint=True)
    return _taps(e[0], g, d, 0, s, True) + _taps(e[1], h, d, 0, s, True)


# ---------------------------------------------------------------------------
# MODWT: signal axis sharded.
# ---------------------------------------------------------------------------

def _float_input(x, mesh):
    x = _input(x, mesh)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return x


@spanned("jwave.sharded.modwt")
def modwt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                  signal_axis: str = "signal", batch_axis: str = "data"):
    """Forward MODWT with the signal axis sharded across ``mesh``.

    Output layout matches :func:`..ops.modwt.modwt`: ``(level+1, ..., N)``
    with the last axis still sharded.  The only communication is one ring
    fetch of the whole halo, the (M−1)(2^L − 1) samples before the shard
    (one hop, more when the halo exceeds a shard); then every level runs
    on this rank: one launch of the forward kernel's context variant on a
    CUDA float32/bfloat16 shard, its plain version otherwise
    (:func:`..kernels.modwt_cuda.modwt_shard`).
    """
    x = _float_input(x, mesh)
    _check_level(x.shape[-1], level)
    n_dev, _, group = _axis(mesh, signal_axis)
    n_shard = x.shape[-1] // n_dev
    max_halo = (wavelet.length - 1) * (1 << (level - 1))
    if n_shard < 1 or max_halo > n_shard * n_dev:
        raise ValueError("halo exceeds total signal length")
    spec = _specs(mesh, x.ndim, signal_axis, batch_axis)
    v = _local(x, mesh, spec)
    ctx = _left_context(v, _halo(wavelet.length, level), group)
    return _wrap(modwt_shard(v, ctx, wavelet, level), mesh, P(None, *spec))


def imodwt_sharded(c, wavelet: DiscreteWavelet, mesh: DeviceMesh,
                   signal_axis: str = "signal", batch_axis: str = "data"):
    """Inverse MODWT with the signal axis sharded across ``mesh``."""
    c = _input(c, mesh)
    _, _, group = _axis(mesh, signal_axis)
    inner = _specs(mesh, c.ndim - 1, signal_axis, batch_axis)
    cl = _local(c, mesh, P(None, *inner))
    g64, h64 = modwt_base_filters(wavelet)
    g, h = taps_as(g64, cl.dtype), taps_as(h64, cl.dtype)
    level = cl.shape[0] - 1
    v = cl[level]
    for j in range(level, 0, -1):
        v = _halo_adjoint(v, cl[j - 1], g, h, 1 << (j - 1), group)
    return _wrap(v, mesh, inner)


# ---------------------------------------------------------------------------
# CWT: scale-sharded and signal-sharded (overlap-save).
# ---------------------------------------------------------------------------

def _time_axis(n: int, sampling_rate: float, device) -> torch.Tensor:
    return torch.as_tensor(np.arange(n) * (1.0 / sampling_rate),
                           device=device)


def cwt_sharded(x, scales, wavelet, mesh: DeviceMesh,
                sampling_rate: float = 1.0, scale_axis: str = "scale",
                batch_axis: str = "data", padding: str = "zero"
                ) -> CWTResult:
    """CWT with the scale axis sharded: no collectives.

    Each rank transforms the (replicated or batch-sharded) signal with its
    shard of the scales only (:func:`..ops.cwt.cwt`, ``method='auto'``).
    Coefficients ``(..., S, N)`` keep the scale axis sharded.
    """
    x = _input(x, mesh)
    scales_np = _host_grid(scales)
    n_dev, idx, _ = _axis(mesh, scale_axis)
    if scales_np.shape[0] % n_dev:
        raise ValueError(f"n_scales {scales_np.shape[0]} not divisible by "
                         f"mesh axis {scale_axis}={n_dev}")
    bspec = _batch_spec(mesh, x.ndim, batch_axis, 1)
    xl = _local(x, mesh, P(*bspec))
    k = scales_np.shape[0] // n_dev
    coeffs = _cwt(xl, scales_np[idx * k:(idx + 1) * k], wavelet,
                  sampling_rate, padding).coefficients
    dev = mesh_device(mesh)
    return CWTResult(_wrap(coeffs, mesh, P(*bspec[:-1], scale_axis, None)),
                     torch.as_tensor(scales_np, device=dev),
                     _time_axis(x.shape[-1], sampling_rate, dev),
                     sampling_rate, wavelet.name)


def _nyquist_aliased(wavelet, scales_np: np.ndarray,
                     sampling_rate: float) -> np.ndarray:
    """The scales whose relative |√a·ψ̂(a·ω)| at Nyquist exceeds 1e-3, on
    a 257-point grid up to Nyquist in float64 on the host."""
    grid = np.linspace(0.0, math.pi * sampling_rate, 257)[None, :]
    amp = np.abs(wavelet.psi_hat_scaled(
        torch.from_numpy(grid), torch.from_numpy(scales_np[:, None])
    ).numpy())
    nyq_rel = amp[:, -1] / np.maximum(amp.max(axis=-1), 1e-300)
    return scales_np[nyq_rel > 1e-3]


def cwt_signal_sharded(x, scales, wavelet, mesh: DeviceMesh,
                       sampling_rate: float = 1.0,
                       signal_axis: str = "signal",
                       batch_axis: str = "data", padding: str = "zero",
                       halo: int | None = None,
                       halo_factor: float = 2.0,
                       check_aliasing: bool = True) -> CWTResult:
    """CWT of a LONG signal with the time axis sharded: overlap-save blocks.

    Each rank fetches ``halo`` samples of context from both ring
    neighbours (more hops when the halo exceeds a shard), transforms the
    extended block with :func:`..ops.cwt.cwt` and keeps its centre.  Ring
    hops are the only collectives.

    ``halo`` defaults to ``max(scales)`` × the wavelet's unit-scale
    effective support radius × ``halo_factor`` (2.0 keeps the integrated
    tail beyond the halo ≤ 1e-14 for the Gaussian-envelope families),
    clamped to the rest of the ring.  The result matches the single-device
    periodic-padding CWT.  Scales whose relative |ψ̂| at Nyquist exceeds
    1e-3 carry spectral-truncation tails no halo covers and are rejected
    unless ``check_aliasing=False``.  Coefficients ``(..., S, N)`` keep
    the time axis sharded.
    """
    x = _input(x, mesh)
    scales_np = _host_grid(scales)
    n = x.shape[-1]
    n_dev, _, group = _axis(mesh, signal_axis)
    if n % n_dev:
        raise ValueError(f"signal length {n} not divisible by mesh axis "
                         f"{signal_axis}={n_dev}")
    nloc = n // n_dev
    if halo is None:
        lo, hi = wavelet.effective_support()
        halo = int(np.ceil(float(scales_np.max()) * max(abs(lo), abs(hi))
                           * halo_factor))
    halo = min(halo, n - nloc)  # context beyond the rest of the ring is moot
    if halo >= n:
        raise ValueError("halo exceeds total signal length")
    if check_aliasing:
        bad = _nyquist_aliased(wavelet, scales_np, float(sampling_rate))
        if bad.size:
            raise ValueError(
                f"scales {bad} are Nyquist-aliased (relative |ψ̂(a·π·fs)| > "
                f"1e-3): their spectral-truncation tails exceed any block "
                f"halo.  Drop them or pass check_aliasing=False.")

    bspec = _batch_spec(mesh, x.ndim - 1, batch_axis, 0)
    xl = _local(x, mesh, P(*bspec, signal_axis))
    if halo > 0:
        xl = torch.cat([_left_context(xl, halo, group), xl,
                        _right_context(xl, halo, group)], dim=-1)
    c = _cwt(xl, scales_np, wavelet, sampling_rate, padding).coefficients
    coeffs = _wrap(c[..., halo:halo + nloc].contiguous(), mesh,
                   P(*bspec, None, signal_axis))
    dev = mesh_device(mesh)
    return CWTResult(coeffs, torch.as_tensor(scales_np, device=dev),
                     _time_axis(n, sampling_rate, dev), sampling_rate,
                     wavelet.name)


@functools.lru_cache(maxsize=8)
def _cwt2_planes(wavelet, scales: tuple, angles, h: int, w: int,
                 sampling_rate: float, use_real: bool, by_angle: bool,
                 idx: int, n_dev: int) -> np.ndarray:
    """This rank's planes of the 2D multiplier stack: a block of scales
    (every angle), or with ``by_angle`` a block of angles (every scale)."""
    from ..ops.cwt2d import _multipliers2d

    m = _multipliers2d(wavelet, scales, angles, h, w, sampling_rate,
                       use_real)
    if not by_angle:
        k = m.shape[0] // n_dev
        return np.ascontiguousarray(m[idx * k:(idx + 1) * k])
    a = len(angles) // n_dev
    m = m.reshape((len(scales), len(angles)) + m.shape[1:])
    return np.ascontiguousarray(
        m[:, idx * a:(idx + 1) * a].reshape((-1,) + m.shape[2:]))


def cwt2_sharded(x, scales, wavelet=None, mesh: DeviceMesh | None = None,
                 angles=None, sampling_rate: float = 1.0,
                 scale_axis: str = "scale", batch_axis: str = "data"):
    """2D CWT with the (scale × angle) planes sharded: no collectives.

    Each rank FFTs its (replicated or batch-sharded) image and inverse-
    transforms only its own planes of the host multiplier stack
    (``ops/cwt2d.py:_multipliers2d``); real-even stacks stay real.  The
    coefficients ``(..., S, H, W)`` or ``(..., S, A, H, W)`` are sharded
    over the scale axis, or over the angle axis when the mesh axis divides
    the angles and not the scales (one of the two must divide).
    """
    from ..ops.cwt2d import CWT2Result
    from ..wavelets.continuous2d import MexicanHat2D

    if wavelet is None:
        wavelet = MexicanHat2D()
    if mesh is None:
        raise ValueError("cwt2_sharded needs an explicit Mesh")
    x = _input(x, mesh)
    if not (x.is_floating_point() or x.is_complex()) or x.dtype in (
            torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    if x.ndim < 2:
        raise ValueError("cwt2_sharded needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    scales_np = _host_grid(scales)
    angles_np = None if angles is None else _host_grid(angles)
    scales_t = tuple(float(a) for a in scales_np)
    angles_t = (None if angles_np is None
                else tuple(float(t) for t in angles_np))
    n_planes = len(scales_t) * (1 if angles_t is None else len(angles_t))
    n_dev, idx, _ = _axis(mesh, scale_axis)
    if n_planes % n_dev:
        raise ValueError(f"(scales × angles) = {n_planes} planes not "
                         f"divisible by mesh axis {scale_axis}={n_dev}")
    by_angle = len(scales_t) % n_dev != 0
    if by_angle and len(angles_t) % n_dev:
        raise ValueError(f"mesh axis {scale_axis}={n_dev} divides neither "
                         f"the {len(scales_t)} scales nor the "
                         f"{len(angles_t)} angles")
    use_real = wavelet.real_even_hat and not x.is_complex()
    f64 = x.dtype in (torch.float64, torch.complex128)
    cdtype = torch.complex128 if f64 else torch.complex64
    rdtype = torch.float64 if f64 else torch.float32
    m_np = _cwt2_planes(wavelet, scales_t, angles_t, h, w,
                        float(sampling_rate), use_real, by_angle, idx, n_dev)

    bspec = _batch_spec(mesh, x.ndim, batch_axis, 2)
    xl = _local(x, mesh, P(*bspec))
    if use_real:
        xf = torch.fft.rfft2(xl, dim=(-2, -1))[..., None, :, :]
        coeff = torch.fft.irfft2(xf * _on_device(m_np, xl.device, rdtype),
                                 s=(h, w), dim=(-2, -1)).to(rdtype)
    else:
        xf = torch.fft.fft2(xl.to(cdtype), dim=(-2, -1))[..., None, :, :]
        coeff = torch.fft.ifft2(xf * _on_device(m_np, xl.device, cdtype),
                                dim=(-2, -1))
    lead = tuple(xl.shape[:-2])
    dev = mesh_device(mesh)
    if angles_t is None:
        coeff = coeff.reshape(lead + (-1, h, w))
        spec = P(*bspec[:-2], scale_axis, None, None)
        angles_arr = None
    else:
        n_s = len(scales_t) if by_angle else len(scales_t) // n_dev
        coeff = coeff.reshape(lead + (n_s, -1, h, w))
        spec = (P(*bspec[:-2], None, scale_axis, None, None) if by_angle
                else P(*bspec[:-2], scale_axis, None, None, None))
        angles_arr = torch.as_tensor(angles_np, device=dev).to(rdtype)
    return CWT2Result(_wrap(coeff, mesh, spec),
                      torch.as_tensor(scales_np, device=dev).to(rdtype),
                      angles_arr, sampling_rate, wavelet.name)


# ---------------------------------------------------------------------------
# Packet trees: subtrees distributed over the packet axis.
# ---------------------------------------------------------------------------

def _packet_axis(mesh: DeviceMesh, name: str):
    n_dev, idx, group = _axis(mesh, name)
    if n_dev & (n_dev - 1):
        raise ValueError(f"packet mesh axis must be a power of two, "
                         f"got {n_dev}")
    return n_dev, idx, group


def wpt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                packet_axis: str = "scale", batch_axis: str = "data"):
    """WPT with the packet subtrees distributed across ranks: levels 1..k
    (k = log2(n_dev)) run replicated — their packets span ranks — and
    every deeper level on the rank's own level-k packet, with no
    collective.  The flat WPT layout, last axis sharded over
    ``packet_axis``; with fewer levels than k the rows are just
    distributed at the deepest level computed."""
    from ..ops.wpt import wpt as _wpt

    x = _input(x, mesh)
    n_dev, idx, _ = _packet_axis(mesh, packet_axis)
    n = x.shape[-1]
    if n % n_dev:
        raise ValueError("signal length not divisible by packet mesh axis")
    k = n_dev.bit_length() - 1
    if level < k and n_dev > 1:
        k = level
    bspec = _batch_spec(mesh, x.ndim - 1, batch_axis, 0)
    xl = _local(x, mesh, P(*bspec, None))
    y = _wpt(xl, wavelet, k) if k else xl
    seg = n // n_dev
    local = y[..., idx * seg:(idx + 1) * seg]
    if level > k:
        local = _wpt(local, wavelet, level - k)
    return _wrap(local, mesh, P(*bspec, packet_axis))


def iwpt_sharded(y, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                 packet_axis: str = "scale", batch_axis: str = "data"):
    """Inverse of :func:`wpt_sharded`: the local levels invert with no
    communication, ONE tiled all-gather reassembles the level-k row, the
    top k levels invert replicated, and each rank keeps its slice."""
    from ..ops.wpt import iwpt as _iwpt

    y = _input(y, mesh)
    n_dev, idx, group = _packet_axis(mesh, packet_axis)
    if y.shape[-1] % n_dev:
        raise ValueError("signal length not divisible by packet mesh axis")
    k = min(n_dev.bit_length() - 1, level)
    bspec = _batch_spec(mesh, y.ndim - 1, batch_axis, 0)
    spec = P(*bspec, packet_axis)
    yl = _local(y, mesh, spec)
    seg = yl.shape[-1]
    if level > k:
        yl = _iwpt(yl, wavelet, level - k)
    full = _all_gather(yl, group, dim=-1)
    if k:
        full = _iwpt(full, wavelet, k)
    return _wrap(full[..., idx * seg:(idx + 1) * seg], mesh, spec)


def modwpt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                   node_axis: str = "scale", batch_axis: str = "data",
                   method: str = "direct"):
    """MODWPT with the packet-node subtrees distributed across ranks.

    Levels 1..k (k = log2(n_dev)) run replicated, then each rank keeps ONE
    level-k node and computes its whole subtree — a contiguous sequency
    block — with no collective.  The filter assignment at the first local
    level depends on the parity of the rank's index: an odd rank swaps the
    pair.  Output ``(2^level, ..., N)`` has the node axis sharded over
    ``node_axis``; needs ``level ≥ log2(n_dev)``.
    """
    from ..ops.modwpt import _level_forward

    x = _float_input(x, mesh)
    n_dev, idx, _ = _packet_axis(mesh, node_axis)
    k = n_dev.bit_length() - 1
    if level < k:
        raise ValueError(
            f"MODWPT level {level} must be ≥ log2(n_dev)={k} to give every "
            "device a whole subtree")
    _check_level(x.shape[-1], level)
    bspec = _batch_spec(mesh, x.ndim, batch_axis, 1)
    xl = _local(x, mesh, P(*bspec))
    g, h = modwt_base_filters(wavelet)
    nodes = xl[None]
    for j in range(1, k + 1):
        nodes = _level_forward(nodes, g, h, j, method)
    if k:
        nodes = nodes[idx:idx + 1]
    for j in range(k + 1, level + 1):
        if nodes.shape[0] > 1:
            nodes = _level_forward(nodes, g, h, j, method)
            continue
        gv, hv = _level_conv(nodes, g, h, j, method)
        nodes = torch.cat([hv, gv] if idx % 2 else [gv, hv], dim=0)
    return _wrap(nodes, mesh, P(node_axis, *bspec))


def imodwpt_sharded(y, wavelet: DiscreteWavelet, mesh: DeviceMesh,
                    node_axis: str = "scale", batch_axis: str = "data",
                    method: str = "direct"):
    """Inverse of :func:`modwpt_sharded` (node-sharded in, signal out).

    Local subtrees invert with no communication; ONE tiled all-gather
    reassembles the 2^k level-k nodes before the replicated top-k adjoint.
    The signal comes back with its last axis sharded over ``node_axis``
    (its length must divide by n_dev).
    """
    from ..ops.modwpt import _level_inverse

    y = _input(y, mesh)
    p = y.shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(
            f"leading axis must be 2^level ≥ 2 packet nodes, got {p}")
    level = p.bit_length() - 1
    n_dev, idx, group = _packet_axis(mesh, node_axis)
    k = n_dev.bit_length() - 1
    if level < k:
        raise ValueError(
            f"MODWPT level {level} must be ≥ log2(n_dev)={k}")
    if y.shape[-1] % n_dev:
        raise ValueError("signal length not divisible by node mesh axis")
    bspec = _batch_spec(mesh, y.ndim - 2, batch_axis, 0)
    local = _local(y, mesh, P(node_axis, *bspec, None))
    g, h = modwt_base_filters(wavelet)
    n = local.shape[-1]
    for j in range(level, k, -1):
        if local.shape[0] > 2:
            local = _level_inverse(local, g, h, j, method)
            continue
        nat = local.flip(0) if idx % 2 else local
        child_g, child_h = nat[0:1], nat[1:2]
        d = 1 << (j - 1)
        if _use_fft(method, n, g.shape[0], d):
            va, wa = _level_conv(child_g, g, h, j, method, adjoint=True,
                                 w=child_h)
            local = va + wa
        else:
            local = _combined_adjoint(child_g, child_h,
                                      taps_as(g, local.dtype),
                                      taps_as(h, local.dtype), d)
    if k:
        local = _all_gather(local, group, dim=0)
        for j in range(k, 0, -1):
            local = _level_inverse(local, g, h, j, method)
    seg = n // n_dev
    return _wrap(local[0, ..., idx * seg:(idx + 1) * seg], mesh,
                 P(*bspec, node_axis))


# ---------------------------------------------------------------------------
# Decimated pyramids: row-sharded 2D FWT, signal-sharded FWT and DTCWT.
# ---------------------------------------------------------------------------

def fwt2_sharded(m, wavelet: DiscreteWavelet, mesh: DeviceMesh,
                 batch_axis: str = "data"):
    """2D FWT with the rows sharded across ``batch_axis``.

    The row transforms (along the last axis) run on each rank's own rows;
    one all-to-all shards the columns for the column transforms, and a
    second puts the rows back: the result is sharded as the input.
    """
    from ..ops.fwt import fwt as _fwt

    m = _input(m, mesh)
    n_dev, _, group = _axis(mesh, batch_axis)
    if m.shape[-1] % n_dev:
        raise ValueError(f"{m.shape[-1]} columns not divisible by mesh axis "
                         f"{batch_axis}={n_dev}")
    spec = P(*([None] * (m.ndim - 2)), batch_axis, None)
    rows = _fwt(_local(m, mesh, spec), wavelet)
    cols = _all_to_all(rows, group, split=-1, cat=-2)
    cols = torch.swapaxes(_fwt(torch.swapaxes(cols, -1, -2), wavelet),
                          -1, -2)
    return _wrap(_all_to_all(cols, group, split=-2, cat=-1), mesh, spec)


def _local_analysis(active, ctx, wavelet: DiscreteWavelet):
    """Non-circular analysis of a local segment with right context:
    lo[i] = Σ_j ext[2i+j]·g[j] with ext = [active | ctx]; valid for every
    i < len(active)/2 because len(ctx) = M−2 (no wrap ever needed)."""
    h = active.shape[-1]
    ext = torch.cat([active, ctx], dim=-1)
    g = taps_as(wavelet.dec_lo, active.dtype)
    f = taps_as(wavelet.dec_hi, active.dtype)
    lo = hi = None
    for j in range(wavelet.length):
        seg = ext[..., j:j + h - 1:2]   # j, j+2, …, j+h−2: h/2 entries
        tl, th = g[j] * seg, f[j] * seg
        lo = tl if lo is None else lo + tl
        hi = th if hi is None else hi + th
    return lo, hi


def _local_synthesis(lo, hi, lo_ctx, hi_ctx, wavelet: DiscreteWavelet):
    """Adjoint of :func:`_local_analysis` with left context:
    x[k] = Σ_{i,j: 2i+j = k} lo[i]·rl[j] + hi[i]·rh[j], where i may reach
    ⌈(M−1)/2⌉ entries into the left neighbour (``*_ctx``, newest last).
    The scatter runs as a gather per output phase, interleaved at the
    end."""
    half = lo.shape[-1]
    c = lo_ctx.shape[-1]
    rl = taps_as(wavelet.rec_lo, lo.dtype)
    rh = taps_as(wavelet.rec_hi, lo.dtype)
    lo_e = torch.cat([lo_ctx, lo], dim=-1)
    hi_e = torch.cat([hi_ctx, hi], dim=-1)
    even = odd = None
    for j in range(wavelet.length):
        start = c - j // 2
        contrib = (rl[j] * lo_e[..., start:start + half]
                   + rh[j] * hi_e[..., start:start + half])
        if j % 2 == 0:
            even = contrib if even is None else even + contrib
        else:
            odd = contrib if odd is None else odd + contrib
    if odd is None:
        odd = torch.zeros_like(even)
    res = torch.stack([even, odd], dim=-1).reshape(
        lo.shape[:-1] + (2 * half,))
    if wavelet.energy_correction != 1.0:
        res = res * taps_as([wavelet.energy_correction], lo.dtype)[0]
    return res


def _analysis_step(v, wavelet: DiscreteWavelet, group):
    ctx = (_right_context(v, wavelet.length - 2, group)
           if wavelet.length > 2 else v[..., :0])
    return _local_analysis(v, ctx, wavelet)


def _synthesis_step(lo, hi, wavelet: DiscreteWavelet, group):
    """lo and hi share one left-context fetch."""
    ctx = _left_context(torch.stack([lo, hi]), (wavelet.length + 1) // 2,
                        group)
    return _local_synthesis(lo, hi, ctx[0], ctx[1], wavelet)


def _check_shard_levels(n: int, n_dev: int, level: int) -> None:
    if (n // n_dev) % (1 << level) != 0:
        raise ValueError(f"shard length {n // n_dev} not divisible by "
                         f"2^{level}")


def fwt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                signal_axis: str = "signal", batch_axis: str = "data"):
    """Signal-sharded multi-level FWT (per-shard prefix layout).

    Per level one ring fetch brings the M−2 right-context samples of the
    next shard's active prefix.  Each result shard keeps the reference's
    ``[approx | detail]`` prefix layout *locally*;
    :func:`gather_fwt_layout` turns the gathered shards into the
    single-device layout.  Needs (N / n_shards) % 2^level == 0.
    """
    x = _float_input(x, mesh)
    n_dev, _, group = _axis(mesh, signal_axis)
    _check_shard_levels(x.shape[-1], n_dev, level)
    spec = _specs(mesh, x.ndim, signal_axis, batch_axis)
    out = _local(x, mesh, spec)
    h = out.shape[-1]
    for _ in range(level):
        lo, hi = _analysis_step(out[..., :h], wavelet, group)
        out = torch.cat([lo, hi, out[..., h:]], dim=-1)
        h //= 2
    return _wrap(out, mesh, spec)


def ifwt_sharded(y, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                 signal_axis: str = "signal", batch_axis: str = "data"):
    """Inverse of :func:`fwt_sharded` (the same per-shard layout in and
    out)."""
    y = _input(y, mesh)
    n_dev, _, group = _axis(mesh, signal_axis)
    _check_shard_levels(y.shape[-1], n_dev, level)
    spec = _specs(mesh, y.ndim, signal_axis, batch_axis)
    out = _local(y, mesh, spec)
    nloc = out.shape[-1]
    for h in reversed([nloc >> l for l in range(level)]):
        rec = _synthesis_step(out[..., :h // 2], out[..., h // 2:h],
                              wavelet, group)
        out = torch.cat([rec, out[..., h:]], dim=-1)
    return _wrap(out, mesh, spec)


def gather_fwt_layout(y, level: int, n_shards: int) -> torch.Tensor:
    """Convert the per-shard prefix layout → the single-device layout.

    Band boundaries per shard: [approx(w_L) | d_L(w_L) | d_{L-1}(2w_L) | …];
    the global layout concatenates each band across shards in order.  A
    DTensor is gathered first.
    """
    y = y.full_tensor() if isinstance(y, DTensor) else as_input(y)
    loc = y.shape[-1] // n_shards
    shards = y.reshape(y.shape[:-1] + (n_shards, loc))
    sizes = [loc >> level] + [loc >> (level - l) for l in range(level)]
    pieces = []
    off = 0
    for sz in sizes:
        pieces.append(shards[..., :, off:off + sz].reshape(
            y.shape[:-1] + (-1,)))
        off += sz
    return torch.cat(pieces, dim=-1)


def dtcwt_sharded(x, level: int, mesh: DeviceMesh, level1=None, k: int = 4,
                  l: int = 3, signal_axis: str = "signal",
                  batch_axis: str = "data"):
    """Signal-sharded dual-tree complex WT (parity layout with
    :func:`..ops.dtcwt.dtcwt`).

    Both orthonormal trees ride the decimating halo ring (one right-context
    fetch a level a tree); tree b's one-sample level-1 offset is a
    one-sample fetch.  Every subband's shards are contiguous slices of the
    global decimated signal, so the outputs match ``dtcwt`` elementwise
    with no gather step.  Needs (N / n_shards) % 2^level == 0.
    """
    from ..ops.dtcwt import DTCWTResult, _cplx, _tree_params

    x = _float_input(x, mesh)
    n_dev, _, group = _axis(mesh, signal_axis)
    _check_shard_levels(x.shape[-1], n_dev, level)
    w1, wa, wb = _tree_params(level1, k, l)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    spec = _specs(mesh, x.ndim, signal_axis, batch_axis)
    xl = _local(x, mesh, spec)
    xb = torch.cat([xl[..., 1:], _right_context(xl, 1, group)], dim=-1)
    la, ha = _analysis_step(xl, w1, group)
    lb, hb = _analysis_step(xb, w1, group)
    highs = [_cplx(ha, hb, inv_sqrt2)]
    for _ in range(2, level + 1):
        la, ha = _analysis_step(la, wa, group)
        lb, hb = _analysis_step(lb, wb, group)
        highs.append(_cplx(ha, hb, inv_sqrt2))
    return DTCWTResult(highpass=tuple(_wrap(t, mesh, spec) for t in highs),
                       lowpass_a=_wrap(la, mesh, spec),
                       lowpass_b=_wrap(lb, mesh, spec))


def idtcwt_sharded(res, mesh: DeviceMesh, level1=None, k: int = 4,
                   l: int = 3, signal_axis: str = "signal",
                   batch_axis: str = "data"):
    """Inverse of :func:`dtcwt_sharded` (exact, each tree orthonormal)."""
    from ..ops.dtcwt import _tree_params

    w1, wa, wb = _tree_params(level1, k, l)
    sqrt2 = math.sqrt(2.0)
    _, _, group = _axis(mesh, signal_axis)
    la = _input(res.lowpass_a, mesh)
    spec = _specs(mesh, la.ndim, signal_axis, batch_axis)
    la = _local(la, mesh, spec)
    lb = _local(_input(res.lowpass_b, mesh), mesh, spec)
    highs = [_local(_input(w, mesh), mesh, spec) for w in res.highpass]
    for w in highs[:0:-1]:
        la = _synthesis_step(la, sqrt2 * w.real, wa, group)
        lb = _synthesis_step(lb, sqrt2 * w.imag, wb, group)
    xa = _synthesis_step(la, sqrt2 * highs[0].real, w1, group)
    xb = _synthesis_step(lb, sqrt2 * highs[0].imag, w1, group)
    xb = torch.cat([_left_context(xb, 1, group), xb[..., :-1]], dim=-1)
    return _wrap(0.5 * (xa + xb), mesh, spec)


# ---------------------------------------------------------------------------
# Scattering: first-order paths sharded, second order local.
# ---------------------------------------------------------------------------

def _pad_pairs(i1: np.ndarray, l1: int, n_dev: int):
    """Per-rank second-order path tables padded to the largest rank's
    count, each (n_dev, P_max): the path's index into the pair table, its
    first-order index relative to the rank's block, and whether the row is
    a path (False on padding)."""
    loc = l1 // n_dev
    per = [np.nonzero((i1 >= d * loc) & (i1 < (d + 1) * loc))[0]
           for d in range(n_dev)]
    pmax = max(max((len(p) for p in per), default=0), 1)
    sel = np.zeros((n_dev, pmax), dtype=np.int64)
    i1_rel = np.zeros((n_dev, pmax), dtype=np.int64)
    real = np.zeros((n_dev, pmax), dtype=bool)
    for d, idx in enumerate(per):
        sel[d, :len(idx)] = idx
        i1_rel[d, :len(idx)] = i1[idx] - d * loc
        real[d, :len(idx)] = True
    return sel, i1_rel, real


@functools.lru_cache(maxsize=8)
def _scattering_shard(n: int, j: int, q: int, n_dev: int, idx: int):
    """This rank's ψ¹ block, its zero-padded ψ² rows and envelope indices,
    and the whole padded pairs table (-1 on padding rows)."""
    from ..ops.scattering import _pair_table, scattering_filters

    psi1, _, psi2, xi2, _ = scattering_filters(n, j, q)
    i1, i2 = _pair_table(n, j, q)
    loc = psi1.shape[0] // n_dev
    sel, i1_rel, real = _pad_pairs(i1, psi1.shape[0], n_dev)
    psi2_pad = np.where(real[idx][:, None], psi2[i2[sel[idx]]], 0.0) \
        if i1.size else np.zeros((1, n))
    pairs = np.full(sel.shape + (2,), -1.0)
    if i1.size:
        pairs[..., 0] = np.where(real, i1[sel], -1.0)
        pairs[..., 1] = np.where(real, xi2[i2[sel]], -1.0)
    return (np.ascontiguousarray(psi1[idx * loc:(idx + 1) * loc]),
            np.ascontiguousarray(psi2_pad), i1_rel[idx],
            pairs.reshape(-1, 2))


def scattering_sharded(x, j: int, q: int = 8, order: int = 2,
                       mesh: DeviceMesh | None = None,
                       scale_axis: str = "scale",
                       batch_axis: str = "data",
                       subsample: int | None = None):
    """Wavelet scattering with the first-order path axis sharded.

    Every second-order path (λ, μ) reads one first-order envelope U1[λ],
    so sharding λ makes the whole second order local: no collectives.
    Each rank FFTs the signal once, applies its L1/n_dev first-order
    filters at full resolution and runs its own second-order paths.  The
    per-rank path lists are padded to the longest with all-zero ψ² rows
    (exactly zero outputs): ``s2`` has ``n_dev·P_max`` rows in rank-major
    order and ``pairs`` marks the padding rows with ``i1 = -1``; keep
    ``pairs[:, 0] >= 0`` to recover the unsharded path order.
    """
    from ..ops.scattering import (
        ScatteringResult, _lowpass_subsample, _pair_table, scattering_filters)

    if mesh is None:
        raise ValueError("scattering_sharded requires a mesh "
                         "(use ops.scattering.scattering1d single-device)")
    x = _input(x, mesh)
    if x.is_complex():
        raise ValueError("scattering_sharded expects a real signal")
    n = x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or n % t:
        raise ValueError(f"subsample stride {t} must divide N={n}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    n_dev, idx, _ = _axis(mesh, scale_axis)
    _, xi1, _, _, phi_np = scattering_filters(n, j, q)
    if len(xi1) % n_dev:
        raise ValueError(f"first-order path count L1 = J·Q = {len(xi1)} not "
                         f"divisible by mesh axis {scale_axis}={n_dev}")
    rdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    psi1, psi2, i1_rel, pairs = _scattering_shard(n, j, q, n_dev, idx)
    want2 = order == 2 and _pair_table(n, j, q)[0].size > 0

    bspec = _batch_spec(mesh, x.ndim, batch_axis, 1)
    xl = _local(x, mesh, P(*bspec)).to(rdt)
    dev = xl.device
    phi = _on_device(phi_np, dev, rdt)
    xhat = torch.fft.fft(xl)
    s0 = _lowpass_subsample(xhat, phi, t)
    u1 = torch.abs(torch.fft.ifft(xhat[..., None, :]
                                  * _on_device(psi1, dev, rdt)))
    u1hat = torch.fft.fft(u1)
    s1 = _lowpass_subsample(u1hat, phi, t)
    lead = bspec[:-1]
    s2 = None
    if want2:
        u2hat = (u1hat.index_select(-2, _on_device(i1_rel, dev, torch.int64))
                 * _on_device(psi2, dev, rdt))
        u2 = torch.abs(torch.fft.ifft(u2hat))
        s2 = _wrap(_lowpass_subsample(torch.fft.fft(u2), phi, t), mesh,
                   P(*lead, scale_axis, None))
    elif order == 2:
        s2 = torch.zeros((*x.shape[:-1], 0, n // t), dtype=rdt, device=dev)
    return ScatteringResult(
        s0=_wrap(s0, mesh, P(*bspec)),
        s1=_wrap(s1, mesh, P(*lead, scale_axis, None)), s2=s2, xi1=xi1,
        pairs=pairs if want2 else np.zeros((0, 2)))


@functools.lru_cache(maxsize=8)
def _scattering2d_shard(h: int, w: int, j: int, l: int, slant: float,
                        n_dev: int, idx: int):
    """The 2D counterpart of :func:`_scattering_shard`; ``pairs`` rows are
    (i1, j2, θ2), -1 on padding rows."""
    from ..ops.scattering2d import _pair_table2d, scattering2d_filters

    psi, _, _ = scattering2d_filters(h, w, j, l, slant)
    i1, j2, t2 = _pair_table2d(j, l)
    loc = psi.shape[0] // n_dev
    sel, i1_rel, real = _pad_pairs(i1, psi.shape[0], n_dev)
    if i1.size:
        rows = j2[sel[idx]] * l + t2[sel[idx]]
        psi2_pad = np.where(real[idx][:, None, None], psi[rows], 0.0)
        pairs = np.where(real[..., None],
                         np.stack([i1[sel], j2[sel], t2[sel]], axis=-1), -1)
    else:
        psi2_pad = np.zeros((1, h, w))
        pairs = np.full(sel.shape + (3,), -1, dtype=np.int64)
    return (np.ascontiguousarray(psi[idx * loc:(idx + 1) * loc]),
            np.ascontiguousarray(psi2_pad), i1_rel[idx],
            pairs.reshape(-1, 3).astype(np.int64))


def scattering2d_sharded(x, j: int, l: int = 8, order: int = 2,
                         mesh: DeviceMesh | None = None,
                         scale_axis: str = "scale",
                         batch_axis: str = "data",
                         subsample: int | None = None, slant: float = 0.5):
    """2D wavelet scattering with the first-order (j₁, θ₁) path axis
    sharded: the image analog of :func:`scattering_sharded` (no
    collectives, padded rank-major ``s2``, ``pairs`` rows (i1, j2, θ2)
    with ``i1 = -1`` on padding rows)."""
    from ..ops.scattering2d import (
        Scattering2DResult, _lowpass_subsample2, _pair_table2d,
        scattering2d_filters)

    if mesh is None:
        raise ValueError("scattering2d_sharded requires a mesh "
                         "(use ops.scattering2d.scattering2d single-device)")
    x = _input(x, mesh)
    if x.is_complex():
        raise ValueError("scattering2d_sharded expects a real image")
    h, w = x.shape[-2], x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or h % t or w % t:
        raise ValueError(f"subsample stride {t} must divide H={h} and W={w}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    n_dev, idx, _ = _axis(mesh, scale_axis)
    _, phi_np, meta1 = scattering2d_filters(h, w, j, l, slant)
    if meta1.shape[0] % n_dev:
        raise ValueError(f"first-order path count J·L = {meta1.shape[0]} "
                         f"not divisible by mesh axis {scale_axis}={n_dev}")
    rdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    psi1, psi2, i1_rel, pairs = _scattering2d_shard(h, w, j, l, float(slant),
                                                    n_dev, idx)
    want2 = order == 2 and _pair_table2d(j, l)[0].size > 0

    bspec = _batch_spec(mesh, x.ndim, batch_axis, 2)
    xl = _local(x, mesh, P(*bspec)).to(rdt)
    dev = xl.device
    phi = _on_device(phi_np, dev, rdt)
    xhat = torch.fft.fft2(xl, dim=(-2, -1))
    s0 = _lowpass_subsample2(xhat, phi, t)
    u1 = torch.abs(torch.fft.ifft2(xhat[..., None, :, :]
                                   * _on_device(psi1, dev, rdt),
                                   dim=(-2, -1)))
    u1hat = torch.fft.fft2(u1, dim=(-2, -1))
    s1 = _lowpass_subsample2(u1hat, phi, t)
    lead = bspec[:-2]
    s2 = None
    if want2:
        u2hat = (u1hat.index_select(-3, _on_device(i1_rel, dev, torch.int64))
                 * _on_device(psi2, dev, rdt))
        u2 = torch.abs(torch.fft.ifft2(u2hat, dim=(-2, -1)))
        s2 = _wrap(_lowpass_subsample2(torch.fft.fft2(u2, dim=(-2, -1)), phi,
                                       t), mesh,
                   P(*lead, scale_axis, None, None))
    elif order == 2:
        s2 = torch.zeros((*x.shape[:-2], 0, h // t, w // t), dtype=rdt,
                         device=dev)
    return Scattering2DResult(
        s0=_wrap(s0, mesh, P(*bspec)),
        s1=_wrap(s1, mesh, P(*lead, scale_axis, None, None)), s2=s2,
        meta1=meta1,
        pairs=pairs if want2 else np.zeros((0, 3), dtype=np.int64))


# ---------------------------------------------------------------------------
# Synchrosqueezing: scales sharded, one SUM over them.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _ssq_shard(wavelet, scales: tuple, padded_n: int, sampling_rate: float,
               n_dev: int, idx: int):
    """This rank's rows of the four (W, ∂_t W) multiplier stacks and of
    the inverse-CWT weights (host float64)."""
    from ..ops.ssq import _ssq_multipliers, _ssq_weights

    k = len(scales) // n_dev
    rows = slice(idx * k, (idx + 1) * k)
    mults = tuple(np.ascontiguousarray(m[rows]) for m in _ssq_multipliers(
        wavelet, scales, padded_n, sampling_rate))
    return mults, np.ascontiguousarray(_ssq_weights(scales)[rows])


def ssq_sharded(x, scales, wavelet=None, mesh: DeviceMesh | None = None,
                sampling_rate: float = 1.0, n_freqs: int | None = None,
                freq_range: tuple[float, float] | None = None,
                padding: str = "zero", gamma: float | None = None,
                scale_axis: str = "scale", batch_axis: str = "data"):
    """Synchrosqueezed CWT with the scale axis sharded.

    Every scale reassigns into the SAME frequency-bin plane, so the shards
    meet in one SUM all-reduce of the partial Tx (reassignment is additive
    over scales); the default-γ magnitude floor adds one MAX all-reduce
    of the per-signal peak.  Tx comes back replicated over the scale axis,
    Wx scale-sharded.  Needs a log-UNIFORM scale grid
    (``generate_log_scales``): the inverse-CWT weights use the global grid
    spacing, which equals each shard's only on a uniform-in-ln(a) grid.
    """
    from ..ops.cwt import pad_signal
    from ..ops.ssq import SSQResult, _reassign_planes, _ssq_planes
    from ..utils.validation import next_power_of_two
    from ..wavelets.continuous import MorletWavelet

    if wavelet is None:
        wavelet = MorletWavelet()
    if mesh is None:
        raise ValueError("ssq_sharded requires a mesh "
                         "(use ops.ssq.ssq_cwt single-device)")
    x = _input(x, mesh)
    if not (x.is_floating_point() or x.is_complex()) or x.dtype in (
            torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    if x.is_complex():
        raise ValueError("ssq_sharded expects a real signal")
    scales_np = _host_grid(scales)
    if np.any(scales_np <= 0):
        raise ValueError("Scales must be positive")
    dln = np.diff(np.log(scales_np))
    if dln.size and (dln.max() - dln.min()) > 1e-9 * max(dln.max(), 1e-30):
        raise ValueError("ssq_sharded needs a log-uniform scale grid "
                         "(generate_log_scales); got non-uniform ln-spacing")
    n_dev, idx, group = _axis(mesh, scale_axis)
    s_count = scales_np.shape[0]
    if s_count % n_dev:
        raise ValueError(f"n_scales {s_count} not divisible by mesh axis "
                         f"{scale_axis}={n_dev}")
    n = x.shape[-1]
    padded_n = next_power_of_two(n)
    if n_freqs is None:
        n_freqs = s_count
    if n_freqs < 2:
        raise ValueError("need at least 2 frequency bins")
    fc = float(wavelet.center_frequency)
    if freq_range is None:
        f_lo, f_hi = fc / float(scales_np.max()), fc / float(scales_np.min())
    else:
        f_lo, f_hi = float(freq_range[0]), float(freq_range[1])
    if not (0 < f_lo < f_hi):
        raise ValueError("freq_range must satisfy 0 < f_min < f_max")
    log_lo, log_hi = math.log(f_lo), math.log(f_hi)
    dlog = (log_hi - log_lo) / (n_freqs - 1)

    rdtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    cdtype = (torch.complex128 if x.dtype == torch.float64
              else torch.complex64)
    mults, weights = _ssq_shard(wavelet, tuple(float(s) for s in scales_np),
                                padded_n, float(sampling_rate), n_dev, idx)
    bspec = _batch_spec(mesh, x.ndim, batch_axis, 1)
    xp = pad_signal(_local(x, mesh, P(*bspec)), padded_n, padding)
    tx, wx = _reassign_planes(*_ssq_planes(xp, n, mults, rdtype, cdtype),
                              weights, log_lo, dlog, n_freqs, gamma, rdtype,
                              cdtype, group=group)
    lead = bspec[:-1]
    dev = mesh_device(mesh)
    freqs = np.exp(log_lo + dlog * np.arange(n_freqs))
    return SSQResult(_wrap(tx, mesh, P(*lead, None, None)),
                     _wrap(wx, mesh, P(*lead, scale_axis, None)),
                     torch.as_tensor(freqs, device=dev).to(rdtype),
                     torch.as_tensor(scales_np, device=dev).to(rdtype),
                     _time_axis(n, sampling_rate, dev), sampling_rate,
                     wavelet.name)


# ---------------------------------------------------------------------------
# 2D MODWT: row axis sharded.
# ---------------------------------------------------------------------------

def _row_extend(planes, halo: int, group, adjoint: bool):
    """Stack ``planes`` (…, R_loc, C), move the rows last and fetch their
    ring context in one go: (extended (k, …, C, R_loc + halo), offset)."""
    return _extend(torch.stack(planes).transpose(-1, -2), halo, group,
                   adjoint)


def modwt2_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: DeviceMesh,
                   row_axis: str = "signal", batch_axis: str = "data"):
    """2D MODWT of a LARGE image with the row axis sharded.

    Each rank holds a contiguous block of image rows.  The column-
    direction convolutions (along the last axis) are local; the row-
    direction ones fetch ``(M−1)·2^(j−1)`` halo rows from the ring once a
    level for both of their inputs.  Band layout as
    :func:`..ops.modwt2d.modwt2`.
    """
    from ..ops.modwt2d import _check_nd, _conv_axis_pair

    x = _float_input(x, mesh)
    _check_nd(x.shape[-2:], level)
    g64, h64 = modwt_base_filters(wavelet)
    max_halo = (g64.shape[0] - 1) * (1 << (level - 1))
    if max_halo > x.shape[-2]:
        raise ValueError(
            f"level-{level} halo ({max_halo} rows) exceeds the image height "
            f"{x.shape[-2]}")
    _, _, group = _axis(mesh, row_axis)
    spec = _batch_spec(mesh, x.ndim, batch_axis, 2)
    spec[-2] = row_axis
    ll = _local(x, mesh, P(*spec))
    g, h = taps_as(g64, ll.dtype), taps_as(h64, ll.dtype)
    r = ll.shape[-2]
    rows = []
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        cl, ch = _conv_axis_pair(ll, g, h, d, -1)
        e, base = _row_extend([cl, ch], (len(g) - 1) * d, group, False)

        def row(k, f):
            return _taps(e[k], f, d, base, r, False).transpose(-1, -2)

        rows.extend([row(1, g), row(0, h), row(1, h)])   # LH, HL, HH
        ll = row(0, g)
    rows.append(ll)
    return _wrap(torch.stack(rows), mesh, P(None, *spec))


def imodwt2_sharded(coeffs, wavelet: DiscreteWavelet, mesh: DeviceMesh,
                    row_axis: str = "signal", batch_axis: str = "data"):
    """Inverse of :func:`modwt2_sharded` (the same row sharding in and
    out): one row-context fetch a level for its four bands."""
    coeffs = _input(coeffs, mesh)
    if coeffs.shape[0] % 3 != 1:
        raise ValueError(
            f"2D MODWT coefficient stack must have 3·level+1 rows, got "
            f"{coeffs.shape[0]}")
    level = (coeffs.shape[0] - 1) // 3
    _, _, group = _axis(mesh, row_axis)
    spec = _batch_spec(mesh, coeffs.ndim - 1, batch_axis, 2)
    spec[-2] = row_axis
    cl_ = _local(coeffs, mesh, P(None, *spec))
    g64, h64 = modwt_base_filters(wavelet)
    g, h = taps_as(g64, cl_.dtype), taps_as(h64, cl_.dtype)
    r = cl_.shape[-2]
    ll = cl_[3 * level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        lh, hl, hh = (cl_[3 * (j - 1) + i] for i in range(3))
        e, _ = _row_extend([ll, hl, lh, hh], (len(g) - 1) * d, group, True)

        def row(k, f):
            return _taps(e[k], f, d, 0, r, True)

        cl = (row(0, g) + row(1, h)).transpose(-1, -2)
        ch = (row(2, g) + row(3, h)).transpose(-1, -2)
        ll = _combined_adjoint(cl, ch, g, h, d)
    return _wrap(ll, mesh, P(*spec))
