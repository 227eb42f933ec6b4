"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the decision is
made in a fixture, at run time.  The file imports neither JAX nor the JAX
package, so on a machine without JAX it runs alone, without the suite's
conftest:

    python -m pytest tests/test_torch_kernels.py -q --noconftest -o addopts=""

Tolerances: f32 forward 1e-5 and inverse 1e-4 absolute (the on-chip bounds
the JAX package's TPU smoke holds its kernels to: both compute in f32 in a
different order); bf16 one bf16 ulp plus the f32 noise (relative 2⁻⁷,
absolute 1e-5), since both round the same f32 results once.  The variance
1e-4 relative (the TPU smoke's bound; f32 sums in another order).  The
packet select: positions and values exact against the arg-max over the
packet forward kernel's own output (the same cascade, the same float
operations); against the plain version the value within 1e-5, and the
plain |w| at the kernel's position within 1e-5 of the plain maximum, which
tolerates a near-tie in f32.  The 2D kernels: forward, inverse, round trip
and fused denoise 1e-4 absolute (the JAX package's on-chip 2D bound,
``tools/tpu_smoke.py:293``: each band sums 2·M² products per level in
another order); bf16 as above, and the bf16 round trip 1e-1.  The 3D
kernels: forward 1e-5 and inverse and round trip 1e-4 absolute (the
on-chip bounds above: the same f32 cascade in another order); bf16 as
above, the bf16 round trip 1e-1.  The CWT kernel: 1e-4 × max|c| against
its plain version and against ``torch.fft.ifft`` (an f32 FFT against an
f32 two-stage DFT and cuFFT, errors ~log₂P ulps of the largest value).
The decimated products' gradients under TF32: 1e-5 relative to the host
f64 gradient (the forward's on-chip bound; a TF32 backward misses it by
an order of magnitude).  The banded CWT's tiers against the host f64
irfft path, the JAX tests' bounds (``tests/test_cwt_banded.py``):
'highest' 2e-5, 'high' 1e-3 + 1e-6, 'default' 2e-2 relative to max|c|.
The streaming path's coefficients against the host f64 MODWT of the whole
signal on the columns ≥ halo: 1e-5 absolute, the forward's bound.
"""
import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch.kernels import cwt_cuda as kcw
from jwave_pro_tpu_torch.kernels import denoise_cuda as kd
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
from jwave_pro_tpu_torch.kernels import modwt2_cuda as k2
from jwave_pro_tpu_torch.kernels import modwt3_cuda as k3
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
from jwave_pro_tpu_torch.kernels import variance_cuda as kv
from jwave_pro_tpu_torch.kernels.modwt_cuda import LAUNCHES

pytestmark = pytest.mark.cuda

DB4 = jt.wavelet("Daubechies 4")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _signal(dev, *shape, seed=0, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def _close(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", [
    (8, 2048, 3, "Daubechies 4"),
    (3, 100003, 5, "Daubechies 4"),   # arbitrary N, ragged last tile
    (2, 64, 5, "Daubechies 4"),       # halo longer than the signal
    (4, 5000, 2, "Discrete Meyer"),   # the longest registered filter
    (1, 1 << 16, 4, "Symlet 8"),
])
def test_forward_and_inverse_match_plain(dev, batch, n, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, dtype=dtype)
    c = kc.modwt_fwd_cuda(x, w, level)
    assert c.dtype == dtype and c.shape == (level + 1, batch, n)
    _close(c, kc.modwt_fwd_plain(x, w, level), dtype)
    _close(kc.modwt_inv_cuda(c, w), kc.modwt_inv_plain(c, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("batch,n,level", [(8, 4096, 3), (3, 100003, 5),
                                           (2, 200, 4)])
def test_denoise_matches_plain(dev, batch, n, level, mode, dtype):
    x = _signal(dev, batch, n, seed=1, dtype=dtype)
    thr = torch.linspace(0.2, 1.0, batch, device=dev)
    got = kd.modwt_denoise_cuda(x, thr, DB4, level, mode)
    assert got.dtype == dtype
    _close(got, kd.modwt_denoise_plain(x, thr, DB4, level, mode), dtype)


# the forward's, the inverse's and the fused denoise's edges: halo longer
# than N, N off the tile, each kernel's gate edges (forward: Haar L13 at
# the public maximum, Symlet 8 L10 at its own gate, Daubechies 2 L13 at
# the tile its W slices leave; inverse: Symlet 8 L9,
# Haar L13; denoise: Haar L10, Symlet 8 L7), the runtime-M kernel
# (Coiflet 1, M = 6); every width here leaves a register chain crossing
# some level's end
FWD_EDGES = [(3, 37, 3, "Daubechies 4"), (2, 100003, 5, "Daubechies 4"),
             (1, 1 << 13, 13, "Haar"), (1, 1 << 10, 10, "Symlet 8"),
             (2, 3000, 3, "Coiflet 1"), (1, 1 << 15, 13, "Daubechies 2")]
INV_EDGES = [(3, 37, 3, "Daubechies 4"), (2, 100003, 5, "Daubechies 4"),
             (1, 4096, 9, "Symlet 8"), (1, 1 << 13, 13, "Haar"),
             (2, 3000, 3, "Coiflet 1")]
DENOISE_EDGES = [(3, 37, 3, "Daubechies 4"), (2, 100003, 5, "Daubechies 4"),
                 (1, 2048, 10, "Haar"), (1, 1024, 7, "Symlet 8"),
                 (2, 3000, 3, "Coiflet 1")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", FWD_EDGES)
def test_forward_edges_bitwise_repeatable(dev, batch, n, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=13, dtype=dtype)
    got = kc.modwt_fwd_cuda(x, w, level)
    assert got.dtype == dtype and got.shape == (level + 1, batch, n)
    _close(got, kc.modwt_fwd_plain(x, w, level), dtype)
    assert torch.equal(got, kc.modwt_fwd_cuda(x, w, level))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", INV_EDGES)
def test_inverse_edges_bitwise_repeatable(dev, batch, n, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=14)
    c = kc.modwt_fwd_plain(x, w, level).to(dtype)
    got = kc.modwt_inv_cuda(c, w)
    assert got.dtype == dtype and got.shape == (batch, n)
    _close(got, kc.modwt_inv_plain(c, w), dtype)
    assert torch.equal(got, kc.modwt_inv_cuda(c, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("batch,n,level,name", DENOISE_EDGES)
def test_denoise_edges_bitwise_repeatable(dev, batch, n, level, name, mode,
                                          dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=15, dtype=dtype)
    thr = torch.linspace(0.2, 1.0, batch, device=dev)
    got = kd.modwt_denoise_cuda(x, thr, w, level, mode)
    assert got.dtype == dtype and got.shape == (batch, n)
    _close(got, kd.modwt_denoise_plain(x, thr, w, level, mode), dtype)
    assert torch.equal(got, kd.modwt_denoise_cuda(x, thr, w, level, mode))


def test_entry_points_reject_shared_memory_off_their_layout(dev):
    """The forward's, the inverse's and the denoise's C entry points launch
    only with the plan's shared-memory size (smem_bytes) and halo, and
    return cudaErrorInvalidValue (1) for any other."""
    x = _signal(dev, 2, 4096, seed=16)
    c = kc.modwt_fwd_cuda(x, DB4, 3)
    thr = torch.ones(2, device=dev)
    out = torch.empty_like(x)
    g, h = kc.kernel_taps(DB4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hal = kc.halo(8, 3)
    coeffs = torch.empty_like(c)
    for dh, want in ((1, 1), (-1, 1), (0, 0)):
        assert kc._lib().jw_modwt_fwd(
            x.data_ptr(), coeffs.data_ptr(), 2, 4096, 3, g.ctypes.data,
            h.ctypes.data, 8, kc.TILES["fwd"], hal + dh,
            kc.smem_bytes(3, 8, "fwd"), 0, 0, stream) == want
    for delta, want in ((4, 1), (-4, 1), (0, 0)):
        smem = kc.smem_bytes(3, 8, "fwd") + delta
        assert kc._lib().jw_modwt_fwd(
            x.data_ptr(), coeffs.data_ptr(), 2, 4096, 3, g.ctypes.data,
            h.ctypes.data, 8, kc.TILES["fwd"], hal, smem, 0, 0,
            stream) == want
        smem = kc.smem_bytes(3, 8, "inv") + delta
        assert kc._lib().jw_modwt_inv(
            c.data_ptr(), out.data_ptr(), 2, 4096, 3, g.ctypes.data,
            h.ctypes.data, 8, kc.TILES["inv"], hal, smem, 0, 0,
            stream) == want
        smem = kc.smem_bytes(3, 8, "denoise") + delta
        assert kd._lib().jw_modwt_denoise(
            x.data_ptr(), thr.data_ptr(), out.data_ptr(), 2, 4096, 3,
            g.ctypes.data, h.ctypes.data, 8, kc.TILES["denoise"], hal, smem,
            0, 0, 0, stream) == want
    torch.cuda.synchronize()


def test_public_path_launches_each_kernel(dev):
    x = _signal(dev, 4, 8192, seed=2)
    counters = ("modwt_fwd", "modwt_inv", "modwt_denoise")
    before = [LAUNCHES[op] for op in counters]
    c = jt.modwt(x, DB4, 5)
    xr = jt.imodwt(c, DB4)
    den = jt.modwt_denoise(x, DB4, 5, method="fused")
    torch.cuda.synchronize()
    assert [LAUNCHES[op] - b for op, b in zip(counters, before)] == [1, 1, 1]
    torch.testing.assert_close(xr, x, rtol=0, atol=1e-4)
    torch.testing.assert_close(
        den, jt.modwt_denoise(x, DB4, 5, method="direct"), rtol=0, atol=1e-5)
    # outputs stay on the input's device
    assert c.device == x.device == den.device


def test_auto_routes_f64_and_unsupported_shapes_to_plain(dev):
    before = LAUNCHES["modwt_fwd"]
    jt.modwt(_signal(dev, 2, 1024, dtype=torch.float64), DB4, 3)
    jt.modwt(_signal(dev, 1 << 14), DB4, 13)   # Db4 L13 does not fit
    assert LAUNCHES["modwt_fwd"] == before
    with pytest.raises(ValueError):
        jt.modwt(_signal(dev, 2, 1024, dtype=torch.float64), DB4, 3,
                 method="pallas")


def test_launchers_reject_what_the_kernel_does_not_take(dev):
    x = _signal(dev, 4, 1024)
    with pytest.raises(ValueError, match="contiguous"):
        kc.modwt_fwd_cuda(x[:, ::2], DB4, 2)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        kc.modwt_fwd_cuda(x.double(), DB4, 2)
    with pytest.raises(ValueError, match="threshold"):
        kd.modwt_denoise_cuda(x, torch.ones(3, device=dev), DB4, 2)


def test_gradients_through_the_kernel_pair(dev):
    x = _signal(dev, 8, 4096, seed=3)
    wts = _signal(dev, 4, 8, 4096, seed=4)
    xk = x.clone().requires_grad_()
    (kc.modwt_fused(xk, DB4, 3) * wts).sum().backward()
    xp = x.clone().requires_grad_()
    (jt.modwt(xp, DB4, 3, method="direct") * wts).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=0, atol=1e-4)


# -- the MODWT statistics and packet-tree kernels ----------------------------

SLICE_SHAPES = [
    (8, 4096, 3, "Daubechies 4"),
    (3, 100003, 3, "Daubechies 4"),   # arbitrary N, ragged last tile
    (2, 16, 4, "Daubechies 4"),       # halo (105) longer than the signal
    (4, 5000, 2, "Symlet 8"),
    (1, 1 << 16, 5, "Daubechies 4"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", SLICE_SHAPES)
def test_variance_matches_plain(dev, batch, n, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=5, dtype=dtype)
    got = kv.modwt_var_cuda(x, w, level)
    assert got.dtype == torch.float32 and got.shape == (level + 1, batch)
    torch.testing.assert_close(got, kv.modwt_var_plain(x, w, level),
                               rtol=1e-4, atol=0)
    one = kv.modwt_var_fused(x[0], w, level)          # the (N,) contract
    assert one.shape == (level + 1,)
    torch.testing.assert_close(one, got[:, 0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", SLICE_SHAPES)
def test_packet_forward_and_inverse_match_plain(dev, batch, n, level, name,
                                                dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=6, dtype=dtype)
    c = kp.modwpt_fwd_cuda(x, w, level)
    assert c.dtype == dtype and c.shape == (1 << level, batch, n)
    _close(c, kp.modwpt_fwd_plain(x, w, level), dtype)
    back = kp.modwpt_inv_cuda(c, w)
    want = kp.modwpt_inv_plain(c, w)
    if dtype == torch.bfloat16:
        _close(back, want, dtype)
        torch.testing.assert_close(back.float(), x.float(), rtol=0, atol=1e-1)
    else:
        torch.testing.assert_close(back, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(back, x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", SLICE_SHAPES)
def test_select_matches_argmax_and_plain(dev, batch, n, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=7, dtype=dtype)
    a, t, v = kp.modwpt_select_cuda(x, w, level)
    assert a.dtype == v.dtype == torch.float32 and t.dtype == torch.int32
    assert t.shape == (1 << level, batch)
    # exact against the first arg-max of the forward kernel's own output
    c = kp.modwpt_fwd_cuda(x.float(), w, level)
    want_t = torch.argmax(c.abs(), dim=-1)
    assert torch.equal(t.long(), want_t)
    assert torch.equal(v, torch.gather(c, -1, want_t[..., None])[..., 0])
    assert torch.equal(a, v.abs())
    # against the plain version, tolerating an f32 near-tie
    pa, _, _ = kp.modwpt_select_plain(x, w, level)
    cp = kp.modwpt_fwd_plain(x.float(), w, level)
    at_t = torch.gather(cp, -1, t.long()[..., None])[..., 0]
    torch.testing.assert_close(v, at_t, rtol=0, atol=1e-5)
    torch.testing.assert_close(at_t.abs(), pa, rtol=0, atol=1e-5)


# each specialised filter length and the runtime-M one (Db2), N off the
# tile, the gate edges, and rows whose last block is not the grid's last
EDGE_SHAPES = [
    (2, 3000, 5, "Haar"),
    (2, 5000, 3, "Symlet 8"),
    (3, 100003, 3, "Daubechies 2"),
    (300, 5000, 3, "Daubechies 4"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", EDGE_SHAPES + [
    (2, 100003, 11, "Daubechies 4")])
def test_variance_edges_bitwise_repeatable(dev, batch, n, level, name,
                                           dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=12, dtype=dtype)
    got = kv.modwt_var_cuda(x, w, level)
    torch.testing.assert_close(got, kv.modwt_var_plain(x, w, level),
                               rtol=1e-4, atol=0)
    # the tiles are added in tile order inside the launch, whatever order
    # the blocks ran in
    assert torch.equal(got, kv.modwt_var_cuda(x, w, level))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", EDGE_SHAPES + [
    (2, 100003, 8, "Daubechies 4")])
def test_select_edges_bitwise_repeatable(dev, batch, n, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=13, dtype=dtype)
    a, t, v = kp.modwpt_select_cuda(x, w, level)
    c = kp.modwpt_fwd_cuda(x.float(), w, level)
    want_t = torch.argmax(c.abs(), dim=-1)
    assert torch.equal(t.long(), want_t)
    assert torch.equal(v, torch.gather(c, -1, want_t[..., None])[..., 0])
    assert torch.equal(a, v.abs())
    for got, again in zip((a, t, v), kp.modwpt_select_cuda(x, w, level)):
        assert torch.equal(got, again)


# the smoke's packet edge shapes: halo > N, N off the tile, each
# specialised filter length and the runtime-M one (Db2), leaves at d >= 32
# (Haar L6), L = 1, B = 300, and the gate edges at N = 2^20 (Db4 L8 forward,
# Db4 L7 inverse)
PACKET_EDGES = [(3, 17, 3, "Daubechies 4"), (2, 100003, 3, "Haar"),
                (2, 5000, 2, "Symlet 8"), (3, 100003, 3, "Daubechies 2"),
                (2, 3000, 6, "Haar"), (2, 2000, 1, "Symlet 8"),
                (300, 5000, 3, "Daubechies 4"),
                (2, 1 << 20, 8, "Daubechies 4"),
                (2, 1 << 20, 7, "Daubechies 4")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,level,name", PACKET_EDGES)
def test_packet_edges_match_plain_and_repeat_bitwise(dev, batch, n, level,
                                                     name, dtype):
    """The packet forward against its plain version and bitwise against a
    second call, the select against the arg-max over its output, and the
    inverse (where its gate admits the shape) against its plain version
    and the input."""
    w = jt.wavelet(name)
    x = _signal(dev, batch, n, seed=17, dtype=dtype)
    c = kp.modwpt_fwd_cuda(x, w, level)
    assert c.dtype == dtype and c.shape == (1 << level, batch, n)
    _close(c, kp.modwpt_fwd_plain(x, w, level), dtype)
    assert torch.equal(c, kp.modwpt_fwd_cuda(x, w, level))
    cs = c if dtype == torch.float32 else kp.modwpt_fwd_cuda(x.float(), w,
                                                             level)
    a, t, v = kp.modwpt_select_cuda(x, w, level)
    want_t = torch.argmax(cs.abs(), dim=-1)
    assert torch.equal(t.long(), want_t)
    assert torch.equal(v, torch.gather(cs, -1, want_t[..., None])[..., 0])
    del cs
    if not kc.kernel_supported(n, level, w.length, "pinv"):
        return
    back = kp.modwpt_inv_cuda(c, w)
    assert back.dtype == dtype and back.shape == (batch, n)
    if dtype == torch.bfloat16:
        _close(back, kp.modwpt_inv_plain(c, w), dtype)
        torch.testing.assert_close(back.float(), x.float(), rtol=0, atol=1e-1)
    else:
        torch.testing.assert_close(back, kp.modwpt_inv_plain(c, w), rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(back, x, rtol=0, atol=1e-4)
    assert torch.equal(back, kp.modwpt_inv_cuda(c, w))


def test_packet_entry_points_reject_layouts_off_their_plan(dev):
    """The packet forward's and inverse's C entry points launch only with
    the plan's halo and shared-memory size (smem_bytes), and return
    cudaErrorInvalidValue (1) for any other."""
    x = _signal(dev, 2, 4096, seed=18)
    c = kp.modwpt_fwd_cuda(x, DB4, 3)
    out_c, out_x = torch.empty_like(c), torch.empty_like(x)
    g, h = kc.kernel_taps(DB4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hal = kc.halo(8, 3)
    lib = kp._lib()
    for dh, ds, want in ((1, 0, 1), (-1, 0, 1), (0, 4, 1), (0, -4, 1),
                         (0, 0, 0)):
        assert lib.jw_modwpt_fwd(
            x.data_ptr(), out_c.data_ptr(), 2, 4096, 3, g.ctypes.data,
            h.ctypes.data, 8, kc.tile_of("pfwd", 3, 8), hal + dh,
            kc.smem_bytes(3, 8, "pfwd") + ds, 0, 0, stream) == want
        assert lib.jw_modwpt_inv(
            c.data_ptr(), out_x.data_ptr(), 2, 4096, 3, g.ctypes.data,
            h.ctypes.data, 8, kc.tile_of("pinv", 3, 8), hal + dh,
            kc.smem_bytes(3, 8, "pinv") + ds, 0, 0, stream) == want
    torch.cuda.synchronize()
    assert torch.equal(out_c, c)


def test_bf16_omp_through_the_fused_select(dev):
    """Orthogonal matching pursuit of bf16 input runs its picks through the
    fused select and its least squares in f32: on a signal of three atoms a
    row (amplitudes 6-8, each above the bf16 guard 50·eps·‖x‖ ≈ 0.39 ‖x‖,
    noise 0.01) it makes the f32 run's picks on the same values, with amps
    and residual within the bf16 bound."""
    x = _omp_signal()
    x16 = x.to(dev, torch.bfloat16)
    before = LAUNCHES["modwpt_select"]
    got = jt.matching_pursuit(x16, DB4, 3, 3, orthogonalize=True)
    assert LAUNCHES["modwpt_select"] - before == 3
    want = jt.matching_pursuit(x16.float(), DB4, 3, 3, orthogonalize=True)
    assert got.amps.dtype == got.residual.dtype == torch.bfloat16
    assert torch.equal(got.nodes, want.nodes)
    assert torch.equal(got.shifts, want.shifts)
    torch.testing.assert_close(got.amps.float(), want.amps, rtol=0,
                               atol=5e-2)
    torch.testing.assert_close(got.residual.float(), want.residual, rtol=0,
                               atol=5e-2)


def _omp_signal():
    """(2, 4096) float64: three Db4 L3 atoms a row plus 0.01 noise."""
    picks = jt.MPResult(
        torch.tensor([[0, 3, 5], [2, 7, 1]], dtype=torch.int32),
        torch.tensor([[100, 1500, 3000], [600, 2000, 3500]],
                     dtype=torch.int32),
        torch.tensor([[8.0, -7.5, 7.0], [-7.0, 6.5, 6.0]],
                     dtype=torch.float64),
        torch.zeros(2, 4096, dtype=torch.float64), 3, "Daubechies 4")
    x = jt.mp_reconstruct(picks, DB4, 4096)
    return x + 0.01 * torch.from_numpy(
        np.random.default_rng(19).standard_normal(x.shape))


def test_in_launch_finish_on_two_streams(dev):
    """Each stream has its own ticket counters: launches on two streams at
    once give what each gives alone."""
    w = DB4
    xs = [_signal(dev, 16, 70001, seed=14 + i) for i in range(2)]
    want = [(kv.modwt_var_cuda(x, w, 5), kp.modwpt_select_cuda(x, w, 3))
            for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    got = []
    torch.cuda.synchronize()
    for _ in range(4):
        for x, st in zip(xs, streams):
            with torch.cuda.stream(st):
                got.append((kv.modwt_var_cuda(x, w, 5),
                            kp.modwpt_select_cuda(x, w, 3)))
    torch.cuda.synchronize()
    for i, (var, sel) in enumerate(got):
        wv, ws = want[i % 2]
        assert torch.equal(var, wv)
        assert all(torch.equal(p, q) for p, q in zip(sel, ws))


def test_slice_public_path_launches_each_kernel(dev):
    w = DB4
    x = _signal(dev, 4, 8192, seed=8)
    y = _signal(dev, 4, 8192, seed=9)
    counters = ("modwt_var", "modwpt_fwd", "modwpt_inv", "modwpt_select")
    before = [LAUNCHES[op] for op in counters]
    v = jt.modwt_variance(x, w, 5)
    rho = jt.modwt_correlation(x, y, w, 5)
    c = jt.modwpt(x, w, 3)
    xr = jt.imodwpt(c, w)
    r = jt.matching_pursuit(x, w, 3, 4)
    torch.cuda.synchronize()
    launched = [LAUNCHES[op] - b for op, b in zip(counters, before)]
    # variance: 1; correlation: x+y, x−y, x, y; MP: one select per atom
    assert launched == [5, 1, 1, 4]
    assert v.shape == (5, 4) and v.dtype == torch.float32
    torch.testing.assert_close(
        v, jt.modwt_variance(x.double(), w, 5, method="direct").float(),
        rtol=1e-4, atol=0)
    assert bool(torch.all(rho.abs() <= 1.0 + 1e-5))
    torch.testing.assert_close(xr, x, rtol=0, atol=1e-4)
    torch.testing.assert_close(jt.mp_reconstruct(r, w) + r.residual, x,
                               rtol=0, atol=1e-4)
    direct = jt.matching_pursuit(x, w, 3, 4, method="direct")
    assert torch.equal(r.nodes[:, 0], direct.nodes[:, 0])
    assert torch.equal(r.shifts[:, 0], direct.shifts[:, 0])
    assert c.device == x.device == r.residual.device


def test_slice_auto_routes_f64_and_unsupported_shapes_to_plain(dev):
    counters = ("modwt_var", "modwpt_fwd", "modwpt_select")
    before = [LAUNCHES[op] for op in counters]
    x64 = _signal(dev, 2, 1024, dtype=torch.float64)
    jt.modwt_variance(x64, DB4, 3)
    jt.modwpt(x64, DB4, 3)
    jt.matching_pursuit(x64, DB4, 2, 2)
    jt.modwpt(_signal(dev, 1, 1024), DB4, 9)       # Db4 L9 does not fit
    assert [LAUNCHES[op] for op in counters] == before
    with pytest.raises(ValueError, match="float32/bfloat16"):
        jt.modwt_variance(x64, DB4, 3, method="fused")


def test_slice_launchers_reject_what_the_kernel_does_not_take(dev):
    x = _signal(dev, 4, 1024)
    for launch in (kv.modwt_var_cuda, kp.modwpt_fwd_cuda,
                   kp.modwpt_select_cuda):
        with pytest.raises(ValueError, match="contiguous"):
            launch(x[:, ::2], DB4, 2)
        with pytest.raises(ValueError, match="float32/bfloat16"):
            launch(x.double(), DB4, 2)
        with pytest.raises(ValueError, match="unsupported shape"):
            launch(x, DB4, 12)                    # the halo does not fit
    with pytest.raises(ValueError, match="2\\^level"):
        kp.modwpt_inv_cuda(_signal(dev, 3, 4, 1024), DB4)
    with pytest.raises(ValueError, match="expected 3 dims"):
        kp.modwpt_inv_cuda(x, DB4)


def test_gradients_through_the_packet_pair(dev):
    x = _signal(dev, 8, 4096, seed=10)
    wts = _signal(dev, 8, 8, 4096, seed=11)
    xk = x.clone().requires_grad_()
    (kp.modwpt_fused(xk, DB4, 3) * wts).sum().backward()
    xp = x.clone().requires_grad_()
    (jt.modwpt(xp, DB4, 3, method="direct") * wts).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=0, atol=1e-4)
    ck = wts.clone().requires_grad_()
    (kp.imodwpt_fused(ck, DB4) * x).sum().backward()
    cp = wts.clone().requires_grad_()
    (jt.imodwpt(cp, DB4, method="direct") * x).sum().backward()
    torch.testing.assert_close(ck.grad, cp.grad, rtol=0, atol=1e-4)


# -- the 2D image kernels ------------------------------------------------------

IMAGE_SHAPES = [
    ((2, 128, 256), 2, "Daubechies 4"),
    ((3, 1000, 750), 3, "Daubechies 4"),   # arbitrary size, ragged tiles
    ((2, 40, 24), 3, "Daubechies 4"),      # halo (49) larger than the image
    ((1, 256, 256), 2, "Symlet 8"),
    ((2, 96, 80), 4, "Daubechies 4"),      # Db4 L4: the inverse's G = 2
    ((1, 130, 300), 7, "Haar"),            # the gate's edge: halo 127
    ((1, 200, 180), 3, "Symlet 8"),        # the gate's edge: halo 105
    ((2, 70, 90), 2, "Daubechies 2"),      # no specialised filter length
    ((1, 1000, 200), 3, "Daubechies 4"),   # row runs: one image, one strip
    ((2, 64, 1001), 3, "Daubechies 4"),    # the last strip crosses C's end
]
DENOISE_SHAPES = [
    ((2, 128, 256), 2, "Daubechies 4"),
    ((3, 200, 150), 3, "Daubechies 4"),    # the last strip crosses C's end
    ((2, 40, 24), 3, "Daubechies 4"),      # halo larger than the image
    ((1, 256, 256), 2, "Symlet 8"),
    ((1, 100, 70), 6, "Haar"),             # six levels, R and C below W
    ((1, 1000, 200), 3, "Daubechies 4"),   # row runs: one image, few strips
    ((2, 70, 90), 2, "Daubechies 2"),      # no specialised filter length
]


def _close2(got, want, dtype):
    if dtype == torch.bfloat16:
        _close(got, want, dtype)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,level,name", IMAGE_SHAPES)
def test_2d_forward_and_inverse_match_plain(dev, shape, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, *shape, seed=12, dtype=dtype)
    c = k2.modwt2_fwd_cuda(x, w, level)
    assert c.dtype == dtype and c.shape == (3 * level + 1,) + shape
    _close2(c, k2.modwt2_fwd_plain(x, w, level), dtype)
    back = k2.modwt2_inv_cuda(c, w)
    assert back.dtype == dtype and back.shape == shape
    _close2(back, k2.modwt2_inv_plain(c, w), dtype)
    tol = 1e-1 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(back.float(), x.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("shape,level,name", DENOISE_SHAPES)
def test_2d_denoise_matches_plain(dev, shape, level, name, mode, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, *shape, seed=13, dtype=dtype)
    thr = torch.linspace(0.2, 1.0, shape[0], device=dev)
    got = k2.modwt2_denoise_cuda(x, thr, w, level, mode)
    assert got.dtype == dtype and got.shape == shape
    _close2(got, k2.modwt2_denoise_plain(x, thr, w, level, mode), dtype)
    if dtype == torch.float32:
        # against the pipeline on the forward and inverse kernels
        pipe = jt.modwt2_denoise(x, w, level, mode, threshold=thr[:, None,
                                                                  None])
        torch.testing.assert_close(got, pipe, rtol=0, atol=1e-4)


def test_2d_transforms_row_runs_cross_into_the_next(dev):
    """One image splits into row runs (each marches H rows of warm-up: the
    forward reads up into its neighbour's rows, the inverse down); the
    runs tile the rows exactly, the last one short."""
    b, r, c = 1, 997, 200
    for kind in ("fwd", "inv"):
        run = k2.transform2_run(b, r, c, 3, 8, 132, kind)
        assert run < r and r % run
    x = _signal(dev, b, r, c, seed=33)
    co = k2.modwt2_fwd_cuda(x, DB4, 3)
    torch.testing.assert_close(co, k2.modwt2_fwd_plain(x, DB4, 3), rtol=0,
                               atol=1e-4)
    back = k2.modwt2_inv_cuda(co, DB4)
    torch.testing.assert_close(back, k2.modwt2_inv_plain(co, DB4), rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(back, x, rtol=0, atol=1e-4)


def test_2d_denoise_row_runs_cross_into_the_next(dev):
    """One image splits into row runs (each marches 2H rows of warm-up and
    reads across its neighbour's rows); the runs tile the rows exactly."""
    b, r, c = 1, 1000, 200
    run = k2.denoise2_run(b, r, c, 3, 8, 132)
    assert run < r and r % run
    x = _signal(dev, b, r, c, seed=30)
    thr = torch.full((b,), 0.7, device=dev)
    for mode in ("soft", "hard"):
        got = k2.modwt2_denoise_cuda(x, thr, DB4, 3, mode)
        torch.testing.assert_close(
            got, k2.modwt2_denoise_plain(x, thr, DB4, 3, mode), rtol=0,
            atol=1e-4)


def test_numpy_threshold_on_the_card(dev):
    """An ndarray threshold moves to the coefficients' device and dtype in
    both shrink functions and in the 1D pipeline, in both modes."""
    c = _signal(dev, 3, 50, seed=31)
    t = np.array([[0.2], [0.5], [1.0]])
    for shrink in (jt.soft_threshold, jt.hard_threshold):
        got = shrink(c, t)
        assert got.device == c.device and got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), shrink(c.cpu(), t), rtol=0,
                                   atol=0)
    x = _signal(dev, 2, 4096, seed=32)
    thr = np.array([[0.6], [0.9]])
    for mode in ("soft", "hard"):
        got = jt.modwt_denoise(x, DB4, 3, mode=mode, threshold=thr)
        want = jt.modwt_denoise(x.double().cpu(), DB4, 3, mode=mode,
                                threshold=thr)
        assert got.device == x.device
        torch.testing.assert_close(got.double().cpu(), want, rtol=0,
                                   atol=1e-4)


def test_2d_public_path_launches_each_kernel(dev):
    w = DB4
    x = _signal(dev, 2, 256, 192, seed=14)
    counters = ("modwt2_fwd", "modwt2_inv", "modwt2_denoise", "modwpt_fwd",
                "modwpt_inv")
    before = [LAUNCHES[op] for op in counters]
    c = jt.modwt2(x, w, 3)
    xr = jt.imodwt2(c, w)
    den = jt.modwt2_denoise(x, w, 3, method="fused")
    p = jt.modwpt2(x, w, 2)
    xp = jt.imodwpt2(p, w)
    torch.cuda.synchronize()
    # the packet pair runs one 1D launch per axis
    assert [LAUNCHES[op] - b for op, b in zip(counters, before)] == [
        1, 1, 1, 2, 2]
    torch.testing.assert_close(xr, x, rtol=0, atol=1e-4)
    torch.testing.assert_close(xp, x, rtol=0, atol=1e-4)
    torch.testing.assert_close(
        den, jt.modwt2_denoise(x, w, 3, method="direct"), rtol=0, atol=1e-4)
    assert c.device == den.device == p.device == x.device


def test_2d_pipeline_numpy_threshold_stays_on_the_kernels(dev):
    x = _signal(dev, 3, 64, 96, seed=15)
    before = LAUNCHES["modwt2_inv"]
    got = jt.modwt2_denoise(x, DB4, 2, threshold=np.array([0.3, 0.6, 1.2]))
    assert got.dtype == torch.float32
    assert LAUNCHES["modwt2_inv"] == before + 1


def test_2d_auto_routes_f64_grad_and_unsupported_shapes_to_plain(dev):
    counters = ("modwt2_fwd", "modwt2_inv")
    before = [LAUNCHES[op] for op in counters]
    x64 = _signal(dev, 2, 64, 64, dtype=torch.float64)
    jt.imodwt2(jt.modwt2(x64, DB4, 3), DB4)
    jt.modwt2(_signal(dev, 2, 64, 64), DB4, 5)     # Db4 L5 does not fit
    jt.modwt2(_signal(dev, 2, 2, 32, 32), DB4, 2)  # 4-D: leading dims
    xg = _signal(dev, 2, 64, 64).requires_grad_()
    (jt.modwt2(xg, DB4, 2) ** 2).sum().backward()
    assert [LAUNCHES[op] for op in counters] == before
    # the gradient is the plain path's
    xp = xg.detach().clone().requires_grad_()
    (jt.modwt2(xp, DB4, 2, method="direct") ** 2).sum().backward()
    torch.testing.assert_close(xg.grad, xp.grad, rtol=0, atol=0)
    for bad in (x64, xg):
        with pytest.raises(ValueError, match="unavailable"):
            jt.modwt2(bad, DB4, 2, method="pallas")
    with pytest.raises(ValueError, match="no backward"):
        k2.modwt2_fused(xg, DB4, 2)


def test_2d_launchers_reject_what_the_kernel_does_not_take(dev):
    x = _signal(dev, 2, 64, 64)
    for launch in (lambda a, lv: k2.modwt2_fwd_cuda(a, DB4, lv),
                   lambda a, lv: k2.modwt2_denoise_cuda(
                       a, torch.ones(2, device=dev), DB4, lv)):
        with pytest.raises(ValueError, match="contiguous"):
            launch(x[:, :, ::2], 2)
        with pytest.raises(ValueError, match="float32/bfloat16"):
            launch(x.double(), 2)
        with pytest.raises(ValueError, match="unsupported shape"):
            launch(x, 5)                      # the windows do not fit
    with pytest.raises(ValueError, match="unsupported shape"):
        k2.modwt2_denoise_cuda(x, torch.ones(2, device=dev), DB4, 4)
    with pytest.raises(ValueError, match="3·level\\+1"):
        k2.modwt2_inv_cuda(_signal(dev, 5, 2, 64, 64), DB4)
    with pytest.raises(ValueError, match="expected 4 dims"):
        k2.modwt2_inv_cuda(x, DB4)
    with pytest.raises(ValueError, match="threshold"):
        k2.modwt2_denoise_cuda(x, torch.ones(3, device=dev), DB4, 2)


# -- the 3D volume kernels ----------------------------------------------------

VOLUME_SHAPES = [
    ((2, 24, 40, 33), 2, "Daubechies 4"),   # ragged tiles on every axis
    ((1, 8, 8, 16), 2, "Daubechies 4"),     # halo (21) larger than D, R, C
    ((1, 5, 7, 40), 3, "Haar"),
    ((2, 9, 33, 70), 1, "Symlet 8"),
    ((1, 20, 24, 28), 5, "Haar"),           # five levels through the scratch
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,level,name", VOLUME_SHAPES)
def test_3d_forward_and_inverse_match_plain(dev, shape, level, name, dtype):
    w = jt.wavelet(name)
    x = _signal(dev, *shape, seed=16, dtype=dtype)
    c = k3.modwt3_fwd_cuda(x, w, level)
    assert c.dtype == dtype and c.shape == (7 * level + 1,) + shape
    _close(c, k3.modwt3_fwd_plain(x, w, level), dtype)
    back = k3.modwt3_inv_cuda(c, w)
    assert back.dtype == dtype and back.shape == shape
    _close2(back, k3.modwt3_inv_plain(c, w), dtype)
    tol = 1e-1 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(back.float(), x.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("shape,level,name", [
    ((1, 100, 16, 32), 2, "Daubechies 4"),  # D off the depth run
    ((2, 45, 40, 70), 2, "Daubechies 4"),
    ((2, 9, 20, 50), 2, "Daubechies 4"),    # D below the 15-plane ring
    ((2, 12, 20, 40), 2, "Daubechies 2"),   # no specialised filter length
])
def test_3d_inverse_depth_runs_match_plain(dev, shape, level, name):
    """The inverse's runs along depth: the last run ends inside its ring
    and wraps past the volume's end."""
    w = jt.wavelet(name)
    b, d, r, c = shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    halos = [k3.level_halo(w.length, j) for j in range(1, level + 1)]
    runs = [k3.inv3_depth_run(b, d, r, c, h, w.length, sms) for h in halos]
    assert any(d % dc for dc in runs) or d <= max(halos)
    x = _signal(dev, *shape, seed=21)
    coeffs = k3.modwt3_fwd_cuda(x, w, level)
    back = k3.modwt3_inv_cuda(coeffs, w)
    _close(back, k3.modwt3_inv_plain(coeffs, w), torch.float32)
    torch.testing.assert_close(back, x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,level,name", [
    ((1, 100, 16, 32), 2, "Daubechies 4"),  # D off the depth run
    ((2, 45, 40, 70), 2, "Daubechies 4"),
    ((2, 9, 20, 50), 2, "Daubechies 4"),    # D below the ring
    ((2, 12, 20, 40), 2, "Daubechies 2"),   # no specialised filter length
    ((1, 20, 24, 28), 5, "Haar"),
    ((2, 9, 33, 70), 1, "Symlet 8"),
])
def test_3d_forward_depth_runs_match_plain(dev, shape, level, name, dtype):
    """The forward's runs along depth: the last run ends inside its ring
    and reads across the volume's end."""
    w = jt.wavelet(name)
    b, d, r, c = shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    halos = [k3.level_halo(w.length, j) for j in range(1, level + 1)]
    runs = [k3.fwd3_depth_run(b, d, r, c, h, w.length, sms) for h in halos]
    assert any(d % dc for dc in runs) or d <= max(halos) or level != 2
    x = _signal(dev, *shape, seed=22, dtype=dtype)
    coeffs = k3.modwt3_fwd_cuda(x, w, level)
    _close(coeffs, k3.modwt3_fwd_plain(x, w, level), dtype)
    back = k3.modwt3_inv_cuda(coeffs, w)
    tol = 1e-1 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(back.float(), x.float(), rtol=0, atol=tol)


def test_3d_public_path_launches_each_kernel(dev):
    w = DB4
    x = _signal(dev, 2, 16, 24, 20, seed=17)
    counters = ("modwt3_fwd", "modwt3_inv", "modwpt_fwd", "modwpt_inv")
    before = [LAUNCHES[op] for op in counters]
    c = jt.modwt3(x, w, 2)
    xr = jt.imodwt3(c, w)
    den = jt.modwt3_denoise(x, w, 2)
    p = jt.modwpt3(x, w, 1)
    xp = jt.imodwpt3(p, w)
    torch.cuda.synchronize()
    # the denoise runs both kernels; the oct tree one 1D launch per axis
    assert [LAUNCHES[op] - b for op, b in zip(counters, before)] == [
        2, 2, 3, 3]
    torch.testing.assert_close(xr, x, rtol=0, atol=1e-4)
    torch.testing.assert_close(xp, x, rtol=0, atol=1e-4)
    want = jt.modwt3_denoise(x.double(), w, 2).float()
    torch.testing.assert_close(den, want, rtol=0, atol=1e-4)
    assert c.device == den.device == p.device == x.device


def test_3d_auto_routes_f64_grad_and_unsupported_shapes_to_plain(dev):
    counters = ("modwt3_fwd", "modwt3_inv")
    before = [LAUNCHES[op] for op in counters]
    x64 = _signal(dev, 2, 8, 8, 16, dtype=torch.float64)
    jt.imodwt3(jt.modwt3(x64, DB4, 2), DB4)
    jt.modwt3(_signal(dev, 1, 16, 16, 16), DB4, 3)   # Db4 L3 does not fit
    jt.modwt3(_signal(dev, 2, 2, 8, 8, 16), DB4, 1)  # 5-D: leading dims
    xg = _signal(dev, 2, 8, 8, 16).requires_grad_()
    (jt.modwt3(xg, DB4, 1) ** 2).sum().backward()
    assert [LAUNCHES[op] for op in counters] == before
    xp = xg.detach().clone().requires_grad_()
    (jt.modwt3(xp, DB4, 1, method="direct") ** 2).sum().backward()
    torch.testing.assert_close(xg.grad, xp.grad, rtol=0, atol=0)
    for bad, level in ((x64, 2), (xg, 1), (_signal(dev, 16, 16, 16), 3)):
        with pytest.raises(ValueError, match="unavailable"):
            jt.modwt3(bad, DB4, level, method="pallas")
    with pytest.raises(ValueError, match="no backward"):
        k3.modwt3_fused(xg, DB4, 1)


def test_3d_launchers_reject_what_the_kernel_does_not_take(dev):
    x = _signal(dev, 2, 8, 8, 16)
    with pytest.raises(ValueError, match="contiguous"):
        k3.modwt3_fwd_cuda(x[..., ::2], DB4, 1)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        k3.modwt3_fwd_cuda(x.double(), DB4, 1)
    with pytest.raises(ValueError, match="unsupported shape"):
        k3.modwt3_fwd_cuda(x, DB4, 3)                 # the windows do not fit
    with pytest.raises(ValueError, match="7·level\\+1"):
        k3.modwt3_inv_cuda(_signal(dev, 9, 2, 8, 8, 16), DB4)
    with pytest.raises(ValueError, match="expected 5 dims"):
        k3.modwt3_inv_cuda(x, DB4)


# -- the CWT kernel -----------------------------------------------------------

def _cwt_operands(dev, wav, b, s, p, seed):
    from jwave_pro_tpu_torch.ops.cwt import _full_spectrum_multipliers

    scales = tuple(jt.generate_log_scales(1.0, 64.0, s))
    m, is_real = _full_spectrum_multipliers(wav, scales, p, 1.0)
    x = _signal(dev, b, p, seed=seed)
    xf = torch.fft.fft(x.to(torch.complex64))
    return xf, torch.from_numpy(m).to(dev, torch.complex64), is_real


@pytest.mark.parametrize("wav", [jt.MorletWavelet(), jt.MexicanHatWavelet()])
@pytest.mark.parametrize("b,s,p,n", [(3, 7, 64, 64), (2, 13, 1024, 1000),
                                     (2, 5, 16384, 16000), (1, 3, 8192, 8192),
                                     (4, 9, 128, 100)])
def test_cwt_kernel_matches_plain_and_cufft(dev, wav, b, s, p, n):
    xf, m, is_real = _cwt_operands(dev, wav, b, s, p, seed=18)
    got = kcw.cwt_ifft_cuda(xf, m, n, is_real)
    assert got.shape == (b, s, n)
    assert got.dtype == (torch.float32 if is_real else torch.complex64)
    plain = kcw.cwt_ifft_plain(xf, m, n, is_real)
    lib = torch.fft.ifft(xf[:, None, :] * m, dim=-1)[..., :n]
    lib = lib.real if is_real else lib
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-4 * scale
    assert float((got - lib).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("wav", [jt.MorletWavelet(), jt.MexicanHatWavelet()])
@pytest.mark.parametrize("p", [1 << lg for lg in range(6, 15)])
def test_cwt_kernel_every_length_ragged_rows(dev, wav, p):
    """Every P the kernel takes, n < P, and 3 × 11 rows: no multiple of the
    2 to 32 rows a block holds below P = 4096."""
    xf, m, is_real = _cwt_operands(dev, wav, 3, 11, p, seed=22)
    n = p - 3
    got = kcw.cwt_ifft_cuda(xf, m, n, is_real)
    plain = kcw.cwt_ifft_plain(xf, m, n, is_real)
    lib = torch.fft.ifft(xf[:, None, :] * m, dim=-1)[..., :n]
    lib = lib.real if is_real else lib
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-4 * scale
    assert float((got - lib).abs().max()) <= 1e-4 * scale


def test_cwt_public_path_launches_the_kernel(dev):
    x = _signal(dev, 4, 3000, seed=19)
    scales = jt.generate_log_scales(1.0, 64.0, 11)
    before = LAUNCHES["cwt_ifft"]
    for wav in (jt.MorletWavelet(), jt.MexicanHatWavelet()):
        fused = jt.cwt(x, scales, wav, method="fused").coefficients
        fft = jt.cwt(x, scales, wav, method="fft").coefficients
        assert fused.dtype == fft.dtype and fused.device == x.device
        scale = float(fft.abs().max())
        assert float((fused - fft).abs().max()) <= 1e-4 * scale
    assert LAUNCHES["cwt_ifft"] == before + 2
    # float64 and padded lengths outside [64, 16384] take the 'fft' path
    jt.cwt(x.double(), scales, jt.MorletWavelet(), method="fused")
    jt.cwt(x[:, :20], scales, jt.MorletWavelet(), method="fused")
    jt.cwt(_signal(dev, 1, 20000), scales, jt.MorletWavelet(),
           method="fused")
    assert LAUNCHES["cwt_ifft"] == before + 2


def test_cwt_launcher_rejects_what_the_kernel_does_not_take(dev):
    xf, m, _ = _cwt_operands(dev, jt.MorletWavelet(), 2, 3, 256, seed=20)
    with pytest.raises(ValueError, match="complex64"):
        kcw.cwt_ifft_cuda(xf.to(torch.complex128), m, 256, False)
    with pytest.raises(ValueError, match="contiguous"):
        kcw.cwt_ifft_cuda(xf[:, ::2], m[:, ::2], 128, False)
    with pytest.raises(ValueError, match="unsupported length"):
        kcw.cwt_ifft_cuda(xf[:, :100].contiguous(), m[:, :100].contiguous(),
                          100, False)
    with pytest.raises(ValueError, match="unsupported length"):
        kcw.cwt_ifft_cuda(xf, m, 300, False)
    with pytest.raises(ValueError, match="\\(S, P\\)"):
        kcw.cwt_ifft_cuda(xf, m[:, :128].contiguous(), 128, False)


# -- where a public entry point puts its input --------------------------------

def test_numpy_input_runs_on_the_card(dev):
    x = np.random.default_rng(23).standard_normal((4, 3000)).astype(
        np.float32)
    before = LAUNCHES["modwt_fwd"]
    c = jt.modwt(x, DB4, 3)
    assert c.is_cuda and c.dtype == torch.float32
    assert LAUNCHES["modwt_fwd"] == before + 1
    want = kc.modwt_fwd_plain(torch.from_numpy(x), DB4, 3)
    torch.testing.assert_close(c.cpu(), want, rtol=0, atol=1e-5)


# -- the decimated core: cuBLAS matmuls, no kernel of this package ------------

@pytest.mark.parametrize("setting", ["matmul precision", "per backend"])
def test_fwt_holds_f32_under_tf32(dev, setting):
    """With the process set to TF32 (through either of torch's settings),
    the port's pinned products keep ``fwt`` within the 1e-5 forward bound
    of the host f64 result, and the round trip within 1e-4; no kernel of
    this package runs."""
    mm = torch.backends.cuda.matmul
    if setting == "per backend" and not hasattr(mm, "fp32_precision"):
        pytest.skip("torch without the per-backend fp32_precision setting")
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (4, 1 << 16)))
    want = jt.fwt(x, DB4, 5)
    before = LAUNCHES["modwt_fwd"]
    try:
        if setting == "per backend":
            mm.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("high")
        got = jt.fwt(x.float().to(dev), DB4, 5)
        back = jt.ifwt(got, DB4, 5)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert LAUNCHES["modwt_fwd"] == before
    scale = float(want.abs().max())
    assert float((got.cpu().double() - want).abs().max()) <= 1e-5 * scale
    assert float((back.cpu().double() - x).abs().max()) <= 1e-4 * float(
        x.abs().max())


def test_decimated_bf16_on_the_card(dev):
    """bf16 in, bf16 out (constants rounded to bf16), within 5e-2 of the
    host f64 result of the same bf16 input."""
    x = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (4, 1 << 14))).to(torch.bfloat16)
    got = jt.fwt(x.to(dev), DB4, 5)
    assert got.dtype == torch.bfloat16
    want = jt.fwt(x.double(), DB4, 5)
    assert float((got.cpu().double() - want).abs().max()) <= 5e-2 * float(
        want.abs().max())
    sym8 = jt.wavelet("Symlet 8")
    p = jt.wpt(x.to(dev), sym8, 6)
    assert p.dtype == torch.bfloat16
    want = jt.wpt(x.double(), sym8, 6)
    assert float((p.cpu().double() - want).abs().max()) <= 5e-2 * float(
        want.abs().max())


# -- the decimated backward under TF32, the banded CWT's tiers ---------------

def _dtcwt_flat(v):
    """The DTCWT's coefficients as one real tensor (both parts of each
    complex band, then both lowpass rows)."""
    r = jt.dtcwt(v, 5)
    parts = [p for h in r.highpass for p in (h.real, h.imag)]
    return torch.cat(parts + [r.lowpass_a, r.lowpass_b], dim=-1)


GRAD_FNS = {
    "fwt": lambda v: jt.fwt(v, DB4, 5),
    "ifwt": lambda v: jt.ifwt(v, DB4, 5),
    "wpt": lambda v: jt.wpt(v, jt.wavelet("Symlet 8"), 6),
    "dtcwt": _dtcwt_flat,
}


@pytest.mark.parametrize("fn", sorted(GRAD_FNS))
@pytest.mark.parametrize("setting", ["matmul precision", "per backend"])
def test_gradients_hold_f32_under_tf32(dev, setting, fn):
    """With the process set to TF32 (through either of torch's settings),
    the gradient of sum(f(x)·g) stays within 1e-5 relative of the host
    f64 gradient: the products' backward is pinned to IEEE f32 too."""
    mm = torch.backends.cuda.matmul
    if setting == "per backend" and not hasattr(mm, "fp32_precision"):
        pytest.skip("torch without the per-backend fp32_precision setting")
    f = GRAD_FNS[fn]
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.standard_normal((4, 1 << 16)))
    g = torch.from_numpy(rng.standard_normal(tuple(f(x).shape)))

    def vjp(v, gv):
        v = v.detach().requires_grad_()
        return torch.autograd.grad(f(v), v, grad_outputs=gv)[0]

    want = vjp(x, g)
    try:
        if setting == "per backend":
            mm.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("high")
        got = vjp(x.float().to(dev), g.float().to(dev))
    finally:
        torch.set_float32_matmul_precision("highest")
    err = float((got.cpu().double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("precision,tol,atol", [
    ("highest", 2e-5, 0.0), ("high", 1e-3, 1e-6), ("default", 2e-2, 0.0)])
def test_banded_tiers_on_the_card(dev, precision, tol, atol):
    """The banded CWT's three product tiers within the JAX tests' bounds of
    the host f64 irfft path, at bench.py's shape; the call leaves the
    process's float32 matmul setting as it found it."""
    rng = np.random.default_rng(27)
    x = rng.standard_normal((16, 4096)).astype(np.float32)
    scales = jt.generate_log_scales(1.0, 256.0, 64)
    wav = jt.MorletWavelet()
    want = jt.cwt(torch.from_numpy(x).double(), scales, wav,
                  method="fft").coefficients
    before = torch.get_float32_matmul_precision()
    got = jt.cwt(torch.from_numpy(x).to(dev), scales, wav, method="banded",
                 precision=precision).coefficients
    assert torch.get_float32_matmul_precision() == before
    assert got.dtype == torch.complex64
    err = float((got.cpu().to(torch.complex128) - want).abs().max())
    assert err <= tol * float(want.abs().max()) + atol


def test_streaming_path_launches_the_forward_kernel(dev):
    """A stream's (halo + chunk,) window runs the flat forward (#2), one
    launch an incremental update; ``modwt_chunked`` over batched chunks
    runs the batched forward (#1), one launch a chunk.  The incremental
    coefficients equal the whole signal's MODWT on the columns ≥ halo
    (1e-5 absolute, the forward's bound), and so do the chunked ones."""
    from jwave_pro_tpu_torch import streaming as st

    level, buf, chunk = 5, 4096, 1024
    halo = (DB4.length - 1) * ((1 << level) - 1)
    sig = _signal(dev, 8 * chunk, seed=31)
    s = st.StreamingMODWT(DB4, st.StreamingConfig(buffer_size=buf,
                                                  max_level=level))
    before = LAUNCHES["modwt_fwd"]
    for i in range(0, sig.shape[-1], chunk):
        out = s.update(sig[i:i + chunk])
    torch.cuda.synchronize()
    assert LAUNCHES["modwt_fwd"] - before == 8
    assert out.device == sig.device and out.dtype == torch.float32
    full = jt.modwt(sig.double().cpu(), DB4, level)[..., -buf:]
    torch.testing.assert_close(out.cpu().double()[..., halo:],
                               full[..., halo:], rtol=0, atol=1e-5)

    x = _signal(dev, 4, 8 * chunk, seed=32)
    before = LAUNCHES["modwt_fwd"]
    parts = list(st.modwt_chunked(x.split(chunk, dim=-1), DB4, level))
    torch.cuda.synchronize()
    assert LAUNCHES["modwt_fwd"] - before == 8
    got = torch.cat(parts, dim=-1).cpu().double()
    want = jt.modwt(x.double().cpu(), DB4, level)
    torch.testing.assert_close(got[..., halo:], want[..., halo:], rtol=0,
                               atol=1e-5)


# -- the kernel operators and the serving export ------------------------------

def test_exported_pipelines_launch_their_kernels(dev):
    """An exported denoise (forward and inverse kernels, or the fused
    kernel) and variance (the variance kernel), served from bytes on the
    card at three batch sizes from one artifact: each call launches its
    kernels once, and the output is bitwise the eager call's."""
    x = _signal(dev, 8, 8192, seed=40)
    counters = {"fwd": "modwt_fwd", "inv": "modwt_inv",
                "fused": "modwt_denoise", "var": "modwt_var"}
    pipelines = (
        (lambda v: jt.modwt_denoise(v, DB4, 5, threshold=0.8),
         {"fwd": 1, "inv": 1}),
        (lambda v: jt.modwt_denoise(v, DB4, 5, threshold=0.8,
                                    method="fused"), {"fused": 1}),
        (lambda v: jt.modwt_variance(v, DB4, 5), {"var": 1}))
    for fn, want in pipelines:
        served = jt.load_pipeline(jt.export_pipeline(
            fn, x, batch_polymorphic=True))
        for b in (1, 3, 8):
            before = {k: LAUNCHES[op] for k, op in counters.items()}
            got = served(x[:b])
            torch.cuda.synchronize()
            ran = {k: LAUNCHES[op] - before[k] for k, op in counters.items()}
            assert ran == {k: want.get(k, 0) for k in counters}
            assert torch.equal(got, fn(x[:b]))


def test_operator_checks_of_the_1d_kernels(dev):
    """``torch.library.opcheck`` (schema, fake against the launch, the
    autograd registration, a traced dynamic-shape call) on the 1D
    operators #1-#5 at a small shape."""
    g, h = kc.op_taps(DB4)
    x = _signal(dev, 3, 1000, seed=41)
    c = kc.modwt_fwd_cuda(x, DB4, 3)
    thr = torch.full((3,), 0.5, device=dev)
    for op, args in ((torch.ops.jwave.modwt_fwd, (x, g, h, 3)),
                     (torch.ops.jwave.modwt_inv, (c, g, h)),
                     (torch.ops.jwave.modwt_denoise, (x, thr, g, h, 3, 0)),
                     (torch.ops.jwave.modwt_var, (x, g, h, 3))):
        torch.library.opcheck(op, args)
    torch.library.opcheck(torch.ops.jwave.f32_mm,
                          (x, torch.ones(1000, 7, device=dev), 0))


@pytest.mark.parametrize("setting", ["matmul precision", "per backend"])
def test_exported_fwt_keeps_ieee_f32_under_tf32(dev, setting):
    """An exported ``fwt`` served with the process set to TF32 (through
    either of torch's settings) keeps its products in IEEE f32: within
    the 1e-5 forward bound of the host f64 result, as eager ``fwt``."""
    mm = torch.backends.cuda.matmul
    if setting == "per backend" and not hasattr(mm, "fp32_precision"):
        pytest.skip("torch without the per-backend fp32_precision setting")
    x = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (4, 1 << 16)))
    want = jt.fwt(x, DB4, 5)
    served = jt.load_pipeline(jt.export_pipeline(
        lambda v: jt.fwt(v, DB4, 5), x.float().to(dev)))
    try:
        if setting == "per backend":
            mm.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("high")
        got = served(x.float().to(dev))
    finally:
        torch.set_float32_matmul_precision("highest")
    scale = float(want.abs().max())
    assert float((got.cpu().double() - want).abs().max()) <= 1e-5 * scale


def test_time_chain_times_the_card(dev):
    """``time_chain`` on a CUDA tensor: CUDA events around chained steps
    through the forward kernel, one launch a step, give a positive time
    above the 1e-9 floor."""
    x = torch.randn(4, 4096, device=dev)
    LAUNCHES["modwt_fwd"] = 0
    dt = jt.time_chain(lambda v: jt.modwt(v, DB4, 3)[3], x, 2, 5, 2)
    assert LAUNCHES["modwt_fwd"] == (2 + 5) * (1 + 2)
    assert 1e-9 < dt < 1
