"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the decision is
made in a fixture, at run time.  The file imports neither JAX nor the JAX
package, so on a machine without JAX it runs alone, without the suite's
conftest:

    python -m pytest tests/test_torch_kernels.py -q --noconftest -o addopts=""

Tolerances: f32 forward 1e-5 and inverse 1e-4 absolute (the on-chip bounds
the JAX package's TPU smoke holds its kernels to: both compute in f32 in a
different order); bf16 one bf16 ulp plus the f32 noise (relative 2⁻⁷,
absolute 1e-5), since both round the same f32 results once.
"""
import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch.kernels import denoise_cuda as kd
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc

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


def test_public_path_launches_each_kernel(dev):
    x = _signal(dev, 4, 8192, seed=2)
    counters = (kc.modwt_fwd_cuda, kc.modwt_inv_cuda, kd.modwt_denoise_cuda)
    before = [fn.launches for fn in counters]
    c = jt.modwt(x, DB4, 5)
    xr = jt.imodwt(c, DB4)
    den = jt.modwt_denoise(x, DB4, 5, method="fused")
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1, 1]
    torch.testing.assert_close(xr, x, rtol=0, atol=1e-4)
    torch.testing.assert_close(
        den, jt.modwt_denoise(x, DB4, 5, method="direct"), rtol=0, atol=1e-5)
    # outputs stay on the input's device
    assert c.device == x.device == den.device


def test_auto_routes_f64_and_unsupported_shapes_to_plain(dev):
    before = kc.modwt_fwd_cuda.launches
    jt.modwt(_signal(dev, 2, 1024, dtype=torch.float64), DB4, 3)
    jt.modwt(_signal(dev, 1 << 14), DB4, 13)   # Db4 L13 does not fit
    assert kc.modwt_fwd_cuda.launches == before
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
