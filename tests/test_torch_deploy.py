"""The port's serving export (``utils/deploy.py``) and its kernel operators,
on the CPU.

The three cases of ``tests/test_deploy.py``, served from bytes: the MODWT
denoise within 1e-6 and the wavelet variance within 1e-6 relative of the
eager port (and of the JAX package's eager call), and ``preprocess_prices``
exported batch-polymorphic and served at b = 1, 3, 8 within 1e-5 — on the
CPU the served graph is bitwise the eager port's.  The kernel operators
(``torch.ops.jwave.*``): each one's fake, run on ``meta`` tensors, gives the
shape and dtype of its plain version's output; and each records as one
node of a batch-polymorphic export of CUDA-device fake tensors, its taps
as constants and no guard on the batch — what an export on the card
records (no card is needed to trace).  The launches themselves are the
card's tests (``tests/test_torch_kernels.py``).
"""
import importlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch.kernels import _launch as kl
from jwave_pro_tpu_torch.kernels import cwt_cuda as kw
from jwave_pro_tpu_torch.kernels import denoise_cuda as kd
from jwave_pro_tpu_torch.kernels import median_cuda as km
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
from jwave_pro_tpu_torch.kernels import modwt2_cuda as k2
from jwave_pro_tpu_torch.kernels import modwt3_cuda as k3
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
from jwave_pro_tpu_torch.kernels import variance_cuda as kv
from jwave_pro_tpu_torch.utils.deploy import _Pipeline

tfwt = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")

DB4 = jt.wavelet("Daubechies 4")
JDB4 = jw.wavelet("Daubechies 4")


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_export_roundtrip_denoise(rng):
    x = rng.standard_normal((4, 2048)).astype(np.float32)
    fn = lambda v: jt.modwt_denoise(v, DB4, 4, threshold=0.8)  # noqa: E731
    art = jt.export_pipeline(fn, _f32(x))
    assert isinstance(art, bytes) and len(art) > 100
    served = jt.load_pipeline(art)
    got = served(_f32(x))
    assert torch.equal(got, fn(_f32(x)))
    want = np.asarray(jw.modwt_denoise(jnp.asarray(x), JDB4, 4,
                                       threshold=0.8))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_export_batch_polymorphic(rng):
    fn = lambda v: jt.preprocess_prices(v)[0]  # noqa: E731
    p8 = _f32(np.exp(np.cumsum(0.01 * rng.standard_normal((8, 512)), -1)))
    served = jt.load_pipeline(jt.export_pipeline(fn, p8,
                                                 batch_polymorphic=True))
    for b in (1, 3, 8):
        got = served(p8[:b])
        torch.testing.assert_close(got, fn(p8[:b]), rtol=0, atol=1e-5)
        assert torch.equal(got, fn(p8[:b]))


def test_export_analysis_pipeline(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    fn = lambda v: jt.modwt_variance(v, DB4, 5)  # noqa: E731
    served = jt.load_pipeline(jt.export_pipeline(fn, _f32(x)))
    got = served(_f32(x))
    assert torch.equal(got, fn(_f32(x)))
    want = np.asarray(jw.modwt_variance(jnp.asarray(x), JDB4, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_export_platforms_and_devices(rng):
    x = _f32(rng.standard_normal((2, 64)))
    fn = lambda v: jt.fwt(v, DB4, 2)  # noqa: E731
    for ok in (None, ("cpu",), ["CPU"]):
        served = jt.load_pipeline(jt.export_pipeline(fn, x, platforms=ok))
        assert torch.equal(served(x), fn(x))
    for bad in (("cuda",), ("cpu", "tpu"), ("gpu",)):
        with pytest.raises(ValueError, match="export once per device"):
            jt.export_pipeline(fn, x, platforms=bad)
    with pytest.raises(ValueError, match="several devices"):
        jt.export_pipeline(lambda a, b: a + b, x, x.to("meta"))


def test_export_keeps_scalar_arguments_and_no_example_values(rng):
    x = _f32(rng.standard_normal((6, 256)))
    thr = torch.tensor(0.5)
    fn = lambda v, t: jt.soft_threshold(jt.fwt(v, DB4, 3), t)  # noqa: E731
    art = jt.export_pipeline(fn, x, thr, batch_polymorphic=True)
    served = jt.load_pipeline(art)
    for b in (1, 6):
        assert torch.equal(served(x[:b], thr), fn(x[:b], thr))
    # the example values are not in the artifact (its size does not grow
    # with them)
    big = _f32(rng.standard_normal((64, 256)))
    assert len(jt.export_pipeline(fn, big, thr, batch_polymorphic=True)) \
        < len(art) + 4 * 64 * 256 // 2


def test_export_leaves_the_constant_caches_real(rng):
    """An export traces with fakes; the device-constant caches (the
    decimated tier's banded constants, the EWMA's FIR blocks) keep no
    fake past it, so eager calls after an export are as before."""
    x = _f32(rng.standard_normal((2, 1024)))
    tfwt._on.cache_clear()
    jt.export_pipeline(lambda v: jt.fwt(v, jt.wavelet("Symlet 8"), 3), x)
    jt.export_pipeline(lambda v: jt.ewma_volatility(v, 0.9), x)
    assert not any(isinstance(t, FakeTensor) for t in
                   jt.wavelet("Symlet 8").tensor_banks("cpu", torch.float32))
    y = jt.fwt(x, jt.wavelet("Symlet 8"), 3)
    assert not isinstance(y, FakeTensor) and torch.isfinite(y).all()
    assert not isinstance(jt.ewma_volatility(x, 0.9), FakeTensor)


# -- the kernel operators -----------------------------------------------------

OPS = ("modwt_fwd", "modwt_inv", "modwt_denoise", "modwt_var", "modwpt_fwd",
       "modwpt_select", "modwpt_inv", "modwt2_fwd", "modwt2_inv",
       "modwt2_denoise", "modwt3_fwd", "modwt3_inv", "cwt_ifft", "median",
       "modwt_fwd_ctx", "modwt_inv_shrink", "modwt2_inv_shrink")
# operators that take float32 alone (the CWT's complex64)
F32_ONLY = ("cwt_ifft", "median")


def _operands(device, dtype=torch.float32):
    """Each operator's call on ``device`` tensors at a small shape, beside
    its plain version's call on CPU tensors of the same shape."""
    g, h = kl.op_taps(DB4)
    gen = torch.Generator().manual_seed(0)

    def t(*shape, dt=dtype):
        return torch.randn(shape, generator=gen).to(dt)

    def on(a):
        return a.to(device)

    x1, x2, x3 = t(3, 300), t(2, 40, 48), t(2, 8, 8, 16)
    ctx1 = t(3, kc.halo(DB4.length, 3))
    c1, p1, c2, c3 = t(4, 3, 300), t(8, 3, 300), t(7, 2, 40, 48), \
        t(8, 2, 8, 8, 16)
    thr1, thr2 = t(3, dt=torch.float32), t(2, dt=torch.float32)
    thr_l = t(3, 3)                  # a threshold a detail row of c1
    thr_b = t(6, 2)                  # a threshold a band and image of c2
    xf = t(2, 256, dt=torch.complex64)
    mult = t(5, 256, dt=torch.complex64)

    return {
        "modwt_fwd": ((on(x1), g, h, 3), lambda: kc.modwt_fwd_plain(x1, DB4,
                                                                    3)),
        "modwt_inv": ((on(c1), g, h), lambda: kc.modwt_inv_plain(c1, DB4)),
        "modwt_denoise": ((on(x1), on(thr1), g, h, 3, 0),
                          lambda: kd.modwt_denoise_plain(x1, thr1, DB4, 3)),
        "modwt_var": ((on(x1), g, h, 3),
                      lambda: kv.modwt_var_plain(x1, DB4, 3)),
        "modwpt_fwd": ((on(x1), g, h, 3),
                       lambda: kp.modwpt_fwd_plain(x1, DB4, 3)),
        "modwpt_select": ((on(x1), g, h, 3), lambda: torch.stack([
            v.float() for v in kp.modwpt_select_plain(x1, DB4, 3)])),
        "modwpt_inv": ((on(p1), g, h), lambda: kp.modwpt_inv_plain(p1, DB4)),
        "modwt2_fwd": ((on(x2), g, h, 2),
                       lambda: k2.modwt2_fwd_plain(x2, DB4, 2)),
        "modwt2_inv": ((on(c2), g, h), lambda: k2.modwt2_inv_plain(c2, DB4)),
        "modwt2_denoise": ((on(x2), on(thr2), g, h, 2, 1),
                           lambda: k2.modwt2_denoise_plain(x2, thr2, DB4, 2,
                                                           "hard")),
        "modwt3_fwd": ((on(x3), g, h, 1),
                       lambda: k3.modwt3_fwd_plain(x3, DB4, 1)),
        "modwt3_inv": ((on(c3), g, h), lambda: k3.modwt3_inv_plain(c3, DB4)),
        "cwt_ifft": ((on(xf), on(mult), 200, 0),
                     lambda: kw.cwt_ifft_plain(xf, mult, 200, False)),
        "median": ((on(x1), True), lambda: km.median_plain(x1, True)),
        "modwt_fwd_ctx": ((on(x1), on(ctx1), g, h, 3),
                          lambda: kc.modwt_fwd_ctx_plain(x1, ctx1, DB4, 3)),
        "modwt_inv_shrink": ((on(c1), on(thr_l), 0.0, g, h, 0),
                             lambda: kc.modwt_inv_shrink_plain(c1, thr_l, 0.0,
                                                               DB4)),
        "modwt2_inv_shrink": ((on(c2), on(thr_b), 0.0, g, h, 1),
                              lambda: k2.modwt2_inv_shrink_plain(
                                  c2, thr_b, 0.0, DB4, 1)),
    }


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in OPS for dtype in (torch.float32, torch.bfloat16)
    if name not in F32_ONLY or dtype == torch.float32])
def test_operator_fakes_match_plain_on_meta(name, dtype):
    args, plain = _operands("meta", dtype)[name]
    got = getattr(torch.ops.jwave, name)(*args)
    want = plain()
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == want.dtype


def test_f32_mm_fake_matches_matmul_on_meta():
    for a_shape, b_shape in (((3, 4, 5), (5, 6)), ((6, 5), (2, 5, 4))):
        for dt in (torch.float32, torch.complex64):
            a, b = torch.randn(a_shape, dtype=dt), torch.randn(b_shape,
                                                               dtype=dt)
            got = torch.ops.jwave.f32_mm(a.to("meta"), b.to("meta"), 1)
            want = torch.matmul(a, b)
            assert got.device.type == "meta"
            assert got.shape == want.shape and got.dtype == want.dtype


def test_operators_reject_cpu_tensors():
    """The operators launch kernels: a CPU tensor raises (the wrappers'
    plain versions are the CPU path)."""
    args, _ = _operands("cpu")["modwt_fwd"]
    with pytest.raises(ValueError, match="kernel needs a CUDA tensor"):
        torch.ops.jwave.modwt_fwd(*args)
    args, _ = _operands("cpu")["cwt_ifft"]
    with pytest.raises(ValueError, match="kernel needs a CUDA tensor"):
        torch.ops.jwave.cwt_ifft(*args)
    args, _ = _operands("cpu")["median"]
    with pytest.raises(ValueError, match="kernel needs a CUDA tensor"):
        torch.ops.jwave.median(*args)


def test_operator_fakes_reject_what_the_kernel_does_not_take():
    x = torch.empty(4, 1024, device="meta")
    g, h = kl.op_taps(DB4)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        torch.ops.jwave.modwt_fwd(x.double(), g, h, 2)
    with pytest.raises(ValueError, match="unsupported shape"):
        torch.ops.jwave.modwt_var(x, g, h, 12)
    with pytest.raises(ValueError, match="taps"):
        torch.ops.jwave.modwt_fwd(x, g, h[:-1], 2)
    with pytest.raises(ValueError, match="takes float32"):
        torch.ops.jwave.median(x.double(), True)
    with pytest.raises(ValueError, match="threshold"):
        torch.ops.jwave.modwt_inv_shrink(
            torch.empty(3, 4, 1024, device="meta"),
            torch.empty(2, 4, device="meta", dtype=torch.bfloat16), 0.0, g,
            h, 0)
    with pytest.raises(ValueError, match="2\\^level"):
        torch.ops.jwave.modwpt_inv(torch.empty(3, 4, 1024, device="meta"),
                                   g, h)


C64 = torch.complex64


def _recorded(fn, *specs):
    """The call targets of a batch-polymorphic export of ``fn`` on fake
    CUDA tensors of ``specs`` ((shape, dtype, batched) each; the batched
    ones share the symbolic leading dimension)."""
    with FakeTensorMode():
        args = tuple(torch.empty(shape, device="cuda", dtype=dt)
                     for shape, dt, _ in specs)
    b = torch.export.Dim("b", min=1)
    ep = torch.export.export(_Pipeline(fn), args, dynamic_shapes=(tuple(
        {0: b} if batched else None for *_, batched in specs),))
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"]
    return ({str(n.target) for n in nodes}
            - {"aten.sym_size.int", "aten.reshape.default"}), nodes


F32 = torch.float32


@pytest.mark.parametrize("op,args", [
    ("modwt_inv", ()), ("modwt_inv_shrink", (None, 0.5)),
])
def test_export_keeps_the_level_axis_symbolic(op, args):
    """The inverse operators' fakes plan from the coefficients' level axis;
    an export that makes that axis symbolic, as ``torch.library.opcheck``'s
    dynamic-shape check does, keeps it symbolic (the cached plan is keyed
    on concrete levels only)."""
    g, h = kl.op_taps(DB4)
    call = getattr(torch.ops.jwave, op)
    fn = ((lambda c: call(c, *args, g, h, 0)) if args
          else (lambda c: call(c, g, h)))
    with FakeTensorMode():
        c = torch.empty((6, 8, 4096), device="cuda")
    dims = {0: torch.export.Dim("rows", min=2, max=12),
            1: torch.export.Dim("b", min=1)}
    ep = torch.export.export(_Pipeline(fn), (c,), dynamic_shapes=((dims,),))
    assert len(ep.range_constraints) == 2


@pytest.mark.parametrize("launch,specs,ops", [
    (lambda v: kc.imodwt_fused(kc.modwt_fused(v, DB4, 5), DB4),
     [((8, 4096), F32, True)], {"modwt_fwd", "modwt_inv"}),
    (lambda v, t: kd.modwt_denoise_cuda(v, t, DB4, 5),
     [((8, 4096), F32, True), ((8,), F32, True)], {"modwt_denoise"}),
    (lambda v: kv.modwt_var_fused(v, DB4, 5), [((8, 4096), F32, True)],
     {"modwt_var"}),
    (lambda v: kp.imodwpt_fused(kp.modwpt_fused(v, DB4, 3), DB4),
     [((8, 4096), F32, True)], {"modwpt_fwd", "modwpt_inv"}),
    (lambda v: kp.modwpt_select_cuda(v, DB4, 3)[2],
     [((8, 4096), F32, True)], {"modwpt_select", "aten.unbind.int",
                                "aten.view.dtype",
                                "<built-in function getitem>"}),
    (lambda v: k2.imodwt2_fused(k2.modwt2_fused(v, DB4, 2), DB4),
     [((2, 64, 64), F32, True)], {"modwt2_fwd", "modwt2_inv"}),
    (lambda v, t: k2.modwt2_denoise_cuda(v, t, DB4, 2),
     [((2, 64, 64), F32, True), ((2,), F32, True)], {"modwt2_denoise"}),
    (lambda v: k3.imodwt3_fused(k3.modwt3_fused(v, DB4, 1), DB4),
     [((2, 16, 16, 32), F32, True)], {"modwt3_fwd", "modwt3_inv"}),
    (lambda a, m: kw.cwt_ifft_cuda(a, m, 1000, False),
     [((4, 1024), C64, True), ((6, 1024), C64, False)], {"cwt_ifft"}),
    (lambda v: km.median_rows(v, True), [((8, 4096), F32, True)],
     {"median"}),
    (lambda v, c: kc.modwt_fwd_ctx_cuda(v, c, DB4, 5),
     [((8, 4096), F32, True), ((8, 217), F32, True)], {"modwt_fwd_ctx"}),
    (lambda v, t: kc.modwt_inv_shrink_cuda(
        kc.modwt_fused(v, DB4, 5), t.expand(5, -1), 0.0, DB4, 1),
     [((8, 4096), F32, True), ((8,), F32, True)],
     {"modwt_fwd", "modwt_inv_shrink", "aten.expand.default"}),
    # the served denoise of utils/deploy.py: the shrink inside the inverse
    (lambda v: jt.modwt_denoise(v, DB4, 5, threshold=0.8),
     [((8, 4096), F32, True)], {"modwt_fwd", "modwt_inv_shrink"}),
    (lambda a, m: tfwt._mm(a, m, True),
     [((8, 64, 32), F32, True), ((32, 16), F32, False)], {"f32_mm"}),
])
def test_export_records_each_operator_as_one_node(launch, specs, ops):
    """A batch-polymorphic export of a CUDA tensor's call records the
    operator (``jwave.<name>.default``), with the taps as constants, and
    the batch stays symbolic: the plan that depends on it is the
    operator's own, at serving time."""
    got, nodes = _recorded(launch, *specs)
    want = {o if "." in o or o.startswith("<") else f"jwave.{o}.default"
            for o in ops}
    assert got == want
    for n in nodes:
        if str(n.target) in ("jwave.modwt_fwd.default",
                             "jwave.modwt_var.default"):
            g, h = kl.op_taps(DB4)
            assert list(n.args[1]) == g and list(n.args[2]) == h
        if str(n.target) == "jwave.modwt_fwd_ctx.default":
            g, h = kl.op_taps(DB4)
            assert list(n.args[2]) == g and list(n.args[3]) == h
        if str(n.target) == "jwave.modwt_inv_shrink.default":
            g, h = kl.op_taps(DB4)
            assert list(n.args[3]) == g and list(n.args[4]) == h
