"""The port's sharded tier (``jwave_pro_tpu_torch.parallel``) against the
JAX package's, on the CPU.

How it runs: every sharded call runs in spawned gloo worlds, started with
a file store under a ``tmp_path_factory`` directory (no port to clash
between xdist workers).  One module-scoped world of 4 ranks builds the
meshes ``{"signal": 4}``, ``{"scale": 4}``, ``{"data": 2, "signal": 2}``,
``{"data": 2, "scale": 2}`` and ``{"data": 4, "signal": 1}`` (a size-1
axis in a multi-rank world); one world of 1 rank builds its meshes with
no process group (``make_mesh`` starts it) and covers the identity hops.
Each rank runs every case of its world (:data:`CASES`) and writes the
gathered results, any error and the collectives it posted
(``parallel.sharded.COLLECTIVES``) to ``rank<r>.npz``; the tests compare
those files with the JAX package in this process.  Each world's join has
a timeout and its fixture checks every rank's exit code, so a dead rank
fails the tests instead of hanging them.  The worker side imports only
torch, numpy and the port (spawn re-imports this module): JAX is imported
inside the test functions.

Inputs are numpy float64 arrays from a seed.  Tolerances:

* the exact transforms and round trips against the JAX package's
  single-device function, 1e-10 absolute (``tests/test_parallel.py``'s
  bounds); the CWT, 2D CWT, synchrosqueezing and scattering 1e-12
  relative to max|ref| (``test_torch_cwt.py``, ``test_torch_cwt2d.py``,
  ``test_torch_ssq.py``, ``test_torch_scattering.py``), the SSQ bins
  exact (Tx's support as a mask); the overlap-save CWT 2e-6 absolute
  against the periodic single-device CWT (the JAX test's bound: the
  wavelet's tail beyond the halo) and 1e-12 relative against JAX's
  overlap-save;
* against the JAX package's sharded function on a mesh of
  ``jax.devices()[:4]``: ``fwt_sharded``'s per-shard layout 1e-10,
  ``cwt_signal_sharded`` 1e-12 relative, ``ssq_sharded`` (both γ) as
  above, ``scattering_sharded``'s padded ``pairs`` exactly and ``s2``
  1e-12 relative; the other 15 in one ``slow`` test;
* gradients of ``modwt_sharded``, ``imodwt_sharded`` and ``fwt_sharded``
  through the ring against ``jax.grad`` of the single-device function,
  1e-9 relative;
* the dry run of ``__graft_entry__.dryrun_multichip`` through the port
  at float32: finite, and each output within 1e-5 × max|ref| of the
  port's single-device calls (1e-4 for the overlap-save CWT and
  synchrosqueezing, whose float32 sums run in another order).
"""
import importlib
import multiprocessing
import traceback
import zlib

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt

SEED = 20261018
KINDS = ("hop", "all_gather", "all_reduce_sum", "all_reduce_max",
         "all_to_all")
MESHES = {"signal": {"signal": 4}, "scale": {"scale": 4},
          "data_signal": {"data": 2, "signal": 2},
          "data_scale": {"data": 2, "scale": 2},
          "data4": {"data": 4, "signal": 1}}
JOIN_TIMEOUT = 180
DB4 = "Daubechies 4"
FWT_CASES = (("Haar", 3), ("Daubechies 4", 3), ("Symlet 8", 2))


def _x(name, *shape):
    """The case's float64 input, the same in every rank and the parent."""
    rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
    return rng.standard_normal(shape)


def _tone(n=512, fs=512.0):
    """Two tones and noise.  No instantaneous frequency sits on a half-
    integer bin (a 40 Hz tone would, on this grid: round-half-to-even then
    turns on the last bit of the log)."""
    t = np.arange(n) / fs
    return (np.sin(2 * np.pi * 37 * t) + 0.3 * np.sin(2 * np.pi * 83 * t)
            + 0.1 * _x("tone", n))


def _ssq_scales():
    fc = jt.MorletWavelet().center_frequency
    return jt.generate_log_scales(fc / 160, fc / 10, 16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# The worker side: each case runs in every rank and returns arrays.
# ---------------------------------------------------------------------------

CASES = {"w4": {}, "w1": {}}


def _case(world, name, mesh):
    def register(fn):
        CASES[world][name] = (mesh, fn)
        return fn
    return register


@_case("w4", "modwt", "signal")
def _modwt(par, m):
    return {"c": par.modwt_sharded(_t(_x("modwt", 3, 512)),
                                   jt.wavelet(DB4), 4, m)}


@_case("w4", "modwt_multihop", "signal")
def _modwt_multihop(par, m):
    # the level-5 halo 7·31 = 217 > the 64-sample shard: four hops
    return {"c": par.modwt_sharded(_t(_x("modwt_multihop", 256)),
                                   jt.wavelet(DB4), 5, m)}


@_case("w4", "modwt_2d_mesh", "data_signal")
def _modwt_2d_mesh(par, m):
    return {"c": par.modwt_sharded(_t(_x("modwt_2d_mesh", 4, 256)),
                                   jt.wavelet(DB4), 3, m)}


@_case("w4", "modwt_size1", "data4")
def _modwt_size1(par, m):
    return {"c": par.modwt_sharded(_t(_x("modwt_size1", 4, 128)),
                                   jt.wavelet(DB4), 3, m)}


@_case("w4", "imodwt", "signal")
def _imodwt(par, m):
    c = jt.modwt(_t(_x("imodwt", 2, 512)), jt.wavelet(DB4), 4,
                 method="direct")
    return {"x": par.imodwt_sharded(c, jt.wavelet(DB4), m)}


@_case("w4", "imodwt_any", "signal")
def _imodwt_any(par, m):
    # coefficients that are no MODWT: the inverse operator itself
    return {"x": par.imodwt_sharded(_t(_x("imodwt_any", 5, 2, 512)),
                                    jt.wavelet(DB4), m)}


@_case("w4", "imodwt_2d_mesh", "data_signal")
def _imodwt_2d_mesh(par, m):
    w = jt.wavelet(DB4)
    c = par.modwt_sharded(_t(_x("imodwt_2d_mesh", 2, 256)), w, 3, m)
    return {"x": par.imodwt_sharded(c, w, m)}


@_case("w4", "modwt2", "signal")
def _modwt2(par, m):
    # level-3 halo 7·4 = 28 rows > the 16-row block: two hops
    w = jt.wavelet(DB4)
    c = par.modwt2_sharded(_t(_x("modwt2", 64, 48)), w, 3, m)
    return {"c": c, "x": par.imodwt2_sharded(c, w, m)}


@_case("w4", "imodwt2_any", "signal")
def _imodwt2_any(par, m):
    return {"x": par.imodwt2_sharded(_t(_x("imodwt2_any", 10, 64, 48)),
                                     jt.wavelet(DB4), m)}


@_case("w4", "modwt2_batched", "data_signal")
def _modwt2_batched(par, m):
    w = jt.wavelet(DB4)
    c = par.modwt2_sharded(_t(_x("modwt2_batched", 2, 32, 16)), w, 2, m)
    return {"c": c, "x": par.imodwt2_sharded(c, w, m)}


@_case("w4", "fwt", "signal")
def _fwt(par, m):
    out = {}
    for name, lvl in FWT_CASES:
        w = jt.wavelet(name)
        y = par.fwt_sharded(_t(_x("fwt" + name, 512)), w, lvl, m)
        out.update({f"y_{name}": y,
                    f"g_{name}": par.gather_fwt_layout(y, lvl, 4),
                    f"x_{name}": par.ifwt_sharded(y, w, lvl, m)})
    return out


@_case("w4", "fwt_batched", "data_signal")
def _fwt_batched(par, m):
    w = jt.wavelet(DB4)
    y = par.fwt_sharded(_t(_x("fwt_batched", 4, 256)), w, 2, m)
    return {"y": y, "g": par.gather_fwt_layout(y, 2, 2),
            "x": par.ifwt_sharded(y, w, 2, m)}


@_case("w4", "fwt2", "data4")
def _fwt2(par, m):
    return {"y": par.fwt2_sharded(_t(_x("fwt2", 16, 32)), jt.wavelet(DB4),
                                  m)}


@_case("w4", "dtcwt", "signal")
def _dtcwt(par, m):
    r = par.dtcwt_sharded(_t(_x("dtcwt", 2, 1024)), 3, m)
    out = {f"h{i}": h for i, h in enumerate(r.highpass)}
    out.update(la=r.lowpass_a, lb=r.lowpass_b)
    return out


@_case("w4", "idtcwt", "data_signal")
def _idtcwt(par, m):
    r = par.dtcwt_sharded(_t(_x("idtcwt", 2, 512)), 2, m)
    return {"x": par.idtcwt_sharded(r, m)}


@_case("w4", "wpt", "scale")
def _wpt(par, m):
    return {"y": par.wpt_sharded(_t(_x("wpt", 1024)), jt.wavelet(DB4), 5,
                                 m)}


@_case("w4", "iwpt", "scale")
def _iwpt(par, m):
    w = jt.wavelet(DB4)
    y = jt.wpt(_t(_x("iwpt", 1024)), w, 5)
    return {"x": par.iwpt_sharded(y, w, 5, m)}


@_case("w4", "iwpt_any", "scale")
def _iwpt_any(par, m):
    return {"x": par.iwpt_sharded(_t(_x("iwpt_any", 2, 1024)),
                                  jt.wavelet(DB4), 5, m)}


@_case("w4", "wpt_shallow", "scale")
def _wpt_shallow(par, m):
    # level 1 < log2(4): the rows are only distributed
    w = jt.wavelet(DB4)
    y = par.wpt_sharded(_t(_x("wpt_shallow", 2, 512)), w, 1, m)
    return {"y": y, "x": par.iwpt_sharded(y, w, 1, m)}


@_case("w4", "wpt_batched", "data_scale")
def _wpt_batched(par, m):
    w = jt.wavelet(DB4)
    y = par.wpt_sharded(_t(_x("wpt_batched", 4, 512)), w, 2, m)
    return {"y": y, "x": par.iwpt_sharded(y, w, 2, m)}


@_case("w4", "modwpt", "scale")
def _modwpt(par, m):
    x = _t(_x("modwpt", 96))
    return {f"y{lvl}": par.modwpt_sharded(x, jt.wavelet(DB4), lvl, m)
            for lvl in (2, 4)}   # level == k and level > k


@_case("w4", "imodwpt", "scale")
def _imodwpt(par, m):
    w = jt.wavelet(DB4)
    y = jt.modwpt(_t(_x("imodwpt", 128)), w, 4, method="direct")
    return {"x": par.imodwpt_sharded(y, w, m)}


@_case("w4", "imodwpt_any", "scale")
def _imodwpt_any(par, m):
    return {"x": par.imodwpt_sharded(_t(_x("imodwpt_any", 16, 128)),
                                     jt.wavelet(DB4), m)}


@_case("w4", "modwpt_batched", "data_scale")
def _modwpt_batched(par, m):
    w = jt.wavelet(DB4)
    y = par.modwpt_sharded(_t(_x("modwpt_batched", 4, 64)), w, 2, m)
    return {"y": y, "x": par.imodwpt_sharded(y, w, m)}


@_case("w4", "cwt", "scale")
def _cwt(par, m):
    s = jt.generate_log_scales(1.0, 32.0, 16)
    return {"c": par.cwt_sharded(_t(_x("cwt", 256)), s, jt.MorletWavelet(),
                                 m).coefficients}


@_case("w4", "cwt_batched", "data_scale")
def _cwt_batched(par, m):
    s = jt.generate_log_scales(1.0, 16.0, 8)
    return {"c": par.cwt_sharded(_t(_x("cwt_batched", 4, 256)), s,
                                 jt.MexicanHatWavelet(), m).coefficients}


@_case("w4", "cwt_signal", "signal")
def _cwt_signal(par, m):
    s = jt.generate_log_scales(5.0, 16.0, 8)
    return {"c": par.cwt_signal_sharded(_t(_x("cwt_signal", 4096)), s,
                                        jt.MorletWavelet(), m).coefficients}


@_case("w4", "cwt_signal_multihop", "signal")
def _cwt_signal_multihop(par, m):
    # max scale 96: default halo 96·4·2 = 768 > the 512-sample shard
    s = jt.generate_log_scales(8.0, 96.0, 4)
    return {"c": par.cwt_signal_sharded(_t(_x("cwt_signal_multihop", 2048)),
                                        s, jt.MorletWavelet(),
                                        m).coefficients}


@_case("w4", "cwt_signal_batched", "data_signal")
def _cwt_signal_batched(par, m):
    s = jt.generate_log_scales(2.0, 8.0, 6)
    return {"c": par.cwt_signal_sharded(_t(_x("cwt_signal_batched", 2, 2048)),
                                        s, jt.MexicanHatWavelet(),
                                        m).coefficients}


@_case("w4", "cwt2", "scale")
def _cwt2(par, m):
    img = _t(_x("cwt2", 24, 32))
    angles = np.linspace(0, np.pi, 2, endpoint=False)
    c = par.cwt2_sharded(img, np.linspace(2.0, 8.0, 4), jt.Morlet2D(), m,
                         angles=angles).coefficients
    cr = par.cwt2_sharded(img, np.linspace(1.5, 9.0, 8), jt.MexicanHat2D(),
                          m).coefficients
    return {"c": c, "cr": cr, "real": np.array(not cr.is_complex())}


@_case("w4", "cwt2_angles", "scale")
def _cwt2_angles(par, m):
    # 2 scales × 4 angles over 4 ranks: the planes shard by angle
    angles = np.linspace(0, np.pi, 4, endpoint=False)
    return {"c": par.cwt2_sharded(_t(_x("cwt2_angles", 16, 16)),
                                  [2.0, 5.0], jt.Morlet2D(), m,
                                  angles=angles).coefficients}


@_case("w4", "cwt2_batched", "data_scale")
def _cwt2_batched(par, m):
    return {"c": par.cwt2_sharded(_t(_x("cwt2_batched", 4, 16, 16)),
                                  np.linspace(2.0, 6.0, 8),
                                  jt.MexicanHat2D(), m).coefficients}


@_case("w4", "ssq", "scale")
def _ssq(par, m):
    r = par.ssq_sharded(_t(_tone()), _ssq_scales(), mesh=m,
                        sampling_rate=512.0)
    return {"Tx": r.Tx, "Wx": r.Wx, "freqs": r.ssq_freqs}


@_case("w4", "ssq_gamma", "scale")
def _ssq_gamma(par, m):
    r = par.ssq_sharded(_t(_tone()), _ssq_scales(), mesh=m,
                        sampling_rate=512.0, gamma=1e-4)
    return {"Tx": r.Tx, "Wx": r.Wx}


@_case("w4", "ssq_batched", "data_scale")
def _ssq_batched(par, m):
    x = _tone()[None] + 0.1 * _x("ssq_batched", 4, 512)
    r = par.ssq_sharded(_t(x), _ssq_scales(), mesh=m, sampling_rate=512.0)
    return {"Tx": r.Tx, "Wx": r.Wx}


@_case("w4", "scattering", "scale")
def _scattering(par, m):
    r = par.scattering_sharded(_t(_x("scattering", 1024)), j=4, q=2, mesh=m)
    return {"s0": r.s0, "s1": r.s1, "s2": r.s2, "pairs": r.pairs}


@_case("w4", "scattering_order1", "data_scale")
def _scattering_order1(par, m):
    r = par.scattering_sharded(_t(_x("scattering_order1", 4, 512)), j=4,
                               q=1, order=1, mesh=m)
    return {"s1": r.s1, "s2_none": np.array(r.s2 is None)}


@_case("w4", "scattering2d", "scale")
def _scattering2d(par, m):
    r = par.scattering2d_sharded(_t(_x("scattering2d", 32, 32)), j=2, l=4,
                                 mesh=m)
    return {"s0": r.s0, "s1": r.s1, "s2": r.s2, "pairs": r.pairs}


def _grad(par, m, spec, f, name, x_shape, cot_shape):
    """∂ Σ cot·f(x) / ∂x through the ring, x a leaf DTensor placed by
    ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    xd = distribute_tensor(_t(_x(name, *x_shape)), m,
                           par.NamedSharding(m, spec).placements)
    xd.requires_grad_()
    loss = (f(xd) * _t(_x(name + "_cot", *cot_shape))).sum()
    loss.backward()
    return {"grad": xd.grad.full_tensor()}


@_case("w4", "grad_modwt", "signal")
def _grad_modwt(par, m):
    w = jt.wavelet(DB4)
    return _grad(par, m, par.P(None, "signal"),
                 lambda v: par.modwt_sharded(v, w, 3, m).full_tensor(),
                 "grad_modwt", (2, 256), (4, 2, 256))


@_case("w4", "grad_imodwt", "data_signal")
def _grad_imodwt(par, m):
    w = jt.wavelet(DB4)
    return _grad(par, m, par.P(None, "data", "signal"),
                 lambda v: par.imodwt_sharded(v, w, m).full_tensor(),
                 "grad_imodwt", (4, 2, 256), (2, 256))


@_case("w4", "grad_fwt", "signal")
def _grad_fwt(par, m):
    w = jt.wavelet(DB4)
    return _grad(par, m, par.P(None, "signal"),
                 lambda v: par.gather_fwt_layout(par.fwt_sharded(v, w, 3, m),
                                                 3, 4),
                 "grad_fwt", (2, 512), (2, 512))


def _errors(calls):
    out = {}
    for key, call in calls.items():
        try:
            call()
            out[key] = np.array("no error")
        except ValueError as e:
            out[key] = np.array(str(e))
    return out


@_case("w4", "errors_signal", "signal")
def _errors_signal(par, m):
    w = jt.wavelet(DB4)
    return _errors({
        "modwt2_depth": lambda: par.modwt2_sharded(_t(_x("e", 16, 16)), w, 5,
                                                   m),
        "dtcwt_divisible": lambda: par.dtcwt_sharded(_t(_x("e", 64)), 5, m),
        "cwt_signal_divisible": lambda: par.cwt_signal_sharded(
            _t(_x("e", 2049)), [2.0, 4.0], jt.MexicanHatWavelet(), m),
        "cwt_signal_aliasing": lambda: par.cwt_signal_sharded(
            _t(_x("e", 1024)), [1.0, 8.0], jt.MorletWavelet(), m),
        "modwt_halo": lambda: par.modwt_sharded(_t(_x("e", 64)), w, 6, m),
        "fwt_divisible": lambda: par.fwt_sharded(_t(_x("e", 96)), w, 4, m),
    })


@_case("w4", "errors_scale", "scale")
def _errors_scale(par, m):
    x = _t(_x("e", 256))
    return _errors({
        "ssq_bins": lambda: par.ssq_sharded(
            x, jt.generate_log_scales(1., 16., 8), mesh=m, n_freqs=1),
        "ssq_uniform": lambda: par.ssq_sharded(
            x, [1., 2., 3., 4., 5., 6., 7., 8.], mesh=m),
        "cwt_scales": lambda: par.cwt_sharded(x, [1., 2., 3.],
                                              jt.MorletWavelet(), m),
        "cwt2_planes": lambda: par.cwt2_sharded(
            _t(_x("e", 8, 8)), [1., 2., 3.], jt.MexicanHat2D(), m),
        "scattering_paths": lambda: par.scattering_sharded(x, j=2, q=3,
                                                           mesh=m),
        "modwpt_level": lambda: par.modwpt_sharded(x, jt.wavelet(DB4), 1, m),
    })


@_case("w4", "alias_off", "signal")
def _alias_off(par, m):
    r = par.cwt_signal_sharded(_t(_x("alias_off", 1024)), [1.0, 8.0],
                               jt.MorletWavelet(), m, check_aliasing=False)
    return {"c": r.coefficients}


def _dryrun_outputs(par, jt_, v, mesh, signal):
    """``__graft_entry__.dryrun_multichip``'s step; ``par`` is the port's
    tier or, for the reference, single-device stand-ins (:class:`_Single`)."""
    w = jt_.wavelet(DB4)
    sym8 = jt_.wavelet("Symlet 8")
    c = par.modwt_sharded(v, w, 4, mesh)
    den = torch.cat([jt_.soft_threshold(c[:4], 0.1), c[4:]], dim=0)
    rec = par.imodwt_sharded(den, w, mesh)
    scales = jt_.generate_log_scales(1.0, 64.0, 4 * signal)
    cw = par.cwt_sharded(v, scales, jt_.MorletWavelet(), mesh,
                         scale_axis="signal")
    wp = par.iwpt_sharded(par.wpt_sharded(v, sym8, 4, mesh,
                                          packet_axis="signal"),
                          sym8, 4, mesh, packet_axis="signal")
    mp = par.imodwpt_sharded(par.modwpt_sharded(v, w, 4, mesh,
                                                node_axis="signal"),
                             w, mesh, node_axis="signal")
    fw = par.ifwt_sharded(par.fwt_sharded(v, w, 2, mesh), w, 2, mesh)
    dt = par.idtcwt_sharded(par.dtcwt_sharded(v, 2, mesh), mesh)
    cl = par.cwt_signal_sharded(v, jt_.generate_log_scales(5.0, 16.0, 3),
                                jt_.MorletWavelet(), mesh)
    sc = par.scattering_sharded(v, j=2, q=signal, mesh=mesh,
                                scale_axis="signal")
    sq = par.ssq_sharded(v, jt_.generate_log_scales(8.0, 32.0, 2 * signal),
                         mesh=mesh, scale_axis="signal", gamma=1e-4)
    img = v.reshape(v.shape[0], 16 * signal, -1)
    rec2 = par.imodwt2_sharded(par.modwt2_sharded(img, w, 2, mesh,
                                                  row_axis="signal"),
                               w, mesh, row_axis="signal")
    return {"rec": rec, "cw": cw.coefficients, "wp": wp, "mp": mp,
            "fw": fw, "dt": dt, "cl": cl.coefficients, "sc": sc.s1,
            "sq": sq.Tx, "rec2": rec2}


class _Single:
    """The step's calls on one device (the port's own transforms)."""

    modwt_sharded = staticmethod(
        lambda v, w, lvl, mesh: jt.modwt(v, w, lvl, method="direct"))
    imodwt_sharded = staticmethod(
        lambda c, w, mesh: jt.imodwt(c, w, method="direct"))
    cwt_sharded = staticmethod(
        lambda v, s, wav, mesh, scale_axis: jt.cwt(v, s, wav))
    wpt_sharded = staticmethod(
        lambda v, w, lvl, mesh, packet_axis: jt.wpt(v, w, lvl))
    iwpt_sharded = staticmethod(
        lambda y, w, lvl, mesh, packet_axis: jt.iwpt(y, w, lvl))
    modwpt_sharded = staticmethod(
        lambda v, w, lvl, mesh, node_axis: jt.modwpt(v, w, lvl,
                                                      method="direct"))
    imodwpt_sharded = staticmethod(
        lambda y, w, mesh, node_axis: jt.imodwpt(y, w, method="direct"))
    fwt_sharded = staticmethod(lambda v, w, lvl, mesh: v)
    ifwt_sharded = staticmethod(lambda y, w, lvl, mesh: y)
    dtcwt_sharded = staticmethod(lambda v, lvl, mesh: v)
    idtcwt_sharded = staticmethod(lambda r, mesh: r)
    cwt_signal_sharded = staticmethod(
        lambda v, s, wav, mesh: jt.cwt(v, s, wav, padding="periodic"))
    scattering_sharded = staticmethod(
        lambda v, j, q, mesh, scale_axis: jt.scattering1d(
            v, j, q, oversampling=64))
    ssq_sharded = staticmethod(
        lambda v, s, mesh, scale_axis, gamma: jt.ssq_cwt(v, s, gamma=gamma))
    modwt2_sharded = staticmethod(
        lambda img, w, lvl, mesh, row_axis: jt.modwt2(img, w, lvl,
                                                      method="direct"))
    imodwt2_sharded = staticmethod(
        lambda c, w, mesh, row_axis: jt.imodwt2(c, w, method="direct"))


@_case("w4", "dryrun", "data_signal")
def _dryrun(par, m):
    signal = 2
    x = np.random.default_rng(0).standard_normal(
        (4, 512 * signal)).astype(np.float32)
    got = _dryrun_outputs(par, jt, _t(x), m, signal)
    want = _dryrun_outputs(_Single, jt, _t(x), None, signal)
    out = {f"got_{k}": v for k, v in got.items()}
    out.update({f"want_{k}": v for k, v in want.items()})
    return out


# the world of one rank: meshes made with no process group running


@_case("w1", "w1_no_group", None)
def _w1_no_group(par, m):
    try:
        par.make_mesh({"signal": 2}, device_type="cpu")
        return {"msg": np.array("no error")}
    except RuntimeError as e:
        return {"msg": np.array(str(e))}


@_case("w1", "w1_mesh", None)
def _w1_mesh(par, m):
    default = par.make_mesh(device_type="cpu")
    try:
        par.make_mesh({"signal": 2}, device_type="cpu")
        msg = "no error"
    except ValueError as e:
        msg = str(e)
    return {"names": np.array(default.mesh_dim_names),
            "sizes": np.array(default.shape), "msg": np.array(msg)}


@_case("w1", "w1_modwt", {"signal": 1})
def _w1_modwt(par, m):
    w = jt.wavelet(DB4)
    c = par.modwt_sharded(_t(_x("w1_modwt", 2, 64)), w, 3, m)
    return {"c": c, "x": par.imodwt_sharded(c, w, m)}


@_case("w1", "w1_cwt_signal", {"signal": 1})
def _w1_cwt_signal(par, m):
    s = jt.generate_log_scales(5.0, 16.0, 4)
    return {"c": par.cwt_signal_sharded(_t(_x("w1_cwt_signal", 512)), s,
                                        jt.MorletWavelet(), m).coefficients}


@_case("w1", "w1_fwt", {"signal": 1})
def _w1_fwt(par, m):
    w = jt.wavelet(DB4)
    y = par.fwt_sharded(_t(_x("w1_fwt", 256)), w, 3, m)
    return {"y": y, "x": par.ifwt_sharded(y, w, 3, m)}


@_case("w1", "w1_dtcwt", {"signal": 1})
def _w1_dtcwt(par, m):
    r = par.dtcwt_sharded(_t(_x("w1_dtcwt", 2, 256)), 2, m)
    return {"la": r.lowpass_a, "h0": r.highpass[0],
            "x": par.idtcwt_sharded(r, m)}


@_case("w1", "w1_packets", {"scale": 1})
def _w1_packets(par, m):
    w = jt.wavelet(DB4)
    x = _t(_x("w1_packets", 256))
    y = par.modwpt_sharded(x, w, 3, m)
    p = par.wpt_sharded(x, w, 3, m)
    return {"y": y, "x": par.imodwpt_sharded(y, w, m), "p": p,
            "xp": par.iwpt_sharded(p, w, 3, m)}


@_case("w1", "w1_ssq", {"scale": 1})
def _w1_ssq(par, m):
    r = par.ssq_sharded(_t(_tone()), _ssq_scales(), mesh=m,
                        sampling_rate=512.0)
    return {"Tx": r.Tx, "Wx": r.Wx}


def _np(v):
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _world(rank: int, world: str, size: int, path: str) -> None:
    """One rank: run every case of ``world``, save ``rank<r>.npz``."""
    import torch.distributed as dist

    from jwave_pro_tpu_torch import parallel as par
    from jwave_pro_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    meshes = {}
    if world == "w4":
        par.init_distributed(f"file://{path}/store", size, rank,
                             device_type="cpu", timeout=60)
        meshes = {k: par.make_mesh(v, device_type="cpu")
                  for k, v in MESHES.items()}
    out = {}
    for name, (mesh, fn) in CASES[world].items():
        if isinstance(mesh, dict):
            m = par.make_mesh(mesh, device_type="cpu")
        else:
            m = meshes.get(mesh)
        sharded.reset_collectives()
        try:
            res = fn(par, m)
            counts = [sharded.COLLECTIVES[k] for k in KINDS]
            arrays = {k: _np(v) for k, v in res.items()}
        except Exception:  # recorded, and reported by that case's test
            out[f"{name}/__error__"] = np.array(traceback.format_exc())
            continue
        out[f"{name}/__counts__"] = np.array(counts)
        out.update({f"{name}/{k}": v for k, v in arrays.items()})
    np.savez(f"{path}/rank{rank}.npz", **out)
    dist.destroy_process_group()


def _run_world(path, world: str, size: int) -> list:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_world, args=(r, world, size, str(path)))
             for r in range(size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    assert not alive and codes == [0] * size, \
        f"world {world}: exit codes {codes} (None: killed at the timeout)"
    ranks = []
    for r in range(size):
        with np.load(path / f"rank{r}.npz") as saved:
            ranks.append(dict(saved))
    return ranks


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("w4"), "w4", 4)


@pytest.fixture(scope="module")
def w1(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("w1"), "w1", 1)


def _results(ranks, name):
    """Rank 0's arrays and counts of case ``name``; fails on its error."""
    r0 = ranks[0]
    err = r0.get(f"{name}/__error__")
    assert err is None, str(err)
    pre = f"{name}/"
    out = {k[len(pre):]: v for k, v in r0.items() if k.startswith(pre)}
    counts = dict(zip(KINDS, out.pop("__counts__").tolist()))
    return out, counts


# ---------------------------------------------------------------------------
# The parent side: JAX references.
# ---------------------------------------------------------------------------

def _jw():
    import jax  # noqa: F401  (tests/conftest.py put it on the CPU in f64)
    import jwave_pro_tpu as jw
    return jw


def _jit(fn, *args):
    import jax
    return jax.jit(fn)(*args)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, f"{err:.3e} > {tol:g} relative to max|ref|"


def _ref_modwt(r, name, lvl, shape):
    jw = _jw()
    _close(r["c"], _jit(lambda v: jw.modwt(v, jw.wavelet(DB4), lvl,
                                           method="direct"),
                        _x(name, *shape)), 1e-10)


def _ref_inverse(r, fn, c):
    jw = _jw()
    _close(r["x"], _jit(lambda v: fn(jw, v), c), 1e-10)


def _ref_modwt2(r, name, lvl, shape):
    jw = _jw()
    x = _x(name, *shape)
    _close(r["c"], _jit(lambda v: jw.modwt2(v, jw.wavelet(DB4), lvl), x),
           1e-10)
    _close(r["x"], x, 1e-10)


def _ref_fwt(r):
    jw = _jw()
    for name, lvl in FWT_CASES:
        x = _x("fwt" + name, 512)
        _close(r[f"g_{name}"], _jit(lambda v: jw.fwt(v, jw.wavelet(name),
                                                     lvl), x), 1e-10)
        _close(r[f"x_{name}"], x, 1e-10)


def _ref_fwt_batched(r):
    jw = _jw()
    x = _x("fwt_batched", 4, 256)
    _close(r["g"], _jit(lambda v: jw.fwt(v, jw.wavelet(DB4), 2), x), 1e-10)
    _close(r["x"], x, 1e-10)


def _ref_dtcwt(r):
    jw = _jw()
    want = _jit(lambda v: jw.dtcwt(v, 3), _x("dtcwt", 2, 1024))
    for i, h in enumerate(want.highpass):
        _close(r[f"h{i}"], h, 1e-10)
    _close(r["la"], want.lowpass_a, 1e-10)
    _close(r["lb"], want.lowpass_b, 1e-10)


def _ref_packets(r, name, fn, shape, levels):
    jw = _jw()
    x = _x(name, *shape)
    for key, lvl in levels.items():
        _close(r[key], _jit(lambda v: fn(jw)(v, jw.wavelet(DB4), lvl), x),
               1e-10)
    if "x" in r:
        _close(r["x"], x, 1e-10)


def _ref_cwt(r, name, shape, scales, wavelet, **kw):
    jw = _jw()
    want = _jit(lambda v: jw.cwt(v, scales, getattr(jw, wavelet)(),
                                 **kw).coefficients, _x(name, *shape))
    _rel(r["c"], want, 1e-12)


def _ref_cwt_signal(r, name, shape, scales, wavelet):
    jw = _jw()
    want = _jit(lambda v: jw.cwt(v, scales, getattr(jw, wavelet)(),
                                 padding="periodic").coefficients,
                _x(name, *shape))
    _close(r["c"], want, 2e-6)


def _ref_cwt2(r):
    jw = _jw()
    img = _x("cwt2", 24, 32)
    angles = np.linspace(0, np.pi, 2, endpoint=False)
    _rel(r["c"], _jit(lambda v: jw.cwt2(v, np.linspace(2.0, 8.0, 4),
                                        jw.Morlet2D(), angles=angles
                                        ).coefficients, img), 1e-12)
    assert bool(r["real"])
    _rel(r["cr"], _jit(lambda v: jw.cwt2(v, np.linspace(1.5, 9.0, 8),
                                         jw.MexicanHat2D()).coefficients,
                       img), 1e-12)


def _ref_cwt2_angles(r):
    jw = _jw()
    angles = np.linspace(0, np.pi, 4, endpoint=False)
    _rel(r["c"], _jit(lambda v: jw.cwt2(v, [2.0, 5.0], jw.Morlet2D(),
                                        angles=angles).coefficients,
                      _x("cwt2_angles", 16, 16)), 1e-12)


def _ref_cwt2_batched(r):
    jw = _jw()
    _rel(r["c"], _jit(lambda v: jw.cwt2(v, np.linspace(2.0, 6.0, 8),
                                        jw.MexicanHat2D()).coefficients,
                      _x("cwt2_batched", 4, 16, 16)), 1e-12)


def _ssq_ref(x, **kw):
    jw = _jw()
    return _jit(lambda v: jw.ssq_cwt(v, _ssq_scales(), sampling_rate=512.0,
                                     **kw)[:3], x)


def _check_ssq(r, want):
    tx, wx = np.asarray(want[0]), np.asarray(want[1])
    assert np.abs(tx).max() > 1e-2          # not vacuous
    np.testing.assert_array_equal(r["Tx"] != 0, tx != 0)   # the bins
    _rel(r["Tx"], tx, 1e-12)
    _rel(r["Wx"], wx, 1e-12)


def _ref_ssq(r):
    want = _ssq_ref(_tone())
    _check_ssq(r, want)
    np.testing.assert_allclose(r["freqs"], want[2], rtol=1e-12)


def _ref_ssq_gamma(r):
    _check_ssq(r, _ssq_ref(_tone(), gamma=1e-4))


def _ref_ssq_batched(r):
    _check_ssq(r, _ssq_ref(_tone()[None] + 0.1 * _x("ssq_batched", 4, 512)))


def _ref_scattering(r):
    jw = _jw()
    want = _jit(lambda v: jw.scattering1d(v, j=4, q=2, oversampling=64)[:3],
                _x("scattering", 1024))
    _rel(r["s0"], want[0], 1e-12)
    _rel(r["s1"], want[1], 1e-12)
    keep = r["pairs"][:, 0] >= 0
    _rel(r["s2"][keep], want[2], 1e-12)
    assert np.all(r["s2"][~keep] == 0.0)
    js1 = importlib.import_module("jwave_pro_tpu.ops.scattering")
    i1, i2 = js1._pair_table(1024, 4, 2)
    xi2 = js1.scattering_filters(1024, 4, 2)[3]
    np.testing.assert_array_equal(r["pairs"][keep],
                                  np.stack([i1, xi2[i2]], axis=-1))


def _ref_scattering_order1(r):
    jw = _jw()
    want = _jit(lambda v: jw.scattering1d(v, j=4, q=1, order=1,
                                          oversampling=64).s1,
                _x("scattering_order1", 4, 512))
    _rel(r["s1"], want, 1e-12)
    assert bool(r["s2_none"])


def _ref_scattering2d(r):
    jw = _jw()
    want = _jit(lambda v: jw.scattering2d(v, j=2, l=4, oversampling=64)[:3],
                _x("scattering2d", 32, 32))
    _rel(r["s0"], want[0], 1e-12)
    _rel(r["s1"], want[1], 1e-12)
    keep = r["pairs"][:, 0] >= 0
    _rel(r["s2"][keep], want[2], 1e-12)
    assert np.all(r["s2"][~keep] == 0.0)
    js2 = importlib.import_module("jwave_pro_tpu.ops.scattering2d")
    np.testing.assert_array_equal(r["pairs"][keep],
                                  np.stack(js2._pair_table2d(2, 4), axis=-1))


SINGLE = {
    "modwt": lambda r: _ref_modwt(r, "modwt", 4, (3, 512)),
    "modwt_multihop": lambda r: _ref_modwt(r, "modwt_multihop", 5, (256,)),
    "modwt_2d_mesh": lambda r: _ref_modwt(r, "modwt_2d_mesh", 3, (4, 256)),
    "modwt_size1": lambda r: _ref_modwt(r, "modwt_size1", 3, (4, 128)),
    "imodwt": lambda r: _close(r["x"], _x("imodwt", 2, 512), 1e-10),
    "imodwt_2d_mesh": lambda r: _close(r["x"], _x("imodwt_2d_mesh", 2, 256),
                                       1e-10),
    "imodwt_any": lambda r: _ref_inverse(
        r, lambda jw, v: jw.imodwt(v, jw.wavelet(DB4), method="direct"),
        _x("imodwt_any", 5, 2, 512)),
    "imodwt2_any": lambda r: _ref_inverse(
        r, lambda jw, v: jw.imodwt2(v, jw.wavelet(DB4)),
        _x("imodwt2_any", 10, 64, 48)),
    "iwpt_any": lambda r: _ref_inverse(
        r, lambda jw, v: jw.iwpt(v, jw.wavelet(DB4), 5),
        _x("iwpt_any", 2, 1024)),
    "imodwpt_any": lambda r: _ref_inverse(
        r, lambda jw, v: jw.imodwpt(v, jw.wavelet(DB4)),
        _x("imodwpt_any", 16, 128)),
    "modwt2": lambda r: _ref_modwt2(r, "modwt2", 3, (64, 48)),
    "modwt2_batched": lambda r: _ref_modwt2(r, "modwt2_batched", 2,
                                            (2, 32, 16)),
    "fwt": _ref_fwt,
    "fwt_batched": _ref_fwt_batched,
    "fwt2": lambda r: _close(r["y"], _jit(
        lambda v: _jw().fwt2(v, _jw().wavelet(DB4)), _x("fwt2", 16, 32)),
        1e-10),
    "dtcwt": _ref_dtcwt,
    "idtcwt": lambda r: _close(r["x"], _x("idtcwt", 2, 512), 1e-10),
    "wpt": lambda r: _ref_packets(r, "wpt", lambda jw: jw.wpt, (1024,),
                                  {"y": 5}),
    "iwpt": lambda r: _close(r["x"], _x("iwpt", 1024), 1e-10),
    "wpt_shallow": lambda r: _ref_packets(r, "wpt_shallow",
                                          lambda jw: jw.wpt, (2, 512),
                                          {"y": 1}),
    "wpt_batched": lambda r: _ref_packets(r, "wpt_batched",
                                          lambda jw: jw.wpt, (4, 512),
                                          {"y": 2}),
    "modwpt": lambda r: _ref_packets(r, "modwpt", lambda jw: jw.modwpt,
                                     (96,), {"y2": 2, "y4": 4}),
    "imodwpt": lambda r: _close(r["x"], _x("imodwpt", 128), 1e-10),
    "modwpt_batched": lambda r: _ref_packets(r, "modwpt_batched",
                                             lambda jw: jw.modwpt, (4, 64),
                                             {"y": 2}),
    "cwt": lambda r: _ref_cwt(r, "cwt", (256,),
                              jt.generate_log_scales(1.0, 32.0, 16),
                              "MorletWavelet"),
    "cwt_batched": lambda r: _ref_cwt(r, "cwt_batched", (4, 256),
                                      jt.generate_log_scales(1.0, 16.0, 8),
                                      "MexicanHatWavelet"),
    "cwt_signal": lambda r: _ref_cwt_signal(
        r, "cwt_signal", (4096,), jt.generate_log_scales(5.0, 16.0, 8),
        "MorletWavelet"),
    "cwt_signal_multihop": lambda r: _ref_cwt_signal(
        r, "cwt_signal_multihop", (2048,),
        jt.generate_log_scales(8.0, 96.0, 4), "MorletWavelet"),
    "cwt_signal_batched": lambda r: _ref_cwt_signal(
        r, "cwt_signal_batched", (2, 2048),
        jt.generate_log_scales(2.0, 8.0, 6), "MexicanHatWavelet"),
    "cwt2": _ref_cwt2,
    "cwt2_angles": _ref_cwt2_angles,
    "cwt2_batched": _ref_cwt2_batched,
    "ssq": _ref_ssq,
    "ssq_gamma": _ref_ssq_gamma,
    "ssq_batched": _ref_ssq_batched,
    "scattering": _ref_scattering,
    "scattering_order1": _ref_scattering_order1,
    "scattering2d": _ref_scattering2d,
}


def test_every_case_has_a_reference():
    tested = set(SINGLE) | {"grad_modwt", "grad_imodwt", "grad_fwt",
                            "errors_signal", "errors_scale", "alias_off",
                            "dryrun"}
    assert set(CASES["w4"]) == tested


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_sharded_matches_jax_single_device(w4, name):
    SINGLE[name](_results(w4, name)[0])


def test_every_rank_gathers_the_same_result(w4):
    for rank in w4[1:]:
        assert rank.keys() == w4[0].keys()
        for k, v in rank.items():
            if not k.endswith("__counts__"):
                np.testing.assert_array_equal(v, w4[0][k], err_msg=k)


def _hops(halos, shard):
    return sum(-(-h // shard) for h in halos)


# the collectives each case posts on rank 0: the HLO pins of
# tests/test_parallel.py (no collective in the packet, scale and path
# forwards; one all-gather in each packet inverse; one SUM in
# ssq_sharded(gamma=…), one more MAX with the default γ; only ring hops in
# the MODWT and overlap-save paths), in counts.  The port's MODWT forward
# fetches its whole halo, (M − 1)(2^L − 1) samples, at once, where the JAX
# body fetches one level's at a time
NONE = {}
PINS = {
    "modwt": {"hop": _hops([7 * 15], 128)},
    "modwt_multihop": {"hop": _hops([7 * 31], 64)},
    "modwt_2d_mesh": {"hop": _hops([7 * 7], 128)},
    "modwt_size1": NONE,
    "imodwt": {"hop": _hops([7, 14, 28, 56], 128)},
    "imodwt_any": {"hop": _hops([7, 14, 28, 56], 128)},
    "imodwt2_any": {"hop": _hops([7, 14, 28], 16)},
    "iwpt_any": {"all_gather": 1}, "imodwpt_any": {"all_gather": 1},
    "modwt2": {"hop": 2 * _hops([7, 14, 28], 16)},
    "wpt": NONE, "wpt_shallow": {"all_gather": 1}, "iwpt": {"all_gather": 1},
    "modwpt": NONE, "imodwpt": {"all_gather": 1},
    "cwt": NONE, "cwt_batched": NONE, "cwt2": NONE, "cwt2_angles": NONE,
    "cwt2_batched": NONE,
    "cwt_signal": {"hop": 2}, "cwt_signal_multihop": {"hop": 4},
    "ssq": {"all_reduce_sum": 1, "all_reduce_max": 1},
    "ssq_gamma": {"all_reduce_sum": 1},
    "scattering": NONE, "scattering_order1": NONE, "scattering2d": NONE,
    "fwt2": {"all_to_all": 2},
}


@pytest.mark.parametrize("name", sorted(PINS))
def test_collectives_posted(w4, name):
    _, counts = _results(w4, name)
    want = dict.fromkeys(KINDS, 0)
    want.update(PINS[name])
    assert counts == want


def test_ring_paths_post_only_hops(w4):
    for name in ("fwt", "fwt_batched", "dtcwt", "idtcwt", "modwt2_batched",
                 "cwt_signal_batched", "imodwt_2d_mesh"):
        counts = _results(w4, name)[1]
        assert counts["hop"] > 0, name
        assert sum(counts.values()) == counts["hop"], (name, counts)


def _jax_mesh(shape):
    import jax

    from jwave_pro_tpu.parallel import make_mesh
    return make_mesh(shape, devices=jax.devices()[:4])


def test_fwt_per_shard_layout_matches_jax_sharded(w4):
    from jwave_pro_tpu.parallel import sharded as js

    jw = _jw()
    r, _ = _results(w4, "fwt")
    mesh = _jax_mesh({"signal": 4})
    for name, lvl in FWT_CASES:
        w = jw.wavelet(name)
        y = _jit(lambda v: js.fwt_sharded(v, w, lvl, mesh),
                 _x("fwt" + name, 512))
        _close(r[f"y_{name}"], y, 1e-10)
        _close(r[f"g_{name}"], js.gather_fwt_layout(y, lvl, 4), 1e-10)


def test_cwt_signal_matches_jax_sharded(w4):
    from jwave_pro_tpu.parallel import sharded as js

    jw = _jw()
    for name, shape, scales in (
            ("cwt_signal", (4096,), jt.generate_log_scales(5.0, 16.0, 8)),
            ("cwt_signal_multihop", (2048,),
             jt.generate_log_scales(8.0, 96.0, 4))):
        mesh = _jax_mesh({"signal": 4})
        want = _jit(lambda v: js.cwt_signal_sharded(
            v, scales, jw.MorletWavelet(), mesh).coefficients,
            _x(name, *shape))
        _rel(_results(w4, name)[0]["c"], want, 1e-12)
    # the aliasing gate: the same refusal, and the same output without it
    with pytest.raises(ValueError, match="Nyquist-aliased") as jerr:
        js.cwt_signal_sharded(_x("e", 1024), [1.0, 8.0], jw.MorletWavelet(),
                              _jax_mesh({"signal": 4}))
    errs = _results(w4, "errors_signal")[0]
    assert str(errs["cwt_signal_aliasing"]) == str(jerr.value)
    want = _jit(lambda v: js.cwt_signal_sharded(
        v, [1.0, 8.0], jw.MorletWavelet(), _jax_mesh({"signal": 4}),
        check_aliasing=False).coefficients, _x("alias_off", 1024))
    _rel(_results(w4, "alias_off")[0]["c"], want, 1e-12)


@pytest.mark.parametrize("name,gamma", [("ssq", None), ("ssq_gamma", 1e-4)])
def test_ssq_matches_jax_sharded(w4, name, gamma):
    from jwave_pro_tpu.parallel import sharded as js

    mesh = _jax_mesh({"scale": 4})
    want = _jit(lambda v: js.ssq_sharded(v, _ssq_scales(), mesh=mesh,
                                         sampling_rate=512.0,
                                         gamma=gamma)[:2], _tone())
    _check_ssq(_results(w4, name)[0], want)


def test_scattering_padded_layout_matches_jax_sharded(w4):
    from jwave_pro_tpu.parallel import sharded as js

    r, _ = _results(w4, "scattering")
    want = js.scattering_sharded(_x("scattering", 1024), j=4, q=2,
                                 mesh=_jax_mesh({"scale": 4}))
    np.testing.assert_array_equal(r["pairs"], want.pairs)
    _rel(r["s2"], want.s2, 1e-12)
    _rel(r["s1"], want.s1, 1e-12)


@pytest.mark.slow
def test_the_other_transforms_match_jax_sharded(w4):
    """The 15 sharded functions whose output is the single-device one,
    against the JAX package's sharded functions themselves."""
    from jwave_pro_tpu.parallel import sharded as js

    jw = _jw()
    w = jw.wavelet(DB4)
    sig, sca = _jax_mesh({"signal": 4}), _jax_mesh({"scale": 4})
    ds, dsc = (_jax_mesh({"data": 2, "signal": 2}),
               _jax_mesh({"data": 2, "scale": 2}))
    get = {n: _results(w4, n)[0] for n in CASES["w4"]}
    _close(get["modwt"]["c"], js.modwt_sharded(_x("modwt", 3, 512), w, 4,
                                               sig), 1e-10)
    c = js.modwt_sharded(_x("imodwt_2d_mesh", 2, 256), w, 3, ds)
    _close(get["imodwt_2d_mesh"]["x"], js.imodwt_sharded(c, w, ds), 1e-10)
    c2 = js.modwt2_sharded(_x("modwt2", 64, 48), w, 3, sig)
    _close(get["modwt2"]["c"], c2, 1e-10)
    _close(get["modwt2"]["x"], js.imodwt2_sharded(c2, w, sig), 1e-10)
    y = js.fwt_sharded(_x("fwt_batched", 4, 256), w, 2, ds)
    _close(get["fwt_batched"]["x"], js.ifwt_sharded(y, w, 2, ds), 1e-10)
    _close(get["fwt2"]["y"], js.fwt2_sharded(
        _x("fwt2", 16, 32), w, _jax_mesh({"data": 4})), 1e-10)
    d = js.dtcwt_sharded(_x("dtcwt", 2, 1024), 3, sig)
    _close(get["dtcwt"]["la"], d.lowpass_a, 1e-10)
    r = js.dtcwt_sharded(_x("idtcwt", 2, 512), 2, ds)
    _close(get["idtcwt"]["x"], js.idtcwt_sharded(r, ds), 1e-10)
    p = js.wpt_sharded(_x("wpt_batched", 4, 512), w, 2, dsc)
    _close(get["wpt_batched"]["y"], p, 1e-10)
    _close(get["wpt_batched"]["x"], js.iwpt_sharded(p, w, 2, dsc), 1e-10)
    q = js.modwpt_sharded(_x("modwpt_batched", 4, 64), w, 2, dsc)
    _close(get["modwpt_batched"]["y"], q, 1e-10)
    _close(get["modwpt_batched"]["x"], js.imodwpt_sharded(q, w, dsc), 1e-10)
    _rel(get["cwt"]["c"], js.cwt_sharded(
        _x("cwt", 256), jw.generate_log_scales(1.0, 32.0, 16),
        jw.MorletWavelet(), sca).coefficients, 1e-12)
    _rel(get["cwt2_batched"]["c"], js.cwt2_sharded(
        _x("cwt2_batched", 4, 16, 16), np.linspace(2.0, 6.0, 8),
        jw.MexicanHat2D(), dsc).coefficients, 1e-12)
    s2 = js.scattering2d_sharded(_x("scattering2d", 32, 32), j=2, l=4,
                                 mesh=sca)
    np.testing.assert_array_equal(get["scattering2d"]["pairs"], s2.pairs)
    _rel(get["scattering2d"]["s2"], s2.s2, 1e-12)


def _jax_grad(fn, x, cot):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(fn(v) * cot)))(x))


@pytest.mark.parametrize("name", ["grad_modwt", "grad_imodwt", "grad_fwt"])
def test_gradients_through_the_ring_match_jax(w4, name):
    jw = _jw()
    w = jw.wavelet(DB4)
    fn, shape, cot = {
        "grad_modwt": (lambda v: jw.modwt(v, w, 3, method="direct"),
                       (2, 256), (4, 2, 256)),
        "grad_imodwt": (lambda v: jw.imodwt(v, w, method="direct"),
                        (4, 2, 256), (2, 256)),
        "grad_fwt": (lambda v: jw.fwt(v, w, 3), (2, 512), (2, 512)),
    }[name]
    want = _jax_grad(fn, _x(name, *shape), _x(name + "_cot", *cot))
    _rel(_results(w4, name)[0]["grad"], want, 1e-9)


def test_validation_errors(w4):
    """``tests/test_parallel.py``'s validation cases, raised before any
    collective, with the JAX package's messages."""
    sig = _results(w4, "errors_signal")[0]
    sca = _results(w4, "errors_scale")[0]
    want = {
        "modwt2_depth": "theoretical limit", "dtcwt_divisible":
        "not divisible", "cwt_signal_divisible": "not divisible",
        "cwt_signal_aliasing": "Nyquist-aliased", "modwt_halo":
        "theoretical limit|halo", "fwt_divisible": "not divisible",
        "ssq_bins": "frequency bins", "ssq_uniform": "log-uniform",
        "cwt_scales": "not divisible", "cwt2_planes": "not divisible",
        "scattering_paths": "not divisible", "modwpt_level": "log2",
    }
    import re

    for key, pattern in want.items():
        msg = str({**sig, **sca}[key])
        assert re.search(pattern, msg), (key, msg)


def test_entry_points_without_a_mesh_raise():
    from jwave_pro_tpu_torch.parallel import (
        cwt2_sharded, scattering2d_sharded, scattering_sharded, ssq_sharded)

    x = torch.from_numpy(_x("e", 256))
    for fn in (lambda: scattering_sharded(x, j=2, q=4),
               lambda: ssq_sharded(x, [1.0, 2.0, 4.0, 8.0]),
               lambda: scattering2d_sharded(torch.zeros(16, 16), j=2, l=4)):
        with pytest.raises(ValueError, match="requires a mesh"):
            fn()
    with pytest.raises(ValueError, match="explicit Mesh"):
        cwt2_sharded(torch.zeros(8, 8), [1.0])


@pytest.mark.parametrize("key", ["rec", "cw", "wp", "mp", "fw", "dt", "cl",
                                 "sc", "sq", "rec2"])
def test_graft_dryrun_step_through_the_port(w4, key):
    """``__graft_entry__.dryrun_multichip(4)``'s step ({"data": 2,
    "signal": 2}, float32) through the port's tier: finite, and each
    output as the port's single-device calls give it."""
    r, _ = _results(w4, "dryrun")
    got, want = r[f"got_{key}"], r[f"want_{key}"]
    assert np.all(np.isfinite(got))
    _rel(got, want, 1e-4 if key in ("cl", "sq") else 1e-5)


def test_world_of_one_rank(w1):
    jw = _jw()
    w = jw.wavelet(DB4)
    msg = str(_results(w1, "w1_no_group")[0]["msg"])
    assert "init_distributed" in msg
    r, _ = _results(w1, "w1_mesh")
    assert r["names"].tolist() == ["data"] and r["sizes"].tolist() == [1]
    assert "needs 2 devices, have 1" in str(r["msg"])
    for name in ("w1_modwt", "w1_cwt_signal", "w1_fwt", "w1_dtcwt",
                 "w1_packets", "w1_ssq"):
        # a one-rank axis posts nothing: every hop and gather is local
        assert _results(w1, name)[1] == dict.fromkeys(KINDS, 0), name
    r = _results(w1, "w1_modwt")[0]
    x = _x("w1_modwt", 2, 64)
    _close(r["c"], _jit(lambda v: jw.modwt(v, w, 3, method="direct"), x),
           1e-10)
    _close(r["x"], x, 1e-10)
    r = _results(w1, "w1_cwt_signal")[0]
    _close(r["c"], _jit(lambda v: jw.cwt(
        v, jw.generate_log_scales(5.0, 16.0, 4), jw.MorletWavelet(),
        padding="periodic").coefficients, _x("w1_cwt_signal", 512)), 2e-6)
    r = _results(w1, "w1_fwt")[0]
    x = _x("w1_fwt", 256)
    _close(r["y"], _jit(lambda v: jw.fwt(v, w, 3), x), 1e-10)
    _close(r["x"], x, 1e-10)
    r = _results(w1, "w1_dtcwt")[0]
    x = _x("w1_dtcwt", 2, 256)
    want = _jit(lambda v: jw.dtcwt(v, 2), x)
    _close(r["la"], want.lowpass_a, 1e-10)
    _close(r["h0"], want.highpass[0], 1e-10)
    _close(r["x"], x, 1e-10)
    r = _results(w1, "w1_packets")[0]
    x = _x("w1_packets", 256)
    _close(r["y"], _jit(lambda v: jw.modwpt(v, w, 3), x), 1e-10)
    _close(r["p"], _jit(lambda v: jw.wpt(v, w, 3), x), 1e-10)
    _close(r["x"], x, 1e-10)
    _close(r["xp"], x, 1e-10)
    _check_ssq(_results(w1, "w1_ssq")[0], _ssq_ref(_tone()))


def test_collective_layer_module_imports_no_jax():
    mod = importlib.import_module("jwave_pro_tpu_torch.parallel.sharded")
    assert set(mod.COLLECTIVES) == set(KINDS)
