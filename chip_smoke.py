#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``jwave_pro_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``jwave_pro_tpu_torch/csrc`` with nvcc,
checks each kernel against its plain PyTorch version, drives the main path
(MODWT Db4 level 5 forward, inverse and fused denoise over 32 signals of
2^20 float32 samples, and the 1D forward at N = 2^24) through the public
API, shows from the kernels' launch counters that the path ran through
them, and times kernel against plain version with CUDA events.  Every
check prints a line; any failure exits non-zero.  The second-to-last line
is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

WAVELET = "Daubechies 4"
LEVEL = 5
MAIN_SHAPE = (32, 1 << 20)   # bench.py's north-star shape
MAIN_1D = 1 << 24            # the 1D (N,) contract at full size
SEED = 0


class Smoke:
    """Collects check results; a failed check fails the run at the end."""

    def __init__(self):
        self.ok = True

    def check(self, name: str, err: float, tol: float) -> float:
        good = math.isfinite(err) and err <= tol
        self.ok &= good
        print(f"  [{'OK ' if good else 'FAIL'}] {name}: max-abs-err "
              f"{err:.3e} (tol {tol:g})", flush=True)
        return err

    def require(self, name: str, cond: bool, detail: str = "") -> None:
        self.ok &= bool(cond)
        print(f"  [{'OK ' if cond else 'FAIL'}] {name} {detail}", flush=True)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(smoke: Smoke, torch, jt) -> dict:
    from jwave_pro_tpu_torch.kernels import _build
    from jwave_pro_tpu_torch.kernels import denoise_cuda as kd
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    w = jt.wavelet(WAVELET)
    # plain references state their matmul/conv precision (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def signal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    print("== phase 1: device", flush=True)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    cached = (_build.build_dir() / "libjwave_kernels.so").exists()
    _build.library()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s "
          f"({'already built' if cached else 'nvcc'}) -> {_build.build_dir()}",
          flush=True)

    print("== phase 3: forward kernel vs plain (f32)", flush=True)
    small = {}
    for shape in ((16, 8192), (32, 100003)):
        x = signal(*shape)
        got = kc.modwt_fwd_cuda(x, w, LEVEL)
        want = kc.modwt_fwd_plain(x, w, LEVEL)
        smoke.check(f"fwd {shape} L{LEVEL}", max_err(got, want), 1e-5)
        small[shape] = (x, got)
    # reference on a small input: the f64 direct path on the host
    xs = signal(4, 1000)
    ref = jt.modwt(xs.double().cpu(), w, 3, method="direct")
    smoke.check("fwd (4, 1000) L3 vs f64 host direct path",
                max_err(kc.modwt_fwd_cuda(xs, w, 3).cpu(), ref), 1e-5)

    print("== phase 4: inverse kernel and round trip (f32)", flush=True)
    for shape, (x, c) in small.items():
        smoke.check(f"inv {shape} vs plain",
                    max_err(kc.modwt_inv_cuda(c, w), kc.modwt_inv_plain(c, w)),
                    1e-4)
        smoke.check(f"round trip {shape}",
                    max_err(kc.modwt_inv_cuda(c, w), x), 1e-4)
    x1 = signal(1_000_000)
    c1 = kc.modwt_fused(x1, w, LEVEL)
    smoke.require("1D contract shape", tuple(c1.shape) == (LEVEL + 1,
                                                         1_000_000))
    smoke.check("1D fwd N=1e6 vs plain",
                max_err(c1, kc.modwt_fwd_plain(x1, w, LEVEL)), 1e-5)
    smoke.check("1D round trip N=1e6", max_err(kc.imodwt_fused(c1, w), x1),
                1e-4)

    print("== phase 5: bfloat16 I/O (f32 compute)", flush=True)
    x, c32 = small[(16, 8192)]
    c16 = kc.modwt_fwd_cuda(x.bfloat16(), w, LEVEL)
    smoke.require("bf16 fwd dtype", c16.dtype == torch.bfloat16)
    smoke.check("bf16 fwd vs f32 fwd", max_err(c16, c32), 5e-2)
    smoke.check("bf16 fwd vs bf16 plain",
                max_err(c16, kc.modwt_fwd_plain(x.bfloat16(), w, LEVEL)),
                5e-2)
    smoke.check("bf16 round trip", max_err(kc.modwt_inv_cuda(c16, w), x),
                1e-1)
    smoke.check("bf16 inv vs bf16 plain",
                max_err(kc.modwt_inv_cuda(c16, w), kc.modwt_inv_plain(c16, w)),
                5e-2)

    print("== phase 6: fused denoise vs plain pipeline", flush=True)
    for shape, lvl in (((16, 8192), 4), ((16, 100003), 5)):
        x = signal(*shape)
        thr = torch.full((shape[0],), 0.8, device=dev)
        got = kd.modwt_denoise_cuda(x, thr, w, lvl)
        want = jt.modwt_denoise(x, w, lvl, method="direct", threshold=0.8)
        smoke.check(f"denoise {shape} L{lvl} vs pipeline",
                    max_err(got, want), 1e-5)
        smoke.check(f"denoise {shape} L{lvl} vs plain version",
                    max_err(got, kd.modwt_denoise_plain(x, thr, w, lvl)), 1e-5)
    hard = kd.modwt_denoise_cuda(x, thr, w, lvl, mode="hard")
    smoke.check("denoise hard vs plain version",
                max_err(hard, kd.modwt_denoise_plain(x, thr, w, lvl, "hard")),
                1e-5)
    x = small[(16, 8192)][0]
    thr = torch.full((16,), 0.8, device=dev)
    smoke.check("bf16 denoise vs f32 denoise",
                max_err(kd.modwt_denoise_cuda(x.bfloat16(), thr, w, 4),
                        kd.modwt_denoise_cuda(x, thr, w, 4)), 1e-1)

    print("== phase 7: gradients through the autograd pair", flush=True)
    x = signal(8, 4096)
    wts = signal(4, 8, 4096)
    xk = x.clone().requires_grad_()
    (kc.modwt_fused(xk, w, 3) * wts).sum().backward()
    xp = x.clone().requires_grad_()
    (jt.modwt(xp, w, 3, method="direct") * wts).sum().backward()
    smoke.check("grad of modwt_fused vs plain autograd",
                max_err(xk.grad, xp.grad), 1e-4)
    ck = wts.clone().requires_grad_()
    (kc.imodwt_fused(ck, w) * x).sum().backward()
    cp = wts.clone().requires_grad_()
    (jt.imodwt(cp, w, method="direct") * x).sum().backward()
    smoke.check("grad of imodwt_fused vs plain autograd",
                max_err(ck.grad, cp.grad), 1e-4)

    print(f"== phase 8: main path {MAIN_SHAPE} f32 {WAVELET} L{LEVEL}, "
          f"and 1D N={MAIN_1D}, through the public API", flush=True)
    x = signal(*MAIN_SHAPE)
    x1 = signal(MAIN_1D)
    counters = (kc.modwt_fwd_cuda, kc.modwt_inv_cuda, kd.modwt_denoise_cuda)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    c = jt.modwt(x, w, LEVEL)
    xr = jt.imodwt(c, w)
    den = jt.modwt_denoise(x, w, LEVEL, method="fused")
    fwd_batched = kc.modwt_fwd_cuda.launches
    c1 = jt.modwt(x1, w, LEVEL)
    torch.cuda.synchronize()
    launches = {
        "modwt_fwd": fwd_batched,
        "modwt_fwd_1d": kc.modwt_fwd_cuda.launches - fwd_batched,
        "modwt_inv": kc.modwt_inv_cuda.launches,
        "modwt_denoise": kd.modwt_denoise_cuda.launches,
    }
    print(f"  launches on the main path: {launches}", flush=True)
    for name, count in launches.items():
        smoke.require(f"{name} kernel launched", count >= 1, f"({count})")
    for name, t, shape in (("coeffs", c, (LEVEL + 1,) + MAIN_SHAPE),
                           ("reconstruction", xr, MAIN_SHAPE),
                           ("denoised", den, MAIN_SHAPE),
                           ("1D coeffs", c1, (LEVEL + 1, MAIN_1D))):
        smoke.require(f"{name} shape {shape} and finite",
                      tuple(t.shape) == shape
                      and bool(torch.isfinite(t).all()))
    smoke.check("main-path round trip", max_err(xr, x), 1e-4)

    # each kernel against its plain version at the main path's shapes
    # (these launches are not counted above)
    thr = jt.universal_threshold(c[0], MAIN_SHAPE[1]).float().contiguous()
    errs = {
        "modwt_fwd": smoke.check("fwd vs plain at main shape", max_err(
            kc.modwt_fwd_cuda(x, w, LEVEL), kc.modwt_fwd_plain(x, w, LEVEL)),
            1e-5),
        "modwt_fwd_1d": smoke.check("1D fwd vs plain at N=2^24", max_err(
            kc.modwt_fused(x1, w, LEVEL), kc.modwt_fwd_plain(x1, w, LEVEL)),
            1e-5),
        "modwt_inv": smoke.check("inv vs plain at main shape", max_err(
            kc.modwt_inv_cuda(c, w), kc.modwt_inv_plain(c, w)), 1e-4),
        "modwt_denoise": smoke.check("denoise vs plain at main shape",
                                     max_err(kd.modwt_denoise_cuda(
                                         x, thr, w, LEVEL),
                                         kd.modwt_denoise_plain(
                                             x, thr, w, LEVEL)), 1e-5),
    }

    print(f"== phase 9: times (CUDA events, median) on {card}", flush=True)
    x1r = x1.reshape(1, -1)
    pairs = {
        "modwt_fwd": (x, lambda v: kc.modwt_fwd_cuda(v, w, LEVEL),
                      lambda v: kc.modwt_fwd_plain(v, w, LEVEL)),
        "modwt_fwd_1d": (x1r, lambda v: kc.modwt_fwd_cuda(v, w, LEVEL),
                         lambda v: kc.modwt_fwd_plain(v, w, LEVEL)),
        "modwt_inv": (c, lambda v: kc.modwt_inv_cuda(v, w),
                      lambda v: kc.modwt_inv_plain(v, w)),
        "modwt_denoise": (x, lambda v: kd.modwt_denoise_cuda(v, thr, w, LEVEL),
                          lambda v: kd.modwt_denoise_plain(v, thr, w, LEVEL)),
    }
    times = {}
    for name, (arg, kern, plain) in pairs.items():
        samples = arg.shape[-1] * (arg.shape[-2] if arg.ndim > 1 else 1)
        # plain, kernel, kernel, plain: the two orders cancel drift
        tp1 = jt.time_chain(plain, arg, k=3, repeats=3)
        tk1 = jt.time_chain(kern, arg, k=10, repeats=5)
        tk2 = jt.time_chain(kern, arg, k=10, repeats=5)
        tp2 = jt.time_chain(plain, arg, k=3, repeats=3)
        tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
        times[name] = (tk * 1e3, tp * 1e3)
        print(f"  {name} {tuple(arg.shape)}: kernel {tk * 1e3:.4f} ms "
              f"({samples / tk:.4e} samples/s), plain {tp * 1e3:.4f} ms "
              f"({samples / tp:.4e} samples/s) [{card}]", flush=True)

    src = "jwave_pro_tpu_torch/csrc/"
    tpu = "jwave_pro_tpu/kernels/"
    meta = {
        "modwt_fwd": ("modwt.cu", "modwt_pallas.py:204"),
        "modwt_fwd_1d": ("modwt.cu", "modwt_pallas.py:286"),
        "modwt_inv": ("modwt.cu", "modwt_pallas.py:564"),
        "modwt_denoise": ("denoise.cu", "denoise_pallas.py:68"),
    }
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src + meta[name][0],
         "replaces": tpu + meta[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in meta]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import jwave_pro_tpu_torch as jt

    smoke = Smoke()
    try:
        kernels = run(smoke, torch, jt)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAIL (exception)", flush=True)
        return 1
    if not smoke.ok:
        print("chip_smoke: FAIL (a check failed)", flush=True)
        return 1
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
