#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``jwave_pro_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``jwave_pro_tpu_torch/csrc`` with nvcc
(and requires the assembler to report no stack frame and no spills for
the register-resident CWT kernel, the marching 3D and 2D kernels and the
1D register-chain kernels: variance, select, forward, inverse, denoise),
checks each kernel against its plain PyTorch version, and drives two paths
through the public API: the MODWT path (Db4 level 5 forward, inverse,
fused denoise and MRA over 32 signals of 2^20 float32 samples, and the
1D forward at N = 2^24), and the statistics and packet-tree path
(wavelet variance, Hurst exponent and correlation at 32 × 2^20, the
packet tree and its inverse at 32 × 2^18 level 3, greedy and orthogonal
matching pursuit at 8 × 65536 level 3 with 16 atoms), and the 2D image
path (forward, inverse, fused and pipeline denoise of sixteen 2048 × 2048
float32 frames at Db4 level 3, the quad-tree packets at level 2, the 2D
MRA at 2 × 512 × 512), the 3D volume path (forward, inverse and denoise of four
256³ float32 volumes at Db4 level 2, the oct-tree packets of one, the 3D
MRA at 2 × 64³), and the CWT (the fused multiply + inverse FFT over
64 × 16384 samples at 64 log scales, Morlet and Mexican Hat), and the
decimated path at bench.py's shapes (fwt/ifwt and wavedec/waverec Db4 at
32 × 2^20, fwt2 at 16 × 1024², fwt3 at 4 × 128³, the packet tree Symlet 8
level 6 at 64 × 65536 and its best-basis denoise at 8 × 65536; cuBLAS
matmuls, no kernel of this package), and the decimated satellites and the
first continuous slice at bench.py's shapes (the CDF 9/7 and 5/3 lifting
pyramids, the compressors, AED and SWT, the dual-tree transform in 1D at
32 × 2^20 and in 2D at 16 × 1024² with its denoisers, FFT and DFT, the
banded CWT under its three precision tiers beside the irfft path, the
direct and inverse CWT, the Hilbert tools and the wavelet coherence;
cuBLAS, cuFFT and elementwise torch, no kernel of this package), each
held to the port's CPU float64 result and put beside the bound of its
products and FFTs; the decimated gradients with the process set to
TF32, held to the CPU float64 gradient; the second continuous slice
(phases 27 and 29: synchrosqueezing at 4 × 4096 and 64 × 16384 with its
inverse, every bin held to the f64 one within its float32 error bound,
each differing decision required to lie at a half-integer bin or the
threshold within that bound, Σ_bins Tx held to the weighted scale sum, the
ridge DP against the CPU run on the card's own Tx, the 2D CWT on sixteen
512² images (Mexican Hat) and four (Morlet, 6 scales × 8 angles) with
its inverse, 1D and 2D scattering at bench.py's shapes, the EWT at
32 × 2^20 with its inverse; cuFFT and elementwise torch, no kernel of
this package); and streaming (phases 28 and 29: the causal tail at
64 × 4313, a stream of sixteen 4096-sample chunks through a 16384-sample
buffer held to the MODWT of the whole signal, the full recompute,
modwt_chunked over 64 × 2^20, the variance tracker, each windowed
transform, a save/load round trip), which runs the batched forward (#1)
and the flat forward (#2); phase 29 gives every call's wall beside its
bound and times both synchrosqueezing front ends and the ridge loop; the
financial chain (phase 30: ``preprocess_prices`` over 64 × 65536 float32
prices with 1% gaps, each stage held to the CPU float64 run within its
float32 error units, the clip decisions counted, ``median_select``
exactly the CPU's, and its output through ``modwt`` (#1) and
``modwt_variance`` (#5)); the transform facades (phase 31: every
``build_transform`` engine's round trip at 32 × 2^20, the MODWT engine's
#1 and #3 launches, the console demo in a subprocess); and export and
serving (phase 32: the denoise on #1 and #3, the fused denoise on #4 and
the variance on #5, exported batch-polymorphic to bytes and served at
three batch sizes from one artifact, each call's launches counted and
its output bitwise the eager call's; an exported ``fwt`` served under
TF32 held to the IEEE bound; the kernel operators' host time a launch);
and the sharded tier (phase 33: ``jwave_pro_tpu_torch.parallel`` over a
one-rank NCCL world, all 19 sharded transforms at bench.py's shapes, each
gathered result held to the port's single-device call, the collectives
each posts and its wall beside the single-device wall); and the north
star as ``bench.py`` defines it (phase 34: the chained Db4 L5 forward
step at 32 × 2^20 and the round trip at 8 × 2^20 through
``utils.profiling.measure_samples_per_sec``, each kernel's launches
counted, then a ``utils.profiling.trace`` of three chained steps that
must name the forward kernel, and a steady trace of 24 chained steps read
back for its top kernels and the device's busy share); and the
threshold's median kernel (#15, phase 35: bitwise against its plain
version and the sort path, timed at 16 × 2^20 and 16 × 2·10^6 beside its
one-read bound and the sort-median, and the walls of the fused denoise at
32 × 2^20 and the 2D denoise at 16 × 2048² with the kernel and with the
sort path in its place); and the forward's context variant (phase 36:
against its plain model at the forward's edges, bitwise the forward with
the row's own end as the context, one launch at the sharded cell's
(8, 2^27) shard held to the float64 segment reference past 2^31 outputs,
timed beside the forward and its bound); and the inverse that shrinks
the denoise's detail rows as it loads them (phase 37: bitwise the shrink
and ``imodwt`` it replaces at the inverse's edges, f32 and bf16, soft and
hard, under every threshold shape the denoise passes it; one launch in a
default ``modwt_denoise``, bitwise the pipeline it replaces; at the
denoise cell's p95 request and at the north star's shape bitwise that
pipeline and within the inverse's bound of its plain model, timed beside
the inverse, the shrink and the ``cat`` it replaces and its bound); and
the 2D inverse that shrinks the 2D denoise's detail bands as it loads
them (phase 38: bitwise the shrink and ``imodwt2`` it replaces at the 2D
inverse's edges, f32 and bf16, soft and hard, for a number, a threshold
an image and one a band and image; one launch in a default
``modwt2_denoise`` at the 2D cell's (16, 2048²), bitwise the pipeline it
replaces; at the cell's (10, 16, 2048²) coefficients bitwise that
pipeline and within the 2D inverse's bound of its plain model, timed
beside the 2D inverse, the shrink and the ``cat`` it replaces and its
bound); and the packet denoise cell's call (phase 39: ``wpt_denoise`` of
1024 × 65536 Symlet 8 L6 signals with a basis a row, 36 IEEE float32
products and one launch a call, no host synchronisation, its five spans,
eight rows held to the float64 reference under the cell's check, the
float32 tree and costs against the check's error model, its time and
peak).  The kernels' launch counters, set to 0
before each path and read after it, show that the path ran through them;
CUDA events time each kernel against its plain version (``event_time``:
the median time of one call on a fixed input).  Every check
prints a line; any failure exits non-zero.  The second-to-last line
is a JSON object describing each kernel — its launches on the main path,
error against its plain version, time, the plain version's time, its
bound (the larger of its bytes over 3.35 TB/s and its float32 operations
over 67 TFLOP/s, the H100's published peaks) and, where one PyTorch call
computes the same function, that call's time; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import json
import math
import statistics
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
# the statistics and packet-tree path (bench.py:339, :118, :145)
PACKET_SHAPE, PACKET_LEVEL = (32, 1 << 18), 3
MP_SHAPE, MP_LEVEL, MP_ATOMS = (8, 65536), 3, 16
# the 2D image path: sixteen 4-megapixel frames (bench.py:417-443's Db4 L3
# transforms at full frame size), bench.py's own (8, 512, 512) shape, the
# quad-tree packets (bench.py:132) and the MRA
IMAGE_SHAPE, IMAGE_LEVEL = (16, 2048, 2048), 3
IMAGE_BENCH = (8, 512, 512)
PACKET2_LEVEL = 2
MRA_SHAPE = (2, 512, 512)
IMAGE_THR = 0.8
# the 3D volume path: four 256³ volumes (CT and microscopy stacks) at Db4
# L2, bench.py's own (2, 64³) and (1, 128³) (bench.py:297-318, :477-481),
# the oct-tree packets of one volume, the MRA
VOLUME_SHAPE, VOLUME_LEVEL = (4, 256, 256, 256), 2
VOLUME_BENCH = ((2, 64, 64, 64), (1, 128, 128, 128))
PACKET3_SHAPE = (1, 256, 256, 256)
MRA3_SHAPE = (2, 64, 64, 64)
# the CWT: 64 signals of 16384 samples at 64 log scales (1 to 256, as
# bench.py:241), and bench.py's own 16 × 4096
CWT_SHAPE, CWT_SCALES = (64, 16384), 64
CWT_BENCH = (16, 4096)
# the decimated path at bench.py's own shapes: fwt and its L5 round trip
# (:82, :90) and wavedec/waverec at the north-star shape, fwt2 (:110), fwt3
# (:287), the packet tree (:222, :230) and the best-basis denoise (:161)
DEC_IMAGE = (16, 1024, 1024)
DEC_VOLUME, DEC_VOLUME_LEVELS = (4, 128, 128, 128), (2, 2, 2)
WPT_SHAPE, WPT_DENOISE_SHAPE, WPT_LEVEL = (64, 65536), (8, 65536), 6
WPT_WAVELET = "Symlet 8"
# the forward's, the inverse's and the fused denoise's edge shapes (B, N,
# level, wavelet): halo longer than N, N off the tile, each kernel's gate
# edges (the forward's: Haar L13 at the public maximum, Symlet 8 L10 at its
# own gate, Daubechies 2 L13 at the tile its W slices leave), the runtime-M
# kernel (Coiflet 1, M = 6); every width here leaves a register chain
# crossing some level's end
FWD_EDGES = ((3, 37, 3, "Daubechies 4"), (2, 100003, 5, "Daubechies 4"),
             (1, 1 << 13, 13, "Haar"), (1, 1 << 10, 10, "Symlet 8"),
             (2, 3000, 3, "Coiflet 1"), (1, 1 << 15, 13, "Daubechies 2"))
INV_EDGES = ((3, 37, 3, "Daubechies 4"), (2, 100003, 5, "Daubechies 4"),
             (1, 4096, 9, "Symlet 8"), (1, 1 << 13, 13, "Haar"),
             (2, 3000, 3, "Coiflet 1"))
DENOISE_EDGES = ((3, 37, 3, "Daubechies 4"), (2, 100003, 5, "Daubechies 4"),
                 (1, 2048, 10, "Haar"), (1, 1024, 7, "Symlet 8"),
                 (2, 3000, 3, "Coiflet 1"))
# the packet forward's and inverse's edge shapes (B, N, level, wavelet):
# halo longer than N, N off the tile, each specialised filter length and
# the runtime-M kernel (Daubechies 2, M = 4), leaves at d >= 32 (Haar L6,
# stored straight from the chains), L = 1 (the inverse's third row), B = 300
# rows, and the gate edges at N = 2^20: Db4 L8 for the forward (and the
# select), Db4 L7 for the inverse
PACKET_EDGES = ((3, 17, 3, "Daubechies 4"), (2, 100003, 3, "Haar"),
                (2, 5000, 2, "Symlet 8"), (3, 100003, 3, "Daubechies 2"),
                (2, 3000, 6, "Haar"), (2, 2000, 1, "Symlet 8"),
                (300, 5000, 3, "Daubechies 4"),
                (2, 1 << 20, 8, "Daubechies 4"),
                (2, 1 << 20, 7, "Daubechies 4"))
# the continuous slice at bench.py's shapes: the lifting pyramids,
# compressors, SWT, DTCWT (:102, :183), FFT and Hilbert tools at the
# north-star shape; the AED at the arbitrary length of :266; the 2D DTCWT
# at the image shape of :110; the banded CWT at :241 (and at the CWT
# path's 64 × 16384), the direct CWT and the coherence at :241's shape
SWT_ODD = (32, (1 << 16) + 1)
AED_SHAPE = (32, 100003)
DTCWT2_SHAPE, DTCWT2_LEVEL = (16, 1024, 1024), 3
DFT_SHAPE = (64, 4096)
DIRECT_SCALES = 32
# the second continuous slice at bench.py's shapes: synchrosqueezing
# (:400-414, and 64 × 16384 at 64 scales), the 2D CWT on sixteen and four
# 512² images, scattering (:370, :385), the EWT at 32 × 2^20; streaming at
# :201-219's shape (64 channels, buffer 16384, chunks of 4096, Db4 L5)
SSQ_BENCH, SSQ_SCALES = (4, 4096), 32
SSQ_WIDE, SSQ_WIDE_SCALES = (64, 16384), 64
SSQ_GAMMA = 1e-4
SSQ_COND = 64   # float32 error units a bin may move (check_ssq)
CWT2_REAL, CWT2_REAL_SCALES = (16, 512, 512), 8
CWT2_DIR, CWT2_DIR_SCALES, CWT2_ANGLES = (4, 512, 512), 6, 8
SCAT1_SHAPE, SCAT1_J, SCAT1_Q = (8, 65536), 8, 8
SCAT2_SHAPE, SCAT2_J, SCAT2_L = (4, 256, 256), 4, 8
EWT_SHAPE, EWT_MODES = (32, 1 << 20), 6
STREAM_CH, STREAM_BUF, STREAM_CHUNK, STREAM_UPDATES = 64, 16384, 4096, 16
CHUNKED_SHAPE = (64, 1 << 20)
# phase 30: preprocess_prices at bench.py:172's shape, a share of the prices
# marked as gaps, and the float32 error units a stage may move (check_chain)
FIN_SHAPE, FIN_GAPS, FIN_COND = (64, 1 << 16), 0.01, 16
# phase 32: the batches one exported artifact serves
SERVE_BATCHES = (1, 8, 32)
# phase 33: the sharded tier's signal-sharded CWT takes the CWT path's
# shape on scales that pass its aliasing gate (Morlet: a above ~4.4)
SHARD_CWT_SCALES = (5.0, 256.0)
# phase 34: bench.py's chained measurement (the JAX package's defaults for
# measure_samples_per_sec: chains of 4 and 24 steps, 3 repeats), its round
# trip's batch (bench.py:66), and the chained steps each trace records: a
# short first trace (it also takes the profiler's start-up cost), then a
# steady window long enough that the busy share is the device's
CHAIN_SHORT, CHAIN_LONG, CHAIN_REPEATS = 4, 24, 3
ROUNDTRIP_SHAPE = (8, 1 << 20)
TRACE_STEPS, STEADY_TRACE_STEPS = 3, 24
# phase 35: the median kernel's shapes, 16 rows as the denoise passes them
# (the north star's length, and the longest request of the denoise cell)
MEDIAN_SHAPES = ((16, 1 << 20), (16, 2_000_000))
# phase 36: the sharded cell's shard (wavebench/configs/
# modwt_db4_l5_sharded4.json) and the blocks of its check
SHARD_SHAPE = (8, 1 << 27)
SHARD_BLOCK = 1 << 16
# phase 37: the denoise cell's request at about its p95 length (16 rows,
# wavebench/workloads/modwt_db4_l5.denoise.json), and the north star's shape
SHRINK_SHAPES = ((16, 1_720_000), MAIN_SHAPE)
# phase 38: the 2D shrinking inverse's edges (batch, rows, cols, level,
# wavelet): an image below the halo, an odd shape, a strip crossing C's
# end at M = 16, Haar at the transforms' gate, a filter length without a
# specialised kernel
INV2_SHRINK_EDGES = ((2, 40, 48, 3, "Daubechies 4"),
                     (3, 509, 771, 3, "Daubechies 4"),
                     (2, 64, 600, 2, "Symlet 8"),
                     (1, 200, 140, 7, "Haar"),
                     (2, 33, 70, 2, "Daubechies 2"))
# phase 39: the packet denoise cell's call (wavebench/configs/
# wpt_sym8_l6.json, workloads/wpt_sym8_l6.denoise.json), its seed, and the
# rows held to the float64 reference
WPT_CELL_SHAPE, WPT_CELL_SEED, WPT_CELL_ROWS = (1024, 65536), 3000280901, 8
# the H100's published peaks (SXM, 700 W): HBM bytes/s, f32 FLOP/s
HBM_RATE, F32_RATE = 3.35e12, 67e12


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


def event_time(torch, fn, arg, k: int = 10, repeats: int = 5) -> float:
    """Seconds a call of ``fn(arg)`` takes on the card, on the same ``arg``
    every call: two untimed calls, then ``repeats`` runs of ``k`` calls
    between two CUDA events on the current stream; the median of the
    per-call times.  It times calls that are not shape-preserving, which
    the port's chained ``time_chain`` cannot take."""
    for _ in range(2):
        fn(arg)
    torch.cuda.synchronize(arg.device)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / k)
    return statistics.median(times)


def time_pair(torch, kern, plain, arg):
    """(kernel ms, plain ms) by CUDA events, in the order plain, kernel,
    kernel, plain: the two orders cancel drift."""
    tp1 = event_time(torch, plain, arg, k=3, repeats=3)
    tk1 = event_time(torch, kern, arg, k=10, repeats=5)
    tk2 = event_time(torch, kern, arg, k=10, repeats=5)
    tp2 = event_time(torch, plain, arg, k=3, repeats=3)
    return (tk1 + tk2) / 2 * 1e3, (tp1 + tp2) / 2 * 1e3


def wall_ms(torch, fn, repeats: int = 3) -> float:
    """Median host-clock ms of ``fn()`` ending in a synchronize (for calls
    that loop on the host, such as matching pursuit)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


GRAPH_CALLS = 20


def graph_ms(torch, fn, repeats: int = 5) -> float:
    """Device ms per call of ``fn()``: GRAPH_CALLS calls captured in one
    CUDA graph and replayed between CUDA events (median of ``repeats``), so
    the host's enqueue rate stays out of the time.  Warmed up on the
    capture stream first, so the capture allocates nothing new but the
    calls' outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    del graph
    return sorted(times)[len(times) // 2]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(smoke: Smoke, torch, jt) -> dict:
    from jwave_pro_tpu_torch.kernels import _build
    from jwave_pro_tpu_torch.kernels import denoise_cuda as kd
    from jwave_pro_tpu_torch.kernels import _launch as kl
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
    # the register-resident and marching kernels keep their arrays and
    # accumulators out of local memory
    marching = ("cwt_ifft", "modwt3_inv", "modwt3_fwd", "modwt2_denoise",
                "modwt2_fwd", "modwt2_inv", "modwt_var", "modwpt_select",
                "jw_modwt_fwd_kernel", "jw_modwt_fwd_ctx_kernel",
                "jw_modwt_inv_kernel", "jw_modwt_inv_shrink_kernel",
                "jw_denoise_kernel", "jw_modwpt_fwd_kernel",
                "jw_modwpt_inv_kernel")
    report = _build.ptxas_report()
    for name, (regs, stack, st, ld) in sorted(report.items()):
        if any(k in name for k in marching):
            smoke.require(f"ptxas {name}: {regs} registers, {stack} bytes "
                          f"stack, spills {st}/{ld} bytes",
                          stack == 0 and st == 0 and ld == 0)
    # the 1D forward's, inverse's and denoise's and the packet forward's and
    # inverse's every instantiation: f32/bf16 x M = 2, 8, 16, any M
    for kernel in ("jw_modwt_fwd_kernel", "jw_modwt_fwd_ctx_kernel",
                   "jw_modwt_inv_kernel", "jw_denoise_kernel",
                   "jw_modwpt_fwd_kernel", "jw_modwpt_inv_kernel"):
        count = sum(kernel in name for name in report)
        smoke.require(f"ptxas reports {kernel} for all 8 instantiations",
                      count == 8, f"({count})")
    # the shrinking inverses: f32/bf16 x M = 2, 8, 16, any M x soft, hard
    for kernel in ("jw_modwt_inv_shrink_kernel",
                   "jw_modwt2_inv_shrink_kernel"):
        count = sum(kernel in name for name in report)
        smoke.require(f"ptxas reports {kernel} for all 16 instantiations",
                      count == 16, f"({count})")

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
    # the forward's edges: halo longer than N, a ragged last tile, the gate
    # edges (Haar L13 at N = 2^13, Symlet 8 L10 at N = 2^10, Daubechies 2
    # L13 at its cut tile of 3267), the runtime-M kernel (Coiflet 1, M = 6),
    # each f32 and bf16, and two calls bitwise equal; every width here
    # leaves a register chain crossing some level's end
    for b, n, lvl, name in FWD_EDGES:
        wv = jt.wavelet(name)
        xe = signal(b, n)
        for dt in (torch.float32, torch.bfloat16):
            xd = xe.to(dt)
            got = kc.modwt_fwd_cuda(xd, wv, lvl)
            smoke.check(f"fwd ({b}, {n}) L{lvl} {name} {dt} vs plain",
                        max_err(got, kc.modwt_fwd_plain(xd, wv, lvl)),
                        1e-5 if dt == torch.float32 else 5e-2)
            smoke.require(f"fwd ({b}, {n}) L{lvl} {name} {dt}: two calls "
                          f"bitwise equal",
                          torch.equal(got, kc.modwt_fwd_cuda(xd, wv, lvl)))
    # the (N,) contract at its main size (B = 1 of the same kernel)
    xf = signal(MAIN_1D)
    cf = kc.modwt_fused(xf, w, LEVEL)
    smoke.require(f"1D contract shape at N={MAIN_1D}",
                  tuple(cf.shape) == (LEVEL + 1, MAIN_1D))
    smoke.check(f"1D fwd N={MAIN_1D} vs plain",
                max_err(cf, kc.modwt_fwd_plain(xf, w, LEVEL)), 1e-5)
    del xf, cf

    print("== phase 4: inverse kernel and round trip (f32)", flush=True)
    for shape, (x, c) in small.items():
        smoke.check(f"inv {shape} vs plain",
                    max_err(kc.modwt_inv_cuda(c, w), kc.modwt_inv_plain(c, w)),
                    1e-4)
        smoke.check(f"round trip {shape}",
                    max_err(kc.modwt_inv_cuda(c, w), x), 1e-4)
    # the inverse's edges: halo longer than N, the gate edges at N = 2^20
    # (Symlet 8 L9, Haar L13), the runtime-M kernel (Coiflet 1, M = 6), each
    # f32 and bf16, and two calls bitwise equal; every width here leaves a
    # register chain crossing some level's end
    for b, n, lvl, name in INV_EDGES:
        wv = jt.wavelet(name)
        c = kc.modwt_fwd_plain(signal(b, n), wv, lvl)
        for dt in (torch.float32, torch.bfloat16):
            cd = c.to(dt)
            got = kc.modwt_inv_cuda(cd, wv)
            smoke.check(f"inv ({b}, {n}) L{lvl} {name} {dt} vs plain",
                        max_err(got, kc.modwt_inv_plain(cd, wv)),
                        1e-4 if dt == torch.float32 else 5e-2)
            smoke.require(f"inv ({b}, {n}) L{lvl} {name} {dt}: two calls "
                          f"bitwise equal",
                          torch.equal(got, kc.modwt_inv_cuda(cd, wv)))
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
    # the denoise's edges: halo longer than N, the gate edges at N = 2^20
    # (Haar L10, Symlet 8 L7), the runtime-M kernel (Coiflet 1), soft and
    # hard, f32 and bf16, and two calls bitwise equal
    for b, n, lvl, name in DENOISE_EDGES:
        wv = jt.wavelet(name)
        xe = signal(b, n)
        thr = torch.linspace(0.2, 1.0, b, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            for mode in ("soft", "hard"):
                xd = xe.to(dt)
                got = kd.modwt_denoise_cuda(xd, thr, wv, lvl, mode)
                smoke.check(f"denoise ({b}, {n}) L{lvl} {name} {mode} {dt} "
                            f"vs plain", max_err(got, kd.modwt_denoise_plain(
                                xd, thr, wv, lvl, mode)),
                            1e-5 if dt == torch.float32 else 5e-2)
                smoke.require(
                    f"denoise ({b}, {n}) L{lvl} {name} {mode} {dt}: two "
                    f"calls bitwise equal", torch.equal(
                        got, kd.modwt_denoise_cuda(xd, thr, wv, lvl, mode)))

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
    counters = ("modwt_fwd", "modwt_inv", "modwt_denoise")
    torch.cuda.synchronize()
    for name in counters:
        kl.LAUNCHES[name] = 0
    c = jt.modwt(x, w, LEVEL)
    xr = jt.imodwt(c, w)
    den = jt.modwt_denoise(x, w, LEVEL, method="fused")
    fwd_batched = kl.LAUNCHES["modwt_fwd"]
    c1 = jt.modwt(x1, w, LEVEL)
    torch.cuda.synchronize()
    launches = {
        "modwt_fwd": fwd_batched,
        "modwt_fwd_1d": kl.LAUNCHES["modwt_fwd"] - fwd_batched,
        "modwt_inv": kl.LAUNCHES["modwt_inv"],
        "modwt_denoise": kl.LAUNCHES["modwt_denoise"],
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
    mra_counters = ("modwt_fwd", "modwt_inv", "modwt_denoise")
    # modwt alone: one forward launch
    counted_run(smoke, torch, mra_counters, f"modwt {MAIN_SHAPE} L{LEVEL}",
                lambda: jt.modwt(x, w, LEVEL), {"modwt_fwd": 1})

    # the imodwt backward: the inverse forward, the forward kernel backward
    def imodwt_backward():
        cg = c.detach().requires_grad_()
        jt.imodwt(cg, w).backward(x)
        return cg.grad

    grad, _ = counted_run(smoke, torch, mra_counters,
                          f"imodwt forward and backward {MAIN_SHAPE}",
                          imodwt_backward, {"modwt_inv": 1, "modwt_fwd": 1})
    smoke.check("imodwt backward = modwt of the cotangent", max_err(
        grad, kc.modwt_fwd_plain(x, w, LEVEL)), 1e-5)
    del grad
    # the 1D MRA: one forward, then one inverse a component
    mra, _ = counted_run(smoke, torch, mra_counters,
                         f"modwt_mra {MAIN_SHAPE} L{LEVEL}",
                         lambda: jt.modwt_mra(x, w, LEVEL),
                         {"modwt_fwd": 1, "modwt_inv": LEVEL + 1})
    smoke.require(f"MRA shape {(LEVEL + 1,) + MAIN_SHAPE} and finite",
                  tuple(mra.shape) == (LEVEL + 1,) + MAIN_SHAPE
                  and bool(torch.isfinite(mra).all()))
    smoke.check("MRA components sum to the signal", max_err(mra.sum(0), x),
                1e-4)
    del mra
    # the path's calls as a caller sees them (the fused denoise with its
    # default, universal threshold)
    for what, call in (
            ("modwt", lambda: jt.modwt(x, w, LEVEL)),
            ("imodwt", lambda: jt.imodwt(c, w)),
            ("imodwt forward and backward", imodwt_backward),
            ("modwt_denoise(method='fused')",
             lambda: jt.modwt_denoise(x, w, LEVEL, method="fused")),
            ("modwt_mra", lambda: jt.modwt_mra(x, w, LEVEL))):
        print(f"  wall {what} {MAIN_SHAPE} L{LEVEL}: "
              f"{wall_ms(torch, call):.3f} ms (host clock, median of 3) "
              f"[{card}]", flush=True)

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
        times[name] = report_time(torch, name, arg, kern, plain, card)

    library = {}
    for run_part in (run_slice, run_image_slice, run_volume_cwt_slice):
        part_launches, part_errs, part_times, *part_library = run_part(
            smoke, torch, jt, dev, signal, card)
        launches.update(part_launches)
        errs.update(part_errs)
        times.update(part_times)
        for lib in part_library:
            library.update(lib)

    run_decimated_slice(smoke, torch, jt, signal, card)
    run_continuous_slice(smoke, torch, jt, signal, card)
    run_backward_pin(smoke, torch, jt, signal, card)
    calls = run_continuous2_slice(smoke, torch, jt, signal, card)
    stream_calls = run_streaming_slice(smoke, torch, jt, signal, card)
    run_slice_walls(smoke, torch, jt, calls, stream_calls, card)
    run_financial_slice(smoke, torch, jt, card)
    run_facade_slice(smoke, torch, jt, signal, card)
    run_export_slice(smoke, torch, jt, signal, card)
    run_sharded_slice(smoke, torch, jt, signal, card)
    run_profiling_slice(smoke, torch, jt, signal, card)
    for part, got in zip((launches, errs, times, library),
                         run_median_slice(smoke, torch, jt, signal, card)):
        part.update(got)
    for part, got in zip((launches, errs, times),
                         run_shard_slice(smoke, torch, jt, signal, card)):
        part.update(got)
    for part, got in zip((launches, errs, times),
                         run_inv_shrink_slice(smoke, torch, jt, signal, card)):
        part.update(got)
    for part, got in zip((launches, errs, times),
                         run_inv2_shrink_slice(smoke, torch, jt, signal,
                                               card)):
        part.update(got)
    run_wpt_cell_slice(smoke, torch, jt, card)

    src = "jwave_pro_tpu_torch/csrc/"
    tpu = "jwave_pro_tpu/kernels/"
    meta = {
        "modwt_fwd": ("modwt.cu", "modwt_pallas.py:204"),
        "modwt_fwd_1d": ("modwt.cu", "modwt_pallas.py:286"),
        "modwt_inv": ("modwt.cu", "modwt_pallas.py:564"),
        "modwt_denoise": ("denoise.cu", "denoise_pallas.py:68"),
        "modwt_var": ("variance.cu", "variance_pallas.py:80"),
        "modwpt_fwd": ("modwpt.cu", "modwpt_pallas.py:128"),
        "modwpt_select": ("modwpt.cu", "modwpt_pallas.py:264"),
        "modwpt_inv": ("modwpt.cu", "modwpt_pallas.py:468"),
        "modwt2_fwd": ("modwt2.cu", "modwt2_pallas.py:192"),
        "modwt2_inv": ("modwt2.cu", "modwt2_pallas.py:314"),
        "modwt2_denoise": ("modwt2.cu", "modwt2_pallas.py:460"),
        "modwt3_fwd": ("modwt3.cu", "modwt3_pallas.py:172"),
        "modwt3_inv": ("modwt3.cu", "modwt3_pallas.py:331"),
        "cwt_ifft": ("cwt.cu", "cwt_pallas.py:105"),
        "median": ("median.cu", None),   # replaces no Pallas kernel
        # the forward of one shard: the JAX package's sharded forward is
        # plain XLA a level, no Pallas kernel
        "modwt_fwd_ctx": ("modwt.cu", None),
        # the inverse of shrunk details: the JAX package shrinks in plain
        # XLA before its inverse kernel
        "modwt_inv_shrink": ("modwt.cu", None),
        # the 2D inverse of shrunk bands: the JAX package's 2D denoise
        # shrinks in plain XLA before its inverse kernel
        "modwt2_inv_shrink": ("modwt2_shrink.cu", None),
    }
    bounds = kernel_bounds(w)
    for name in meta:
        print(f"  bound {name}: {bounds[name][0]:.4f} ms by "
              f"{bounds[name][1]}, kernel {times[name][0]:.4f} ms "
              f"({bounds[name][0] / times[name][0]:.1%} of it) [{card}]",
              flush=True)
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src + meta[name][0],
         "replaces": meta[name][1] and tpu + meta[name][1],
         "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library.get(name)}
        for name in meta]}


def bound(nbytes: float, flops: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move ``nbytes`` and do ``flops`` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / F32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bounds(w) -> dict:
    """Each kernel's bound at the shape its entry in the kernels line was
    timed at: every input read once, every output written once, and the
    float32 operations its function needs on these inputs.  A cascade level
    costs 2 flops (one multiply-add) per tap, per output and per input
    sample: 4M a sample for the MODWT pair, 8M for the two quadrant pairs
    of a 2D level and 16M for the four octant pairs of a 3D one (12M and
    28M with the passes before them); a shrink 3 flops, a square 2, an
    inverse FFT 5·P·log₂P a row and the complex product 6 a bin."""
    m = w.length
    b, n = MAIN_SHAPE
    cells = b * n
    pb, pn = PACKET_SHAPE
    packet = pb * pn
    tree = sum(4 * m << (j - 1) for j in range(1, PACKET_LEVEL + 1))
    mb, mn = MP_SHAPE
    img = math.prod(IMAGE_SHAPE)
    l2, l3 = IMAGE_LEVEL, VOLUME_LEVEL
    vol = math.prod(VOLUME_SHAPE)
    cb, cp = CWT_SHAPE
    rows = cb * CWT_SCALES
    return {
        "modwt_fwd": bound(4 * cells * (LEVEL + 2), cells * 4 * m * LEVEL),
        "modwt_fwd_1d": bound(4 * MAIN_1D * (LEVEL + 2),
                              MAIN_1D * 4 * m * LEVEL),
        "modwt_inv": bound(4 * cells * (LEVEL + 2), cells * 4 * m * LEVEL),
        "modwt_denoise": bound(4 * (2 * cells + b),
                               cells * (8 * m + 3) * LEVEL),
        "modwt_var": bound(4 * (cells + b * (LEVEL + 1)),
                           cells * (4 * m + 2) * LEVEL),
        "modwpt_fwd": bound(4 * packet * (1 + (1 << PACKET_LEVEL)),
                            packet * tree),
        "modwpt_select": bound(4 * mb * mn + 12 * mb * (1 << MP_LEVEL),
                               mb * mn * (tree + 2 * (1 << MP_LEVEL))),
        "modwpt_inv": bound(4 * packet * (1 + (1 << PACKET_LEVEL)),
                            packet * tree),
        "modwt2_fwd": bound(4 * img * (3 * l2 + 2), img * 12 * m * l2),
        "modwt2_inv": bound(4 * img * (3 * l2 + 2), img * 12 * m * l2),
        "modwt2_denoise": bound(4 * (2 * img + IMAGE_SHAPE[0]),
                                img * (24 * m + 9) * l2),
        "modwt3_fwd": bound(4 * vol * (7 * l3 + 2), vol * 28 * m * l3),
        "modwt3_inv": bound(4 * vol * (7 * l3 + 2), vol * 28 * m * l3),
        "cwt_ifft": bound(8 * (cb * cp + CWT_SCALES * cp + rows * cp),
                          rows * (6 * cp + 5 * cp * int(math.log2(cp)))),
        # one read of the rows; the compares and counts are not the bound
        "median": bound(4 * math.prod(MEDIAN_SHAPES[0]), 0),
        # the forward's, plus the context of (M - 1)(2^L - 1) a row read
        "modwt_fwd_ctx": bound(4 * cells * (LEVEL + 2)
                               + 4 * b * (m - 1) * ((1 << LEVEL) - 1),
                               cells * 4 * m * LEVEL),
        # the inverse's 7 planes and a threshold a row and level; a shrink
        # of each detail value
        "modwt_inv_shrink": bound(4 * cells * (LEVEL + 2) + 4 * b * LEVEL,
                                  cells * (4 * m + 3) * LEVEL),
        # the 2D inverse's 3L + 1 bands and output, and a threshold an
        # image and band; three shrinks a pixel and level
        "modwt2_inv_shrink": bound(4 * img * (3 * l2 + 2)
                                   + 4 * IMAGE_SHAPE[0] * 3 * l2,
                                   img * (12 * m + 9) * l2),
    }


def counted_run(smoke: Smoke, torch, counters, what: str, calls,
                want: dict):
    """Run ``calls`` with the launch count of every operator named in
    ``counters`` at 0 and require exactly the launches ``want`` names (0
    for the others); returns (output, counts)."""
    from jwave_pro_tpu_torch.kernels._launch import LAUNCHES

    torch.cuda.synchronize()
    for name in counters:
        LAUNCHES[name] = 0
    out = calls()
    torch.cuda.synchronize()
    got = {name: LAUNCHES[name] for name in counters}
    want = {name: want.get(name, 0) for name in counters}
    print(f"  launches on {what}: {got}", flush=True)
    smoke.require(f"launches on {what} as expected", got == want,
                  f"(want {want})")
    return out, got


def report_time(torch, name, arg, kern, plain, card, samples=None):
    """Time kernel against plain version and print both with the card;
    ``samples`` defaults to the last two dims of ``arg``."""
    if samples is None:
        samples = arg.shape[-1] * (arg.shape[-2] if arg.ndim > 1 else 1)
    tk, tp = time_pair(torch, kern, plain, arg)
    print(f"  {name} {tuple(arg.shape)}: kernel {tk:.4f} ms "
          f"({samples / tk * 1e3:.4e} samples/s), plain {tp:.4f} ms "
          f"({samples / tp * 1e3:.4e} samples/s) [{card}]", flush=True)
    return tk, tp


def packet_edges(smoke: Smoke, torch, jt, kp, signal):
    """The packet forward and inverse against their plain versions at
    PACKET_EDGES, f32 and bf16 (the inverse where its gate admits the
    shape); on every shape two forward calls bitwise equal and the select
    equal to the arg-max over the forward's output."""
    from jwave_pro_tpu_torch.kernels.modwt_cuda import kernel_supported

    for b, n, level, name in PACKET_EDGES:
        wv = jt.wavelet(name)
        x = signal(b, n)
        tag = f"({b}, {n}) L{level} {name}"
        for dt, tol_f, tol_i, tol_rt in ((torch.float32, 1e-5, 1e-4, 1e-4),
                                         (torch.bfloat16, 5e-2, 5e-2, 1e-1)):
            xd = x.to(dt)
            c = kp.modwpt_fwd_cuda(xd, wv, level)
            smoke.check(f"packet fwd {tag} {dt} vs plain",
                        max_err(c, kp.modwpt_fwd_plain(xd, wv, level)), tol_f)
            smoke.require(f"packet fwd {tag} {dt}: two calls bitwise equal",
                          torch.equal(c, kp.modwpt_fwd_cuda(xd, wv, level)))
            # bf16 input: the select computes in f32 from the bf16 values,
            # as the forward of those values as f32 does
            cs = c if dt == torch.float32 else kp.modwpt_fwd_cuda(
                xd.float(), wv, level)
            a, t, v = kp.modwpt_select_cuda(xd, wv, level)
            want_t = torch.argmax(cs.abs(), dim=-1)
            smoke.require(
                f"select {tag} {dt} = arg-max over the forward kernel's "
                f"output (positions, values exact)",
                torch.equal(t.long(), want_t) and torch.equal(
                    v, torch.gather(cs, -1, want_t[..., None])[..., 0])
                and torch.equal(a, v.abs()))
            del cs
            if kernel_supported(n, level, wv.length, "pinv"):
                r = kp.modwpt_inv_cuda(c, wv)
                smoke.check(f"packet inv {tag} {dt} vs plain",
                            max_err(r, kp.modwpt_inv_plain(c, wv)), tol_i)
                smoke.check(f"packet round trip {tag} {dt}",
                            max_err(r, xd), tol_rt)
                del r
            del c
        torch.cuda.empty_cache()


def run_slice(smoke: Smoke, torch, jt, dev, signal, card):
    """The statistics and packet-tree path: phases 10-14.  Returns the
    launches on its main path, each kernel's max-abs-err against its plain
    version there, and (kernel ms, plain ms) per kernel."""
    from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
    from jwave_pro_tpu_torch.kernels import variance_cuda as kv

    w = jt.wavelet(WAVELET)

    def rel_err(a, b) -> float:
        return float(((a.double() - b.double()).abs()
                      / b.double().abs().clamp_min(1e-30)).max())

    print("== phase 10: variance and packet kernels vs plain (small shapes, "
          "N = 100003, halo > N)", flush=True)
    small = ((16, 8192, 5, 3), (32, 100003, 5, 3), (4, 16, 4, 4))
    for b, n, lv_var, lv_pkt in small:
        x = signal(b, n)
        smoke.check(f"var ({b}, {n}) L{lv_var} vs plain (relative)",
                    rel_err(kv.modwt_var_cuda(x, w, lv_var),
                            kv.modwt_var_plain(x, w, lv_var)), 1e-4)
        c = kp.modwpt_fwd_cuda(x, w, lv_pkt)
        smoke.check(f"packet fwd ({b}, {n}) L{lv_pkt} vs plain",
                    max_err(c, kp.modwpt_fwd_plain(x, w, lv_pkt)), 1e-5)
        smoke.check(f"packet inv ({b}, {n}) L{lv_pkt} vs plain",
                    max_err(kp.modwpt_inv_cuda(c, w),
                            kp.modwpt_inv_plain(c, w)), 1e-4)
        smoke.check(f"packet round trip ({b}, {n}) L{lv_pkt}",
                    max_err(kp.modwpt_inv_cuda(c, w), x), 1e-4)
        a, t, v = kp.modwpt_select_cuda(x, w, lv_pkt)
        want_t = torch.argmax(c.abs(), dim=-1)
        want_v = torch.gather(c, -1, want_t[..., None])[..., 0]
        smoke.require(f"select ({b}, {n}) L{lv_pkt} = arg-max over the "
                      f"forward kernel's output (positions, values exact)",
                      torch.equal(t.long(), want_t)
                      and torch.equal(v, want_v) and torch.equal(a, v.abs()))
        cp = kp.modwpt_fwd_plain(x, w, lv_pkt)
        at_t = torch.gather(cp, -1, t.long()[..., None])[..., 0]
        smoke.check(f"select ({b}, {n}) value vs plain at its position",
                    max_err(v, at_t), 1e-5)
        smoke.check(f"select ({b}, {n}) plain |w| there vs plain max",
                    max_err(at_t.abs(), kp.modwpt_select_plain(
                        x, w, lv_pkt)[0]), 1e-5)
    # edge shapes: each specialised filter length and the runtime-M one
    # (Db2), N off the tile, the gate edges (Db4 L11 variance, L8 select),
    # and rows whose last block is not the grid's last (B = 300, 2 tiles)
    edges = ((2, 3000, 5, 5, "Haar"), (2, 5000, 4, 3, "Symlet 8"),
             (3, 100003, 3, 3, "Daubechies 2"), (2, 100003, 11, 8, WAVELET),
             (300, 5000, 3, 3, WAVELET))
    for b, n, lv_var, lv_sel, name in edges:
        wv = jt.wavelet(name)
        x = signal(b, n)
        var_plan = kv.var_plan(b, n, lv_var, wv.length)
        sel_plan = kp.select_plan(b, n, lv_sel, wv.length)
        print(f"  plans ({b}, {n}) {name}: var L{lv_var} {var_plan}, select "
              f"L{lv_sel} {sel_plan}", flush=True)
        smoke.check(f"var ({b}, {n}) L{lv_var} {name} vs plain (relative)",
                    rel_err(kv.modwt_var_cuda(x, wv, lv_var),
                            kv.modwt_var_plain(x, wv, lv_var)), 1e-4)
        a, t, v = kp.modwpt_select_cuda(x, wv, lv_sel)
        c = kp.modwpt_fwd_cuda(x, wv, lv_sel)
        want_t = torch.argmax(c.abs(), dim=-1)
        smoke.require(f"select ({b}, {n}) L{lv_sel} {name} = arg-max over "
                      f"the forward kernel's output (positions, values exact)",
                      torch.equal(t.long(), want_t) and torch.equal(
                          v, torch.gather(c, -1, want_t[..., None])[..., 0])
                      and torch.equal(a, v.abs()))
        at_t = torch.gather(kp.modwpt_fwd_plain(x, wv, lv_sel), -1,
                            t.long()[..., None])[..., 0]
        smoke.check(f"select ({b}, {n}) {name} value vs plain at its "
                    f"position", max_err(v, at_t), 1e-5)
        del c
    packet_edges(smoke, torch, jt, kp, signal)
    x = signal(16, 8192)
    x16 = x.bfloat16()
    smoke.check("bf16 var vs bf16 plain (relative)",
                rel_err(kv.modwt_var_cuda(x16, w, 5),
                        kv.modwt_var_plain(x16, w, 5)), 1e-4)
    c32 = kp.modwpt_fwd_cuda(x, w, 3)
    c16 = kp.modwpt_fwd_cuda(x16, w, 3)
    smoke.require("bf16 packet fwd dtype", c16.dtype == torch.bfloat16)
    smoke.check("bf16 packet fwd vs f32 packet fwd", max_err(c16, c32), 5e-2)
    smoke.check("bf16 packet round trip", max_err(kp.modwpt_inv_cuda(c16, w),
                                                  x), 1e-1)
    a16, t16, v16 = kp.modwpt_select_cuda(x16, w, 3)
    c16f = kp.modwpt_fwd_cuda(x16.float(), w, 3)
    smoke.require("bf16 select = arg-max over the forward of its f32 values",
                  torch.equal(t16.long(), torch.argmax(c16f.abs(), dim=-1)))
    x16 = signal(4, 100003, dtype=torch.bfloat16)
    smoke.check("bf16 var (4, 100003) L5 vs bf16 plain (relative)",
                rel_err(kv.modwt_var_cuda(x16, w, 5),
                        kv.modwt_var_plain(x16, w, 5)), 1e-4)
    c16f = kp.modwpt_fwd_cuda(x16.float(), w, 3)
    smoke.require("bf16 select (4, 100003) L3 = arg-max over the forward of "
                  "its f32 values", torch.equal(
                      kp.modwpt_select_cuda(x16, w, 3)[1].long(),
                      torch.argmax(c16f.abs(), dim=-1)))
    del c16f

    print("== phase 11: gradients through the packet autograd pair",
          flush=True)
    x = signal(8, 4096)
    wts = signal(8, 8, 4096)
    xk = x.clone().requires_grad_()
    (kp.modwpt_fused(xk, w, 3) * wts).sum().backward()
    xp = x.clone().requires_grad_()
    (jt.modwpt(xp, w, 3, method="direct") * wts).sum().backward()
    smoke.check("grad of modwpt_fused vs plain autograd",
                max_err(xk.grad, xp.grad), 1e-4)
    ck = wts.clone().requires_grad_()
    (kp.imodwpt_fused(ck, w) * x).sum().backward()
    cp = wts.clone().requires_grad_()
    (jt.imodwpt(cp, w, method="direct") * x).sum().backward()
    smoke.check("grad of imodwpt_fused vs plain autograd",
                max_err(ck.grad, cp.grad), 1e-4)

    print(f"== phase 12: statistics {MAIN_SHAPE} L{LEVEL}, packet tree "
          f"{PACKET_SHAPE} L{PACKET_LEVEL}, matching pursuit {MP_SHAPE} "
          f"L{MP_LEVEL} K={MP_ATOMS}, f32 {WAVELET}, through the public API",
          flush=True)
    x = signal(*MAIN_SHAPE)
    y = 0.5 * x + signal(*MAIN_SHAPE)
    xp = signal(*PACKET_SHAPE)
    xm = signal(*MP_SHAPE)
    counters = ("modwt_var", "modwpt_fwd", "modwpt_inv", "modwpt_select")
    # each call in a counted window of its own, with its exact launches:
    # one variance kernel a statistic (four for the correlation: x + y,
    # x − y, x, y), one select a pursuit's pick
    launches = dict.fromkeys(counters, 0)

    def counted(what, calls, want):
        out, got = counted_run(smoke, torch, counters, what, calls, want)
        for name, count in got.items():
            launches[name] += count
        return out

    var = counted("modwt_variance", lambda: jt.modwt_variance(x, w, LEVEL),
                  {"modwt_var": 1})
    hurst = counted("modwt_hurst", lambda: jt.modwt_hurst(x, w, LEVEL),
                    {"modwt_var": 1})
    rho = counted("modwt_correlation",
                  lambda: jt.modwt_correlation(x, y, w, LEVEL),
                  {"modwt_var": 4})
    cp = counted("modwpt", lambda: jt.modwpt(xp, w, PACKET_LEVEL),
                 {"modwpt_fwd": 1})
    xpr = counted("imodwpt", lambda: jt.imodwpt(cp, w), {"modwpt_inv": 1})
    mp = counted(f"greedy matching pursuit, K = {MP_ATOMS}",
                 lambda: jt.matching_pursuit(xm, w, MP_LEVEL, MP_ATOMS),
                 {"modwpt_select": MP_ATOMS})
    omp = counted(f"orthogonal matching pursuit, K = {MP_ATOMS}",
                  lambda: jt.matching_pursuit(xm, w, MP_LEVEL, MP_ATOMS,
                                              orthogonalize=True),
                  {"modwpt_select": MP_ATOMS})
    print(f"  launches on the statistics and packet-tree path: {launches}",
          flush=True)
    for name, count in launches.items():
        smoke.require(f"{name} kernel launched", count >= 1, f"({count})")
    b = MAIN_SHAPE[0]
    for name, t, shape in (
            ("variance", var, (LEVEL, b)), ("hurst", hurst, (b,)),
            ("correlation", rho, (LEVEL, b)),
            ("packet coeffs", cp, (1 << PACKET_LEVEL,) + PACKET_SHAPE),
            ("packet reconstruction", xpr, PACKET_SHAPE),
            ("MP residual", mp.residual, MP_SHAPE),
            ("OMP amps", omp.amps, (MP_SHAPE[0], MP_ATOMS))):
        smoke.require(f"{name} shape {shape} and finite",
                      tuple(t.shape) == shape
                      and bool(torch.isfinite(t).all()))
    # references: the f64 plain path on two rows
    ref = jt.modwt_variance(x[:2].double(), w, LEVEL, method="direct")
    smoke.check("variance vs f64 direct path (relative)",
                rel_err(var[:, :2], ref), 1e-4)
    ref = jt.modwt_correlation(x[:2].double(), y[:2].double(), w, LEVEL,
                               method="direct")
    smoke.check("correlation (polarization, f32) vs f64 direct path",
                max_err(rho[:, :2], ref), 1e-3)
    smoke.require("white-noise Hurst exponent within 0.1 of 1/2",
                  bool(((hurst - 0.5).abs() < 0.1).all()),
                  f"(range {float(hurst.min()):.4f}..{float(hurst.max()):.4f})")
    smoke.check("packet round trip at full width", max_err(xpr, xp), 1e-4)
    for name, r in (("MP", mp), ("OMP", omp)):
        smoke.check(f"{name} reconstruct + residual vs input",
                    max_err(jt.mp_reconstruct(r, w) + r.residual, xm), 1e-3)
    e_in = (xm.double() ** 2).sum(-1)
    e_id = (e_in - (mp.amps.double() ** 2).sum(-1)
            - (mp.residual.double() ** 2).sum(-1)).abs()
    smoke.check("MP greedy energy identity over ‖x‖²",
                float(e_id.max() / e_in.max()), 1e-3)
    mp_d = jt.matching_pursuit(xm, w, MP_LEVEL, MP_ATOMS, method="direct")
    omp_d = jt.matching_pursuit(xm, w, MP_LEVEL, MP_ATOMS, method="direct",
                                orthogonalize=True)
    for name, r, rd in (("MP", mp, mp_d), ("OMP", omp, omp_d)):
        smoke.require(f"{name} first pick = the method='direct' run's",
                      torch.equal(r.nodes[:, 0], rd.nodes[:, 0])
                      and torch.equal(r.shifts[:, 0], rd.shifts[:, 0]))
        same = int(((r.nodes == rd.nodes) & (r.shifts == rd.shifts)).sum())
        print(f"  {name}: {same} of {r.nodes.numel()} picks agree with "
              f"method='direct'", flush=True)

    # each kernel against its plain version at the path's shapes (these
    # launches are not counted above)
    # the in-launch finish adds in a fixed order: two calls are bitwise equal
    a, t, v = kp.modwpt_select_cuda(xm, w, MP_LEVEL)
    smoke.require("select kernel: two calls bitwise equal", all(
        torch.equal(p, q) for p, q in zip(
            (a, t, v), kp.modwpt_select_cuda(xm, w, MP_LEVEL))))
    vk = kv.modwt_var_cuda(x, w, LEVEL)
    smoke.require("variance kernel: two calls bitwise equal",
                  torch.equal(vk, kv.modwt_var_cuda(x, w, LEVEL)))
    vp = kv.modwt_var_plain(x, w, LEVEL)
    smoke.check("var vs plain at the path's shape (relative)",
                rel_err(vk, vp), 1e-4)
    cm = kp.modwpt_fwd_plain(xm, w, MP_LEVEL)
    at_t = torch.gather(cm, -1, t.long()[..., None])[..., 0]
    errs = {
        "modwt_var": smoke.check(
            "var vs plain at the path's shape", max_err(vk, vp), 1e-4),
        "modwpt_fwd": smoke.check(
            "packet fwd vs plain at the path's shape",
            max_err(cp, kp.modwpt_fwd_plain(xp, w, PACKET_LEVEL)), 1e-5),
        "modwpt_inv": smoke.check(
            "packet inv vs plain at the path's shape",
            max_err(xpr, kp.modwpt_inv_plain(cp, w)), 1e-4),
        "modwpt_select": smoke.check(
            "select value vs plain at the MP shape", max_err(v, at_t), 1e-5),
    }
    smoke.check("select: plain |w| at its positions vs plain max",
                max_err(at_t.abs(), cm.abs().amax(-1)), 1e-5)
    del cm

    print(f"== phase 13: times (CUDA events, median) on {card}", flush=True)
    pairs = {
        "modwt_var": (x, lambda u: kv.modwt_var_cuda(u, w, LEVEL),
                      lambda u: kv.modwt_var_plain(u, w, LEVEL)),
        "modwpt_fwd": (xp, lambda u: kp.modwpt_fwd_cuda(u, w, PACKET_LEVEL),
                       lambda u: kp.modwpt_fwd_plain(u, w, PACKET_LEVEL)),
        "modwpt_inv": (cp, lambda u: kp.modwpt_inv_cuda(u, w),
                       lambda u: kp.modwpt_inv_plain(u, w)),
        "modwpt_select": (xm, lambda u: kp.modwpt_select_cuda(u, w, MP_LEVEL),
                          lambda u: kp.modwpt_select_plain(u, w, MP_LEVEL)),
    }
    times = {}
    for name, (arg, kern, plain) in pairs.items():
        times[name] = report_time(torch, name, arg, kern, plain, card)
    # both finish their reduction in one launch: their device time from a
    # CUDA graph of the wrapper's calls (the kernels line's ms), beside the
    # wrapper's time per call as a caller sees it (the line above)
    for name in ("modwt_var", "modwpt_select"):
        arg, kern, _ = pairs[name]
        dev_ms = graph_ms(torch, lambda: kern(arg))
        print(f"  {name} {tuple(arg.shape)}: device {dev_ms:.4f} ms a call "
              f"(CUDA graph of {GRAPH_CALLS} calls), wrapper "
              f"{times[name][0]:.4f} ms a call (CUDA events) [{card}]",
              flush=True)
        times[name] = (dev_ms, times[name][1])
    for what, call in (
            ("modwpt", lambda: jt.modwpt(xp, w, PACKET_LEVEL)),
            ("imodwpt", lambda: jt.imodwpt(cp, w))):
        print(f"  wall {what} {PACKET_SHAPE} L{PACKET_LEVEL}: "
              f"{wall_ms(torch, call):.3f} ms (host clock, median of 3) "
              f"[{card}]", flush=True)

    print(f"== phase 14: matching pursuit wall time {MP_SHAPE} K={MP_ATOMS} "
          f"(host clock, median of 3) on {card}", flush=True)
    for ortho in (False, True):
        name = "OMP" if ortho else "MP"

        def run_mp(method):
            return lambda: jt.matching_pursuit(xm, w, MP_LEVEL, MP_ATOMS,
                                               method=method,
                                               orthogonalize=ortho)

        td1 = wall_ms(torch, run_mp("direct"))
        tk1 = wall_ms(torch, run_mp("auto"))
        tk2 = wall_ms(torch, run_mp("auto"))
        td2 = wall_ms(torch, run_mp("direct"))
        print(f"  {name}: select kernel path {(tk1 + tk2) / 2:.3f} ms, "
              f"method='direct' {(td1 + td2) / 2:.3f} ms [{card}]",
              flush=True)
    return launches, errs, times


def run_image_slice(smoke: Smoke, torch, jt, dev, signal, card):
    """The 2D image path: phases 15-17.  Returns the new kernels' launches
    on its full-width calls, each new kernel's max-abs-err against its
    plain version there, and (kernel ms, plain ms) per new kernel.  The
    packet kernels' launch counts and errors on this path are checked
    here; their entries in the kernels line stay phase 12's."""
    from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
    from jwave_pro_tpu_torch.kernels import modwt2_cuda as k2

    w = jt.wavelet(WAVELET)
    lvl = IMAGE_LEVEL

    print("== phase 15: 2D kernels vs plain (small shapes, halo > image, "
          "Symlet 8, Haar L6 and L7, bf16; strips and row runs across the "
          "image's end)", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small = (((2, 128, 256), 2, WAVELET, ("soft", "hard")),
             ((3, 1000, 750), 3, WAVELET, ("soft",)),
             ((2, 40, 24), 3, WAVELET, ("soft", "hard")),
             ((1, 256, 256), 2, "Symlet 8", ("soft", "hard")),
             ((1, 100, 70), 6, "Haar", ("soft", "hard")),
             ((1, 1000, 200), 3, WAVELET, ("soft", "hard")),
             ((2, 70, 90), 2, "Daubechies 2", ("soft",)))
    # the transforms' gate edge (no denoise there), and a last strip
    # crossing C's end
    edges = (((1, 130, 300), 7, "Haar", ()),
             ((1, 200, 180), 3, "Symlet 8", ()),
             ((2, 64, 1001), 3, WAVELET, ()))
    for shape, lv, name, modes in small + edges:
        m = jt.wavelet(name).length
        for kind in ("fwd", "inv"):
            wd, grp, tc, run, grid = k2.transform2_launch_plan(
                shape, lv, m, kind, torch.float32, dev)
            print(f"  2D {kind} plan {shape} L{lv} {name}: window {wd}, "
                  f"strip {tc}, {grp} rows a step, runs of {run} rows, grid "
                  f"{grid}; {-(-shape[2] // tc)} strips, the last ending "
                  f"{-shape[2] % tc} columns past the image", flush=True)
        if not modes:
            continue
        wd, grp, tc = k2.denoise2_plan(lv, m)
        print(f"  2D denoise plan {shape} L{lv} {name}: window {wd}, strip "
              f"{tc}, {grp} rows a step, runs of "
              f"{k2.denoise2_run(*shape, lv, m, sms)} rows (at one block "
              f"an SM); {-(-shape[2] // tc)} strips, the last ending "
              f"{-shape[2] % tc} columns past the image", flush=True)
    for shape, lv, name, modes in small + edges:
        wv = jt.wavelet(name)
        x = signal(*shape)
        tag = f"{shape} L{lv} {name}"
        c = k2.modwt2_fwd_cuda(x, wv, lv)
        smoke.check(f"2D fwd {tag} vs plain",
                    max_err(c, k2.modwt2_fwd_plain(x, wv, lv)), 1e-4)
        xr = k2.modwt2_inv_cuda(c, wv)
        smoke.check(f"2D inv {tag} vs plain",
                    max_err(xr, k2.modwt2_inv_plain(c, wv)), 1e-4)
        smoke.check(f"2D round trip {tag}", max_err(xr, x), 1e-4)
        # thresholds that differ per image
        thr = torch.linspace(0.3, 1.2, shape[0], device=dev)
        for mode in modes:
            d = k2.modwt2_denoise_cuda(x, thr, wv, lv, mode)
            smoke.check(f"2D denoise {mode} {tag} vs plain", max_err(
                d, k2.modwt2_denoise_plain(x, thr, wv, lv, mode)), 1e-4)
            pipe = jt.modwt2_denoise(x, wv, lv, mode,
                                     threshold=thr[:, None, None])
            smoke.check(f"2D denoise {mode} {tag} vs kernel pipeline",
                        max_err(d, pipe), 1e-4)
    # reference on a small input: the f64 direct path on the host
    x = signal(2, 40, 24)
    ref = jt.modwt2(x.double().cpu(), w, 3, method="direct")
    smoke.check("2D fwd (2, 40, 24) L3 vs f64 host direct path",
                max_err(k2.modwt2_fwd_cuda(x, w, 3).cpu(), ref), 1e-5)
    x = signal(4, 512, 512)
    c32 = k2.modwt2_fwd_cuda(x, w, 3)
    c16 = k2.modwt2_fwd_cuda(x.bfloat16(), w, 3)
    smoke.require("bf16 2D fwd dtype", c16.dtype == torch.bfloat16)
    smoke.check("bf16 2D fwd (4, 512, 512) L3 vs f32 fwd", max_err(c16, c32),
                5e-2)
    smoke.check("bf16 2D fwd vs bf16 plain",
                max_err(c16, k2.modwt2_fwd_plain(x.bfloat16(), w, 3)), 5e-2)
    smoke.check("bf16 2D round trip", max_err(k2.modwt2_inv_cuda(c16, w), x),
                1e-1)
    thr = torch.full((4,), IMAGE_THR, device=dev)
    smoke.check("bf16 2D denoise vs f32 2D denoise", max_err(
        k2.modwt2_denoise_cuda(x.bfloat16(), thr, w, 3),
        k2.modwt2_denoise_cuda(x, thr, w, 3)), 1e-1)
    # hard mode is discontinuous at the threshold, so bf16 input is held
    # against the plain version on the same bf16 input, not against f32
    d16 = k2.modwt2_denoise_cuda(x.bfloat16(), thr, w, 3, "hard")
    smoke.require("bf16 2D denoise dtype", d16.dtype == torch.bfloat16)
    smoke.check("bf16 2D denoise (hard) vs bf16 plain", max_err(
        d16, k2.modwt2_denoise_plain(x.bfloat16(), thr, w, 3, "hard")),
        5e-2)

    print(f"== phase 16: 2D path {IMAGE_SHAPE} f32 {WAVELET} L{lvl}, packets "
          f"L{PACKET2_LEVEL}, MRA {MRA_SHAPE}, through the public API",
          flush=True)
    x = signal(*IMAGE_SHAPE)
    xm = signal(*MRA_SHAPE)
    counters = ("modwt2_fwd", "modwt2_inv", "modwt2_inv_shrink",
                "modwt2_denoise", "modwpt_fwd", "modwpt_inv")

    def counted(what, calls, want):
        return counted_run(smoke, torch, counters, what, calls, want)

    def estimate():
        """The fused path's default threshold: universal, one per image."""
        return jt.universal_threshold(
            jt.modwt2(x, w, 1, method="direct")[2].flatten(-2))

    def main_calls():
        c = jt.modwt2(x, w, lvl)
        xr = jt.imodwt2(c, w)
        den_f = jt.modwt2_denoise(x, w, lvl, method="fused")
        p = jt.modwpt2(x, w, PACKET2_LEVEL)
        return c, xr, den_f, p, jt.imodwpt2(p, w)

    # the packet pair runs one 1D launch per axis
    (c, xr, den_f, p, xpr), launches = counted(
        "the full-width 2D path", main_calls,
        {"modwt2_fwd": 1, "modwt2_inv": 1, "modwt2_denoise": 1,
         "modwpt_fwd": 2, "modwpt_inv": 2})
    launches = {name: launches[name] for name in
                ("modwt2_fwd", "modwt2_inv", "modwt2_denoise")}
    den_p, _ = counted(
        "the full-width pipeline denoise",
        lambda: jt.modwt2_denoise(x, w, lvl, threshold=IMAGE_THR),
        {"modwt2_fwd": 1, "modwt2_inv_shrink": 1})
    mra, _ = counted("the 2D MRA", lambda: jt.modwt2_mra(xm, w, lvl),
                     {"modwt2_fwd": 1, "modwt2_inv": 3 * lvl + 1})
    nodes = 1 << PACKET2_LEVEL
    for name, t, shape in (
            ("2D coeffs", c, (3 * lvl + 1,) + IMAGE_SHAPE),
            ("2D reconstruction", xr, IMAGE_SHAPE),
            ("fused denoise", den_f, IMAGE_SHAPE),
            ("pipeline denoise", den_p, IMAGE_SHAPE),
            ("quad-tree packets", p, (nodes, nodes) + IMAGE_SHAPE),
            ("packet reconstruction", xpr, IMAGE_SHAPE),
            ("2D MRA", mra, (3 * lvl + 1,) + MRA_SHAPE)):
        smoke.require(f"{name} shape {shape} and finite",
                      tuple(t.shape) == shape
                      and bool(torch.isfinite(t).all()))
    smoke.check("2D round trip at full width", max_err(xr, x), 1e-4)
    smoke.check("quad-tree packet round trip at full width",
                max_err(xpr, x), 1e-4)
    smoke.check("2D MRA sums to the image", max_err(mra.sum(0), xm), 1e-4)
    del mra

    # the packet kernels against their plain versions on the operands the
    # quad tree gives them (these launches are not counted above): forward
    # over the columns (B·C, R), then the rows (P·B·R, C); inverse over
    # (P, P·B·R, C), then (P, B·C, R)
    b, r, cols = IMAGE_SHAPE
    lv2 = PACKET2_LEVEL
    xt = x.swapaxes(-1, -2).reshape(-1, r)
    fa = kp.modwpt_fwd_cuda(xt, w, lv2)
    smoke.check(f"packet fwd vs plain at the quad tree's {tuple(xt.shape)}",
                max_err(fa, kp.modwpt_fwd_plain(xt, w, lv2)), 1e-5)
    xt = fa.reshape(nodes, b, cols, r).swapaxes(-1, -2).reshape(-1, cols)
    del fa
    fb = kp.modwpt_fwd_cuda(xt, w, lv2)
    smoke.check(f"packet fwd vs plain at the quad tree's {tuple(xt.shape)}",
                max_err(fb, kp.modwpt_fwd_plain(xt, w, lv2)), 1e-5)
    smoke.require("modwpt2 = the packet kernel on these operands",
                  torch.equal(fb.reshape((nodes, nodes) + IMAGE_SHAPE)
                              .swapaxes(0, 1), p))
    del xt, fb
    ct = p.swapaxes(0, 1).reshape(nodes, -1, cols)
    del p
    ia = kp.modwpt_inv_cuda(ct, w)
    smoke.check(f"packet inv vs plain at the quad tree's {tuple(ct.shape)}",
                max_err(ia, kp.modwpt_inv_plain(ct, w)), 1e-4)
    del ct
    ct = ia.reshape(nodes, b, r, cols).swapaxes(-1, -2).reshape(nodes, -1, r)
    del ia
    ib = kp.modwpt_inv_cuda(ct, w)
    smoke.check(f"packet inv vs plain at the quad tree's {tuple(ct.shape)}",
                max_err(ib, kp.modwpt_inv_plain(ct, w)), 1e-4)
    smoke.require("imodwpt2 = the packet kernel on these operands",
                  torch.equal(ib.reshape(b, cols, r).swapaxes(-1, -2), xpr))
    del ct, ib, xpr

    # fused against the pipeline at the same thresholds: the scalar, and
    # the fused path's own universal threshold per image (a (B,) array is
    # one threshold per image under every method)
    thr_u = estimate().float()
    for name, fused, pipe in (
            (f"threshold {IMAGE_THR}", jt.modwt2_denoise(
                x, w, lvl, method="fused", threshold=IMAGE_THR), den_p),
            ("universal threshold per image", den_f,
             jt.modwt2_denoise(x, w, lvl, threshold=thr_u))):
        err = max_err(fused, pipe)
        smoke.check(f"fused vs pipeline denoise, {name}", err, 1e-4)
        print(f"  fused vs pipeline, {name}: "
              f"{'bit-exact' if err == 0 else 'not bit-exact'}", flush=True)
    # each new kernel against its plain version at the path's shape (these
    # launches are not counted above)
    errs = {
        "modwt2_fwd": smoke.check(
            "2D fwd vs plain at the path's shape", max_err(
                c, k2.modwt2_fwd_plain(x, w, lvl)), 1e-4),
        "modwt2_inv": smoke.check(
            "2D inv vs plain at the path's shape", max_err(
                xr, k2.modwt2_inv_plain(c, w)), 1e-4),
        "modwt2_denoise": smoke.check(
            "2D denoise vs plain at the path's shape", max_err(
                k2.modwt2_denoise_cuda(x, thr_u, w, lvl),
                k2.modwt2_denoise_plain(x, thr_u, w, lvl)), 1e-4),
    }
    del xr, den_f, den_p

    print(f"== phase 17: 2D times (CUDA events, median) on {card}",
          flush=True)
    times = {}
    for shape in (IMAGE_SHAPE, IMAGE_BENCH):
        xs = x if shape == IMAGE_SHAPE else signal(*shape)
        cs = c if shape == IMAGE_SHAPE else k2.modwt2_fwd_cuda(xs, w, lvl)
        th = thr_u[:shape[0]].contiguous()
        pairs = {
            "modwt2_fwd": (xs, lambda u: k2.modwt2_fwd_cuda(u, w, lvl),
                           lambda u: k2.modwt2_fwd_plain(u, w, lvl)),
            "modwt2_inv": (cs, lambda u: k2.modwt2_inv_cuda(u, w),
                           lambda u: k2.modwt2_inv_plain(u, w)),
            "modwt2_denoise": (
                xs, lambda u: k2.modwt2_denoise_cuda(u, th, w, lvl),
                lambda u: k2.modwt2_denoise_plain(u, th, w, lvl)),
        }
        for name, (arg, kern, plain) in pairs.items():
            t = report_time(torch, name, arg, kern, plain, card,
                            samples=math.prod(shape))
            if shape == IMAGE_SHAPE:
                times[name] = t
    del c

    walls = {
        f"modwt2_denoise(method='fused'), universal threshold {IMAGE_SHAPE}":
            wall_ms(torch, lambda: jt.modwt2_denoise(x, w, lvl,
                                                     method="fused")),
        "  of which the threshold estimate": wall_ms(torch, estimate),
        "  of which the kernel": wall_ms(
            torch, lambda: k2.modwt2_denoise_cuda(x, thr_u, w, lvl)),
        f"modwt2_denoise pipeline, threshold {IMAGE_THR} {IMAGE_SHAPE}":
            wall_ms(torch, lambda: jt.modwt2_denoise(x, w, lvl,
                                                     threshold=IMAGE_THR)),
        f"modwt2_mra {MRA_SHAPE}": wall_ms(
            torch, lambda: jt.modwt2_mra(xm, w, lvl)),
        f"modwpt2 L{PACKET2_LEVEL} {IMAGE_SHAPE}": wall_ms(
            torch, lambda: jt.modwpt2(x, w, PACKET2_LEVEL)),
    }
    for name, ms in walls.items():
        print(f"  wall {name}: {ms:.3f} ms (host clock, median of 3) "
              f"[{card}]", flush=True)
    return launches, errs, times


def run_volume_cwt_slice(smoke: Smoke, torch, jt, dev, signal, card):
    """The 3D volume path and the CWT: phases 18-21.  Returns the new
    kernels' launches on their full-width calls, each new kernel's
    max-abs-err against its plain version there, (kernel ms, plain ms) per
    new kernel, and the library call's ms where there is one.  The packet
    kernels' launch counts and errors on this path are checked here; their
    entries in the kernels line stay phase 12's."""
    from jwave_pro_tpu_torch.kernels import cwt_cuda as kw
    from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
    from jwave_pro_tpu_torch.kernels import modwt3_cuda as k3
    from jwave_pro_tpu_torch.ops.cwt import _full_spectrum_multipliers

    w = jt.wavelet(WAVELET)
    lvl = VOLUME_LEVEL

    def scaled_err(a, b) -> float:
        """max |a − b| over max |b|: the CWT's bound is relative to its
        largest coefficient."""
        return float((a - b).abs().max() / b.abs().max())

    def spectra(wav, b, p, scales):
        """(xf, M, is_real): the kernel's operands for b signals of p
        samples, as ``cwt(method='fused')`` builds them."""
        m, is_real = _full_spectrum_multipliers(
            wav, tuple(float(a) for a in scales), p, 1.0)
        xf = torch.fft.fft(signal(b, p).to(torch.complex64))
        return xf, torch.from_numpy(m).to(dev, torch.complex64), is_real

    print("== phase 18: 3D and CWT kernels vs plain (small shapes, halo > "
          "volume, Haar L3 and L5, Symlet 8, bf16, both directions' depth "
          "runs; every P from 64 to 16384)", flush=True)
    for shape, lv, name in (((2, 24, 40, 33), 2, WAVELET),
                            ((1, 8, 8, 16), 2, WAVELET),
                            ((1, 5, 7, 40), 3, "Haar"),
                            ((1, 20, 24, 28), 5, "Haar"),
                            ((2, 9, 33, 70), 1, "Symlet 8")):
        wv = jt.wavelet(name)
        x = signal(*shape)
        tag = f"{shape} L{lv} {name}"
        c = k3.modwt3_fwd_cuda(x, wv, lv)
        smoke.check(f"3D fwd {tag} vs plain",
                    max_err(c, k3.modwt3_fwd_plain(x, wv, lv)), 1e-5)
        xr = k3.modwt3_inv_cuda(c, wv)
        smoke.check(f"3D inv {tag} vs plain",
                    max_err(xr, k3.modwt3_inv_plain(c, wv)), 1e-5)
        smoke.check(f"3D round trip {tag}", max_err(xr, x), 1e-4)
    # both directions' depth runs: D not a multiple of the run, D smaller
    # than the ring of (M-1)·2^(j-1) + 1 planes, a run that crosses the
    # volume's end, and a filter length without a specialised kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, lv, name in (((1, 100, 16, 32), 2, WAVELET),
                            ((2, 45, 40, 70), 2, WAVELET),
                            ((2, 9, 20, 50), 2, WAVELET),
                            ((2, 12, 20, 40), 2, "Daubechies 2")):
        wv = jt.wavelet(name)
        b, d, r, cols = shape
        halos = [k3.level_halo(wv.length, j) for j in range(1, lv + 1)]
        runs = [k3.inv3_depth_run(b, d, r, cols, h, wv.length, sms)
                for h in halos]
        fwd_runs = [k3.fwd3_depth_run(b, d, r, cols, h, wv.length, sms)
                    for h in halos]
        tag = (f"{shape} L{lv} {name}, depth runs {fwd_runs} forward, "
               f"{runs} inverse")
        smoke.require(f"3D {tag}: D off the runs or below the ring",
                      (any(d % dc for dc in runs) or d <= max(halos))
                      and (any(d % dc for dc in fwd_runs)
                           or d <= max(halos)))
        x = signal(*shape)
        c = k3.modwt3_fwd_cuda(x, wv, lv)
        smoke.check(f"3D fwd {tag} vs plain",
                    max_err(c, k3.modwt3_fwd_plain(x, wv, lv)), 1e-5)
        xr = k3.modwt3_inv_cuda(c, wv)
        smoke.check(f"3D inv {tag} vs plain",
                    max_err(xr, k3.modwt3_inv_plain(c, wv)), 1e-5)
        smoke.check(f"3D round trip {tag}", max_err(xr, x), 1e-4)
    x = signal(2, 24, 40, 33)
    ref = jt.modwt3(x.double().cpu(), w, lvl, method="direct")
    smoke.check("3D fwd (2, 24, 40, 33) L2 vs f64 host direct path",
                max_err(k3.modwt3_fwd_cuda(x, w, lvl).cpu(), ref), 1e-5)
    c32 = k3.modwt3_fwd_cuda(x, w, lvl)
    c16 = k3.modwt3_fwd_cuda(x.bfloat16(), w, lvl)
    smoke.require("bf16 3D fwd dtype", c16.dtype == torch.bfloat16)
    smoke.check("bf16 3D fwd vs f32 fwd", max_err(c16, c32), 5e-2)
    smoke.check("bf16 3D fwd vs bf16 plain",
                max_err(c16, k3.modwt3_fwd_plain(x.bfloat16(), w, lvl)),
                5e-2)
    smoke.check("bf16 3D round trip", max_err(k3.modwt3_inv_cuda(c16, w), x),
                1e-1)
    for shape, lv, name in (((1, 100, 16, 32), 2, WAVELET),
                            ((1, 20, 24, 28), 5, "Haar"),
                            ((2, 9, 33, 70), 1, "Symlet 8")):
        wv = jt.wavelet(name)
        x16 = signal(*shape).bfloat16()
        smoke.check(f"bf16 3D fwd {shape} L{lv} {name} vs bf16 plain",
                    max_err(k3.modwt3_fwd_cuda(x16, wv, lv),
                            k3.modwt3_fwd_plain(x16, wv, lv)), 5e-2)
    for p, s_count in ((64, 7), (1024, 13), (16384, 5)):
        for wav in (jt.MorletWavelet(), jt.MexicanHatWavelet()):
            xf, m, is_real = spectra(wav, 3, p, jt.generate_log_scales(
                1.0, 256.0, s_count))
            n = p - 7
            got = kw.cwt_ifft_cuda(xf, m, n, is_real)
            plain = kw.cwt_ifft_plain(xf, m, n, is_real)
            lib = torch.fft.ifft(xf[:, None, :] * m, dim=-1)[..., :n]
            lib = lib.real if is_real else lib
            tag = f"P={p} S={s_count} {wav.name}"
            kind = "float32" if is_real else "complex64"
            smoke.require(f"CWT {tag} output {kind}",
                          got.dtype == plain.dtype
                          and str(got.dtype).endswith(kind))
            smoke.check(f"CWT kernel {tag} vs plain (relative)",
                        scaled_err(got, plain), 1e-4)
            smoke.check(f"CWT kernel {tag} vs cuFFT (relative)",
                        scaled_err(got, lib), 1e-4)
    # every length the kernel takes, n < P, and 3 × 11 rows: no multiple of
    # the 2 to 32 rows a block holds below P = 4096
    for lg in range(6, 15):
        p = 1 << lg
        for wav in (jt.MorletWavelet(), jt.MexicanHatWavelet()):
            xf, m, is_real = spectra(wav, 3, p, jt.generate_log_scales(
                1.0, 256.0, 11))
            n = p - 3
            got = kw.cwt_ifft_cuda(xf, m, n, is_real)
            lib = torch.fft.ifft(xf[:, None, :] * m, dim=-1)[..., :n]
            lib = lib.real if is_real else lib
            tag = f"P={p} n={n} B·S=33 {wav.name}"
            smoke.check(f"CWT kernel {tag} vs plain (relative)",
                        scaled_err(got, kw.cwt_ifft_plain(xf, m, n, is_real)),
                        1e-4)
            smoke.check(f"CWT kernel {tag} vs cuFFT (relative)",
                        scaled_err(got, lib), 1e-4)

    print(f"== phase 19: 3D path {VOLUME_SHAPE} f32 {WAVELET} L{lvl}, "
          f"oct-tree packets {PACKET3_SHAPE} L{lvl}, MRA {MRA3_SHAPE}, "
          f"through the public API", flush=True)
    counters = ("modwt3_fwd", "modwt3_inv", "modwpt_fwd", "modwpt_inv",
                "cwt_ifft")

    def counted(what, calls, want):
        return counted_run(smoke, torch, counters, what, calls, want)

    x = signal(*VOLUME_SHAPE)
    c, got = counted("modwt3", lambda: jt.modwt3(x, w, lvl),
                     {"modwt3_fwd": 1})
    launches = {"modwt3_fwd": got["modwt3_fwd"]}
    xr, got = counted("imodwt3", lambda: jt.imodwt3(c, w), {"modwt3_inv": 1})
    launches["modwt3_inv"] = got["modwt3_inv"]
    den_u, _ = counted("modwt3_denoise, universal threshold",
                       lambda: jt.modwt3_denoise(x, w, lvl),
                       {"modwt3_fwd": 1, "modwt3_inv": 1})
    den_t, _ = counted(f"modwt3_denoise, threshold {IMAGE_THR}",
                       lambda: jt.modwt3_denoise(x, w, lvl,
                                                 threshold=IMAGE_THR),
                       {"modwt3_fwd": 1, "modwt3_inv": 1})
    vol = signal(*PACKET3_SHAPE)
    p3, _ = counted("modwpt3", lambda: jt.modwpt3(vol, w, lvl),
                    {"modwpt_fwd": 3})
    vr, _ = counted("imodwpt3", lambda: jt.imodwpt3(p3, w),
                    {"modwpt_inv": 3})
    xm = signal(*MRA3_SHAPE)
    mra, _ = counted("the 3D MRA", lambda: jt.modwt3_mra(xm, w, lvl),
                     {"modwt3_fwd": 1, "modwt3_inv": 7 * lvl + 1})
    nodes = 1 << lvl
    for name, t, shape in (
            ("3D coeffs", c, (7 * lvl + 1,) + VOLUME_SHAPE),
            ("3D reconstruction", xr, VOLUME_SHAPE),
            ("3D denoise, universal", den_u, VOLUME_SHAPE),
            (f"3D denoise, {IMAGE_THR}", den_t, VOLUME_SHAPE),
            ("oct-tree packets", p3, (nodes,) * 3 + PACKET3_SHAPE),
            ("oct-tree reconstruction", vr, PACKET3_SHAPE),
            ("3D MRA", mra, (7 * lvl + 1,) + MRA3_SHAPE)):
        smoke.require(f"{name} shape {shape} and finite",
                      tuple(t.shape) == shape
                      and bool(torch.isfinite(t).all()))
    smoke.check("3D round trip at full width", max_err(xr, x), 1e-4)
    smoke.check("oct-tree packet round trip", max_err(vr, vol), 1e-4)
    smoke.check("3D MRA sums to the volume", max_err(mra.sum(0), xm), 1e-4)
    smoke.check("oct-tree node (0, 0, 0) = the 3D MODWT's LLL",
                max_err(p3[0, 0, 0], jt.modwt3(vol, w, lvl)[-1]), 1e-5)
    del mra, vr
    # the denoise against the plain versions' chain on the first volume
    # (its universal threshold is its own: one per volume)
    c0 = k3.modwt3_fwd_plain(x[:1], w, lvl)
    sig = jt.mad_sigma(c0[6].flatten(-3)) * math.sqrt(
        2.0 * math.log(math.prod(VOLUME_SHAPE[1:])))
    shr = jt.soft_threshold(c0[:7 * lvl], sig[:, None, None, None])
    ref = k3.modwt3_inv_plain(torch.cat([shr, c0[7 * lvl:]]), w)
    smoke.check("3D denoise (universal) vs the plain chain, volume 0",
                max_err(den_u[:1], ref), 1e-4)
    del c0, shr, ref, den_u, den_t
    # each new kernel against its plain version at the path's shape (these
    # launches are not counted above)
    errs = {
        "modwt3_fwd": smoke.check("3D fwd vs plain at the path's shape",
                                  max_err(c, k3.modwt3_fwd_plain(x, w, lvl)),
                                  1e-5),
        "modwt3_inv": smoke.check("3D inv vs plain at the path's shape",
                                  max_err(xr, k3.modwt3_inv_plain(c, w)),
                                  1e-5),
    }
    del xr
    # the packet kernels against their plain versions on modwpt3's own
    # operands: forward over depth (R·C, D), rows (P·D·C, R), columns
    # (P·P·D·R, C); inverse over the same in reverse
    _, d, r, cols = PACKET3_SHAPE
    xt = vol.movedim(-3, -1).reshape(-1, d).contiguous()
    fa = kp.modwpt_fwd_cuda(xt, w, lvl)
    smoke.check(f"packet fwd vs plain at the oct tree's {tuple(xt.shape)}",
                max_err(fa, kp.modwpt_fwd_plain(xt, w, lvl)), 1e-5)
    xt = (fa.reshape(nodes, 1, r, cols, d).movedim(-1, -3)
          .swapaxes(-1, -2).reshape(-1, r).contiguous())
    del fa
    fb = kp.modwpt_fwd_cuda(xt, w, lvl)
    smoke.check(f"packet fwd vs plain at the oct tree's {tuple(xt.shape)}",
                max_err(fb, kp.modwpt_fwd_plain(xt, w, lvl)), 1e-5)
    xt = fb.reshape(nodes, nodes, 1, d, cols, r).swapaxes(-1, -2).reshape(
        -1, cols).contiguous()
    del fb
    fc = kp.modwpt_fwd_cuda(xt, w, lvl)
    smoke.check(f"packet fwd vs plain at the oct tree's {tuple(xt.shape)}",
                max_err(fc, kp.modwpt_fwd_plain(xt, w, lvl)), 1e-5)
    smoke.require("modwpt3 = the packet kernel on these operands",
                  torch.equal(fc.reshape((nodes,) * 3 + PACKET3_SHAPE)
                              .permute(2, 1, 0, 3, 4, 5, 6), p3))
    del xt, fc
    ct = p3.permute(2, 1, 0, 3, 4, 5, 6).reshape(nodes, -1,
                                                 cols).contiguous()
    ia = kp.modwpt_inv_cuda(ct, w)
    smoke.check(f"packet inv vs plain at the oct tree's {tuple(ct.shape)}",
                max_err(ia, kp.modwpt_inv_plain(ct, w)), 1e-4)
    ct = ia.reshape(nodes, nodes, 1, d, r, cols).swapaxes(-1, -2).reshape(
        nodes, -1, r).contiguous()
    del ia
    ib = kp.modwpt_inv_cuda(ct, w)
    smoke.check(f"packet inv vs plain at the oct tree's {tuple(ct.shape)}",
                max_err(ib, kp.modwpt_inv_plain(ct, w)), 1e-4)
    ct = ib.reshape(nodes, 1, d, cols, r).swapaxes(-1, -2).movedim(
        -3, -1).reshape(nodes, -1, d).contiguous()
    del ib
    ic = kp.modwpt_inv_cuda(ct, w)
    smoke.check(f"packet inv vs plain at the oct tree's {tuple(ct.shape)}",
                max_err(ic, kp.modwpt_inv_plain(ct, w)), 1e-4)
    del ct, ic, p3

    print(f"== phase 20: CWT {CWT_SHAPE} f32, {CWT_SCALES} log scales, "
          f"Morlet and Mexican Hat, through the public API", flush=True)
    scales = jt.generate_log_scales(1.0, 256.0, CWT_SCALES)
    xs = signal(*CWT_SHAPE)
    cb, cp = CWT_SHAPE
    for wav, dtype in ((jt.MorletWavelet(), torch.complex64),
                       (jt.MexicanHatWavelet(), torch.float32)):
        res, got = counted(f"cwt(method='fused'), {wav.name}",
                           lambda: jt.cwt(xs, scales, wav, method="fused"),
                           {"cwt_ifft": 1})
        if dtype == torch.complex64:
            launches["cwt_ifft"] = got["cwt_ifft"]
        cf = res.coefficients
        smoke.require(f"CWT {wav.name} coefficients {dtype}, shape and "
                      f"finite", cf.dtype == dtype and tuple(cf.shape) == (
                          cb, CWT_SCALES, cp) and bool(torch.isfinite(
                              cf).all()))
        fft = jt.cwt(xs, scales, wav, method="fft").coefficients
        smoke.check(f"CWT {wav.name} fused vs the 'fft' path (relative)",
                    scaled_err(cf, fft), 1e-4)
        # concrete tensor scales are static scales: the same kernel launch
        res_t, _ = counted(
            f"cwt(method='fused'), {wav.name}, tensor scales",
            lambda: jt.cwt(xs, torch.tensor(scales, device=dev), wav,
                           method="fused"), {"cwt_ifft": 1})
        smoke.require(f"CWT {wav.name} with tensor scales = the list-scales "
                      f"call (dtype, values bitwise)",
                      torch.equal(res_t.coefficients, cf))
        del res, res_t, cf, fft
    wav = jt.MorletWavelet()
    xf, m, is_real = spectra(wav, cb, cp, scales)
    got = kw.cwt_ifft_cuda(xf, m, cp, is_real)
    lib = torch.fft.ifft(xf[:, None, :] * m, dim=-1)
    errs["cwt_ifft"] = smoke.check(
        "CWT kernel vs plain at the path's shape (relative)",
        scaled_err(got, kw.cwt_ifft_plain(xf, m, cp, is_real)), 1e-4)
    smoke.check("CWT kernel vs cuFFT at the path's shape (relative)",
                scaled_err(got, lib), 1e-4)
    del got, lib

    print(f"== phase 21: 3D and CWT times (CUDA events, median) on {card}",
          flush=True)
    times, library = {}, {}
    for shape in (VOLUME_SHAPE,) + VOLUME_BENCH:
        xv = x if shape == VOLUME_SHAPE else signal(*shape)
        cv = c if shape == VOLUME_SHAPE else k3.modwt3_fwd_cuda(xv, w, lvl)
        for name, arg, kern, plain in (
                ("modwt3_fwd", xv, lambda u: k3.modwt3_fwd_cuda(u, w, lvl),
                 lambda u: k3.modwt3_fwd_plain(u, w, lvl)),
                ("modwt3_inv", cv, lambda u: k3.modwt3_inv_cuda(u, w),
                 lambda u: k3.modwt3_inv_plain(u, w))):
            t = report_time(torch, name, arg, kern, plain, card,
                            samples=math.prod(shape))
            if shape == VOLUME_SHAPE:
                times[name] = t
        del cv
    del c
    for shape in (CWT_SHAPE, CWT_BENCH):
        for wav in (jt.MorletWavelet(), jt.MexicanHatWavelet()):
            sb, sp = shape
            xf, m, is_real = spectra(wav, sb, sp, scales)
            name = f"cwt_ifft {wav.name}"
            t = report_time(
                torch, name, xf, lambda u: kw.cwt_ifft_cuda(u, m, sp, is_real),
                lambda u: kw.cwt_ifft_plain(u, m, sp, is_real), card,
                samples=sb * sp)
            t_lib = event_time(torch, lambda u: torch.fft.ifft(
                u[:, None, :] * m, dim=-1)[..., :sp], xf) * 1e3
            print(f"  {name} {shape} S={CWT_SCALES}: library call "
                  f"torch.fft.ifft {t_lib:.4f} ms [{card}]", flush=True)
            if shape == CWT_SHAPE and not is_real:
                times["cwt_ifft"], library["cwt_ifft"] = t, t_lib
    wav = jt.MorletWavelet()
    walls = {
        f"modwt3_denoise {VOLUME_SHAPE}, universal threshold": wall_ms(
            torch, lambda: jt.modwt3_denoise(x, w, lvl)),
        f"modwpt3 {PACKET3_SHAPE} L{lvl}": wall_ms(
            torch, lambda: jt.modwpt3(vol, w, lvl)),
        f"cwt(method='fused') {CWT_SHAPE} Morlet": wall_ms(
            torch, lambda: jt.cwt(xs, scales, wav, method="fused")),
        f"cwt(method='fft') {CWT_SHAPE} Morlet": wall_ms(
            torch, lambda: jt.cwt(xs, scales, wav, method="fft")),
        f"cwt() {CWT_SHAPE} Morlet, the default": wall_ms(
            torch, lambda: jt.cwt(xs, scales, wav)),
    }
    for name, ms in walls.items():
        print(f"  wall {name}: {ms:.3f} ms (host clock, median of 3) "
              f"[{card}]", flush=True)
    return launches, errs, times, library


def all_launchers() -> tuple:
    """Every kernel operator, by the name its launches count under."""
    return ("modwt_fwd", "modwt_fwd_ctx", "modwt_inv", "modwt_inv_shrink",
            "modwt_denoise", "modwt_var", "modwpt_fwd", "modwpt_select", "modwpt_inv",
            "modwt2_fwd", "modwt2_inv", "modwt2_inv_shrink", "modwt2_denoise",
            "modwt3_fwd", "modwt3_inv", "cwt_ifft")


def op_flops(call) -> int:
    """The operations ``call`` runs in products and FFTs.  The products are
    counted by wrapping the port's one product helper (``ops/fwt.py:_mm``,
    which ``ops/wpt.py``, ``fft.py``, ``cwt.py``, ``cwt_banded.py`` and
    ``financial.py`` import): 2 a real multiply-add, 8 a complex one.  Each FFT of length n
    counts 5·n·log₂n, a real-input or real-output one 2.5·n·log₂n, a 2D
    one of n = H·W points likewise (the ``torch.fft`` calls wrapped the
    same way).  At power-of-two widths the
    decimated transforms run no other form."""
    import importlib

    import torch

    mods = [importlib.import_module(f"jwave_pro_tpu_torch.ops.{m}")
            for m in ("fwt", "wpt", "fft", "cwt", "cwt_banded",
                      "financial")]
    orig = mods[0]._mm
    total = 0

    def counting(u, m, tf32=False):
        nonlocal total
        out = orig(u, m, tf32)
        total += (8 if out.is_complex() else 2) * out.numel() * u.shape[-1]
        return out

    def fft_counting(fn, per_point, real_in):
        def wrapped(inp, n=None, dim=-1, norm=None):
            nonlocal total
            out = fn(inp, n=n, dim=dim, norm=norm)
            length = (n or inp.shape[dim]) if real_in else out.shape[dim]
            rows = out.numel() // out.shape[dim]
            total += int(per_point * length * math.log2(max(length, 2))
                         * rows)
            return out
        return wrapped

    def fft2_counting(fn, per_point, real_in):
        def wrapped(inp, s=None, dim=(-2, -1), norm=None):
            nonlocal total
            out = fn(inp, s=s, dim=dim, norm=norm)
            grid = (inp if real_in else out).shape[-2:]
            if s is not None and not real_in:
                grid = s
            length = grid[0] * grid[1]
            rows = out.numel() // (out.shape[-2] * out.shape[-1])
            total += int(per_point * length * math.log2(max(length, 2))
                         * rows)
            return out
        return wrapped

    ffts = {"fft": (5.0, False), "ifft": (5.0, False),
            "rfft": (2.5, True), "irfft": (2.5, False)}
    ffts2 = {"fft2": (5.0, False), "ifft2": (5.0, False),
             "rfft2": (2.5, True), "irfft2": (2.5, False)}
    saved = {name: getattr(torch.fft, name) for name in (*ffts, *ffts2)}
    for mod in mods:
        mod._mm = counting
    for name, (per_point, real_in) in ffts.items():
        setattr(torch.fft, name, fft_counting(saved[name], per_point,
                                              real_in))
    for name, (per_point, real_in) in ffts2.items():
        setattr(torch.fft, name, fft2_counting(saved[name], per_point,
                                               real_in))
    try:
        call()
    finally:
        for mod in mods:
            mod._mm = orig
        for name, fn in saved.items():
            setattr(torch.fft, name, fn)
    return total


def tensor_bytes(obj) -> int:
    """The bytes of every tensor in ``obj`` (a tensor, or a tuple or list
    of them, nested)."""
    if hasattr(obj, "nbytes") and hasattr(obj, "is_cuda"):
        return obj.nbytes
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(o) for o in obj)
    return 0


def host64(t):
    """``t`` on the host in float64 (complex128 if complex)."""
    import torch

    t = t.detach().cpu()
    return t.to(torch.complex128) if t.is_complex() else t.double()


def rel_to(smoke: Smoke, name: str, got, want, tol: float) -> float:
    """max|got − want| ≤ tol × max|want| (both on the host, in f64)."""
    got, want = host64(got), host64(want)
    scale = float(want.abs().max())
    return smoke.check(f"{name} (relative to max|ref| {scale:.3g})",
                       float((got - want).abs().max()) / scale, tol)


def basis_cost(jt, tree, masks, n: int, per_sample: bool):
    """The SURE cost of the basis ``masks`` selects, on the f64 ``tree``
    (the additive cost ``wpt_denoise`` selects by)."""
    total = 0.0
    for l, m in enumerate(masks):
        row = tree[l].reshape(tree.shape[1:-1] + (1 << l, n >> l))
        c = jt.ops.sure_cost(row)
        c = c if per_sample else c.sum(dim=tuple(range(c.ndim - 1)))
        total = total + (c * m.double().cpu()).sum()
    return float(total)


def run_decimated_slice(smoke: Smoke, torch, jt, signal, card) -> None:
    """The decimated path through the public API at bench.py's shapes
    (phases 22-23): fwt/ifwt, fwt2/ifwt2, fwt3/ifwt3, wpt/iwpt, the
    best-basis denoise and wavedec/waverec, float32 on the card.  Each
    call is held to the port's own CPU float64 result on its first two
    rows (images, volumes), timed, and put beside the bound of its matmul
    form.  It reaches none of the 14 kernels (nor, in JAX, any Pallas
    kernel): cuBLAS runs its banded matmuls."""
    import importlib

    fwt_mod = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")
    t_phase = time.perf_counter()
    w, ws = jt.wavelet(WAVELET), jt.wavelet(WPT_WAVELET)
    b, n = MAIN_SHAPE
    x = signal(*MAIN_SHAPE)
    img = signal(*DEC_IMAGE)
    vol = signal(*DEC_VOLUME)
    xw = signal(*WPT_SHAPE)
    xd = signal(*WPT_DENOISE_SHAPE)
    lv3 = DEC_VOLUME_LEVELS

    def host(t, rows=2):
        return t[:rows].double().cpu()

    print(f"== phase 22: the decimated path through the public API, f32, "
          f"against the port's CPU f64 result on the first two rows",
          flush=True)
    y = jt.fwt(x, w)
    rel_to(smoke, f"fwt {MAIN_SHAPE} {WAVELET} default level",
           host(y), jt.fwt(host(x), w), 1e-5)
    y5 = jt.fwt(x, w, LEVEL)
    rel_to(smoke, f"fwt {MAIN_SHAPE} L{LEVEL}", host(y5),
           jt.fwt(host(x), w, LEVEL), 1e-5)
    rel_to(smoke, f"ifwt(fwt) {MAIN_SHAPE} L{LEVEL} round trip",
           jt.ifwt(y5, w, LEVEL), x, 1e-4)
    y2 = jt.fwt2(img, w)
    rel_to(smoke, f"fwt2 {DEC_IMAGE}", host(y2), jt.fwt2(host(img), w),
           1e-5)
    rel_to(smoke, f"ifwt2(fwt2) {DEC_IMAGE} round trip", jt.ifwt2(y2, w),
           img, 1e-4)
    y3 = jt.fwt3(vol, w, lv3)
    rel_to(smoke, f"fwt3 {DEC_VOLUME} levels {lv3}", host(y3),
           jt.fwt3(host(vol), w, lv3), 1e-5)
    rel_to(smoke, f"ifwt3(fwt3) {DEC_VOLUME} round trip",
           jt.ifwt3(y3, w, lv3), vol, 1e-4)
    yw = jt.wpt(xw, ws, WPT_LEVEL)
    rel_to(smoke, f"wpt {WPT_SHAPE} {WPT_WAVELET} L{WPT_LEVEL}", host(yw),
           jt.wpt(host(xw), ws, WPT_LEVEL), 1e-5)
    rel_to(smoke, f"iwpt(wpt) {WPT_SHAPE} round trip",
           jt.iwpt(yw, ws, WPT_LEVEL), xw, 1e-4)
    cs = jt.wavedec(x, w, LEVEL)
    for got, want in zip(cs, jt.wavedec(host(x), w, LEVEL)):
        rel_to(smoke, f"wavedec {MAIN_SHAPE} L{LEVEL} band "
               f"{tuple(got.shape)}", host(got), want, 1e-5)
    rel_to(smoke, f"waverec(wavedec) {MAIN_SHAPE} round trip",
           jt.waverec(cs, w), x, 1e-4)
    del y, y5, y2, y3, yw, cs

    # the best-basis denoise (hard, as bench.py:161): the masks as the CPU
    # f64 run selects them on the same input (or, where a cost ties within
    # f32 rounding, the place where they part); the output within f32
    # noise plus what the hard-threshold decisions that flip between f32
    # and f64 can move (an orthonormal synthesis moves the output by at
    # most the L1 norm of the flipped coefficients)
    nd = WPT_DENOISE_SHAPE[1]
    for per_sample in (False, True):
        tag = f"wpt_denoise {WPT_DENOISE_SHAPE} per_sample={per_sample}"
        masks, _, tree = jt.best_basis(xd, ws, WPT_LEVEL, "sure",
                                       per_sample=per_sample)
        xd64 = xd.double().cpu()
        masks64, _, tree64 = jt.best_basis(xd64, ws, WPT_LEVEL, "sure",
                                           per_sample=per_sample)
        parts = [(l, int(torch.nonzero(m.cpu() != m64)[0][-1]))
                 for l, (m, m64) in enumerate(zip(masks, masks64))
                 if not torch.equal(m.cpu(), m64)]
        if parts:
            c_card = basis_cost(jt, tree64, masks, nd, per_sample)
            c_ref = basis_cost(jt, tree64, masks64, nd, per_sample)
            print(f"  {tag}: masks part at (level, node) {parts[0]}; SURE "
                  f"of the card's basis {c_card!r}, of the f64 basis "
                  f"{c_ref!r}", flush=True)
            smoke.require(f"{tag}: the bases' costs tie within f32 "
                          f"rounding", abs(c_card - c_ref)
                          <= 1e-5 * abs(c_ref))
        else:
            smoke.require(f"{tag}: masks equal the CPU f64 masks", True)
        got = jt.wpt_denoise(xd, ws, WPT_LEVEL, mode="hard",
                             per_sample=per_sample)
        want = jt.wpt_denoise(xd64, ws, WPT_LEVEL, mode="hard",
                              per_sample=per_sample)
        flat = jt.basis_coefficients(tree, masks).double().cpu()
        flat64 = jt.basis_coefficients(tree64, masks64)
        t = jt.universal_threshold(tree[1][..., nd // 2:], nd)
        t64 = jt.universal_threshold(tree64[1][..., nd // 2:], nd)
        flips = ((flat.abs() > t.double().cpu()[..., None])
                 != (flat64.abs() > t64[..., None]))
        slack = float(flat64.abs()[flips].sum())
        scale = float(xd64.abs().max())
        print(f"  {tag}: {int(flips.sum())} hard-threshold decisions flip "
              f"between f32 and f64 (L1 {slack:.3g})", flush=True)
        smoke.require(f"{tag} shape and finite",
                      tuple(got.shape) == WPT_DENOISE_SHAPE
                      and bool(torch.isfinite(got).all()))
        smoke.check(f"{tag} vs CPU f64 (bound 1e-4 max|x| + flips)",
                    max_err(got.cpu(), want), 1e-4 * scale + slack)
        del masks, tree, masks64, tree64, got, want
    # bf16 in, bf16 out, constants rounded to bf16
    xb = x.to(torch.bfloat16)
    yb = jt.fwt(xb, w, LEVEL)
    smoke.require("bf16 fwt returns bf16", yb.dtype == torch.bfloat16)
    rel_to(smoke, f"bf16 fwt {MAIN_SHAPE} L{LEVEL}", host(yb),
           jt.fwt(host(xb), w, LEVEL), 5e-2)
    rel_to(smoke, f"bf16 ifwt(fwt) {MAIN_SHAPE} round trip",
           jt.ifwt(yb, w, LEVEL), xb, 5e-2)
    del xb, yb
    # with the process set to TF32 (through either of torch's settings),
    # the port's products stay IEEE float32
    ref = jt.fwt(host(x), w, LEVEL)
    settings = [("matmul precision 'high'",
                 lambda: torch.set_float32_matmul_precision("high"))]
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        settings.append(("per-backend fp32_precision 'tf32'", lambda: setattr(
            torch.backends.cuda.matmul, "fp32_precision", "tf32")))
    for what, turn_on in settings:
        try:
            turn_on()
            y_tf32 = jt.fwt(x, w, LEVEL)
            if what.startswith("matmul"):
                xr = x[:2].reshape(-1, 256)
                wm = torch.from_numpy(fwt_mod._analysis_matrix_fused(
                    (w,) * LEVEL)[:256]).to(x.device, torch.float32)
                with fwt_mod._f32_products():
                    pinned = xr @ wm
                print(f"  an unpinned product under TF32 errs by "
                      f"{max_err(xr @ wm, pinned):.3e} (the pinned one's "
                      f"yardstick)", flush=True)
        finally:
            torch.set_float32_matmul_precision("highest")
        rel_to(smoke, f"fwt {MAIN_SHAPE} L{LEVEL} under {what}",
               host(y_tf32), ref, 1e-5)
        del y_tf32

    print(f"== phase 23: decimated walls and bounds on {card}", flush=True)
    y5 = jt.fwt(x, w, LEVEL)
    y2, y3, yw = jt.fwt2(img, w), jt.fwt3(vol, w, lv3), jt.wpt(xw, ws,
                                                                WPT_LEVEL)
    cs = jt.wavedec(x, w, LEVEL)
    calls = [
        (f"fwt {MAIN_SHAPE} default level", lambda: jt.fwt(x, w), x.numel()),
        (f"fwt {MAIN_SHAPE} L{LEVEL}", lambda: jt.fwt(x, w, LEVEL),
         x.numel()),
        (f"ifwt {MAIN_SHAPE} L{LEVEL}", lambda: jt.ifwt(y5, w, LEVEL),
         x.numel()),
        (f"fwt2 {DEC_IMAGE}", lambda: jt.fwt2(img, w), img.numel()),
        (f"ifwt2 {DEC_IMAGE}", lambda: jt.ifwt2(y2, w), img.numel()),
        (f"fwt3 {DEC_VOLUME} {lv3}", lambda: jt.fwt3(vol, w, lv3),
         vol.numel()),
        (f"ifwt3 {DEC_VOLUME} {lv3}", lambda: jt.ifwt3(y3, w, lv3),
         vol.numel()),
        (f"wpt {WPT_SHAPE} {WPT_WAVELET} L{WPT_LEVEL}",
         lambda: jt.wpt(xw, ws, WPT_LEVEL), xw.numel()),
        (f"iwpt {WPT_SHAPE} L{WPT_LEVEL}",
         lambda: jt.iwpt(yw, ws, WPT_LEVEL), xw.numel()),
        (f"wpt_denoise {WPT_DENOISE_SHAPE} hard",
         lambda: jt.wpt_denoise(xd, ws, WPT_LEVEL, mode="hard"),
         xd.numel()),
        (f"wpt_denoise {WPT_DENOISE_SHAPE} hard per_sample",
         lambda: jt.wpt_denoise(xd, ws, WPT_LEVEL, mode="hard",
                                per_sample=True), xd.numel()),
        (f"wavedec {MAIN_SHAPE} L{LEVEL}", lambda: jt.wavedec(x, w, LEVEL),
         x.numel()),
        (f"waverec {MAIN_SHAPE} L{LEVEL}", lambda: jt.waverec(cs, w),
         x.numel()),
    ]
    counted_run(smoke, torch, all_launchers(), "the decimated path",
                lambda: [call() for _, call, _ in calls], {})
    for name, call, cells in calls:
        wall = wall_ms(torch, call)
        flops = op_flops(call)
        # each input read once, each output written once (f32)
        t_bound, by = bound(8 * cells, flops)
        print(f"  decimated {name}: wall {wall:.3f} ms (host clock, median "
              f"of 3); matmul flops {flops:.4e}, bytes {8 * cells:.4e}, "
              f"bound {t_bound:.4f} ms by {by} ({t_bound / wall:.1%} of the "
              f"wall) [{card}]", flush=True)
    for name, call, arg in (
            (f"fwt {MAIN_SHAPE} L{LEVEL}", lambda v: jt.fwt(v, w, LEVEL), x),
            (f"ifwt {MAIN_SHAPE} L{LEVEL}", lambda v: jt.ifwt(v, w, LEVEL),
             y5),
            (f"wpt {WPT_SHAPE} L{WPT_LEVEL}",
             lambda v: jt.wpt(v, ws, WPT_LEVEL), xw)):
        ms = event_time(torch, call, arg, k=5, repeats=3) * 1e3
        print(f"  decimated {name}: {ms:.4f} ms a call between CUDA events "
              f"(5 calls a run, median of 3) [{card}]", flush=True)
    print(f"  decimated phases took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def compress_check(smoke: Smoke, name: str, got, want, c64, thr: float):
    """A compressor's output against the f64 one: equal within f32 noise
    where both make the same keep/zero decision, and every decision that
    differs made on a coefficient within f32 noise of the threshold."""
    g, wv = host64(got), host64(want)
    flips = (g == 0) != (wv == 0)
    scale = float(c64.abs().max())
    nflip = int(flips.sum())
    err = float((g - wv).abs()[~flips].max()) / scale
    near = (float((c64.abs()[flips] - thr).abs().max()) / scale
            if nflip else 0.0)
    print(f"  {name}: {nflip} keep/zero decisions differ from f64 (the "
          f"farthest {near:.3e} of max|c| from the threshold)", flush=True)
    smoke.check(f"{name} vs CPU f64 where the decisions agree (relative)",
                err, 1e-5)
    smoke.check(f"{name}: differing decisions lie at the threshold "
                f"(relative)", near, 1e-5)
    return nflip


def run_continuous_slice(smoke: Smoke, torch, jt, signal, card) -> None:
    """The decimated satellites and the first continuous slice through the
    public API (phases 24-25): the lifting pyramids, compressors,
    arbitrary-length wrappers, the DTCWT in 1D and 2D with its denoisers,
    the FFT and DFT, the banded CWT under its three tiers beside the 'fft'
    path, the direct CWT, the inverse CWT, the Hilbert tools and the
    wavelet coherence, float32 on the card at bench.py's shapes.  Each call
    is held to the port's own CPU float64 result on its first two rows,
    timed, and put beside its bound.  Only the coherence reaches a kernel
    of the package, the CWT's (#14) once for each of its two default
    transforms; the rest is cuBLAS products, cuFFT and elementwise
    torch."""
    t_phase = time.perf_counter()
    w, haar = jt.wavelet(WAVELET), jt.wavelet("Haar")
    b, n = MAIN_SHAPE
    x = signal(*MAIN_SHAPE)
    xh = host64(x[:2])
    cb, cn = CWT_BENCH
    scales = jt.generate_log_scales(1.0, 256.0, CWT_SCALES)
    direct_scales = jt.generate_log_scales(1.0, 64.0, DIRECT_SCALES)
    morlet, mexhat, dog1 = (jt.MorletWavelet(), jt.MexicanHatWavelet(),
                            jt.DOGWavelet(1))

    def host(t, rows=2):
        return host64(t[:rows])

    print(f"== phase 24: lifting, compression, AED/SWT, DTCWT, FFT, the "
          f"banded, direct and inverse CWT, Hilbert tools and coherence, "
          f"f32, against the port's CPU f64 result on the first two rows",
          flush=True)
    for fwd, inv in ((jt.cdf97, jt.icdf97), (jt.cdf53, jt.icdf53)):
        y = fwd(x)
        rel_to(smoke, f"{fwd.__name__} {MAIN_SHAPE} full depth", host(y),
               fwd(xh), 1e-5)
        rel_to(smoke, f"{inv.__name__}({fwd.__name__}) {MAIN_SHAPE} round "
               f"trip", inv(y), x, 1e-4)
        del y

    c = jt.fwt(x, w, LEVEL)
    c64 = jt.fwt(host64(x), w, LEVEL)
    for fn, thr in ((jt.compress_magnitude, float(c64.abs().mean())),
                    (jt.compress_peaks_average, 0.5 * float(
                        c64.abs().max()))):
        got, want = fn(c), fn(c64)
        tag = f"{fn.__name__} of fwt {MAIN_SHAPE} L{LEVEL}"
        nflip = compress_check(smoke, tag, got, want, c64, thr)
        rate, rate64 = jt.compression_rate(got), jt.compression_rate(want)
        smoke.require(f"compression_rate of {tag} float32",
                      rate.dtype == torch.float32)
        smoke.check(f"compression_rate of {tag} vs f64 (percent, bound "
                    f"1e-4 + the differing decisions' share)",
                    abs(float(rate) - float(rate64)),
                    1e-4 + 100.0 * nflip / c.numel())
        del got, want
    del c, c64

    xa = signal(*AED_SHAPE)
    ya = jt.aed_forward(xa, w)
    rel_to(smoke, f"aed_forward {AED_SHAPE} {WAVELET}", host(ya),
           jt.aed_forward(host(xa), w), 1e-5)
    rel_to(smoke, f"aed_inverse(aed_forward) {AED_SHAPE} round trip",
           jt.aed_inverse(ya, w), xa, 1e-4)
    del ya
    xo = signal(*SWT_ODD)
    for xs_ in (x, xo):
        shape = tuple(xs_.shape)
        ys = jt.swt_forward(xs_, haar)
        rel_to(smoke, f"swt_forward {shape} Haar", host(ys),
               jt.swt_forward(host(xs_), haar), 1e-5)
        rel_to(smoke, f"swt_inverse(swt_forward) {shape} round trip",
               jt.swt_inverse(ys, haar), xs_, 1e-4)
        del ys

    r = jt.dtcwt(x, LEVEL)
    r64 = jt.dtcwt(xh, LEVEL)
    smoke.require(f"dtcwt {MAIN_SHAPE} L{LEVEL}: complex64 highpass, "
                  f"float32 lowpass", r.highpass[0].dtype == torch.complex64
                  and r.lowpass_a.dtype == torch.float32)
    for j, (g, want) in enumerate(zip(r.highpass, r64.highpass), start=1):
        rel_to(smoke, f"dtcwt {MAIN_SHAPE} L{LEVEL} highpass level {j}",
               host(g), want, 1e-5)
    rel_to(smoke, f"dtcwt {MAIN_SHAPE} lowpass a", host(r.lowpass_a),
           r64.lowpass_a, 1e-5)
    rel_to(smoke, f"dtcwt {MAIN_SHAPE} lowpass b", host(r.lowpass_b),
           r64.lowpass_b, 1e-5)
    rel_to(smoke, f"idtcwt(dtcwt) {MAIN_SHAPE} round trip", jt.idtcwt(r),
           x, 1e-4)
    del r, r64
    rel_to(smoke, f"dtcwt_denoise {MAIN_SHAPE} L{LEVEL} soft",
           host(jt.dtcwt_denoise(x, LEVEL)), jt.dtcwt_denoise(xh, LEVEL),
           1e-4)
    img = signal(*DTCWT2_SHAPE)
    img64 = host(img)
    r2 = jt.dtcwt2(img, DTCWT2_LEVEL)
    r264 = jt.dtcwt2(img64, DTCWT2_LEVEL)
    for j, (g, want) in enumerate(zip(r2.highpass, r264.highpass), start=1):
        rel_to(smoke, f"dtcwt2 {DTCWT2_SHAPE} L{DTCWT2_LEVEL} level {j}",
               host(g), want, 1e-5)
    rel_to(smoke, f"dtcwt2 {DTCWT2_SHAPE} lowpass", host(r2.lowpass),
           r264.lowpass, 1e-5)
    rel_to(smoke, f"idtcwt2(dtcwt2) {DTCWT2_SHAPE} round trip",
           jt.idtcwt2(r2), img, 1e-4)
    del r2, r264
    rel_to(smoke, f"dtcwt2_denoise {DTCWT2_SHAPE} L{DTCWT2_LEVEL} soft",
           host(jt.dtcwt2_denoise(img, DTCWT2_LEVEL)),
           jt.dtcwt2_denoise(img64, DTCWT2_LEVEL), 1e-4)

    xf = jt.fft(x)
    rel_to(smoke, f"fft {MAIN_SHAPE}", host(xf), jt.fft(xh), 1e-5)
    rel_to(smoke, f"ifft {MAIN_SHAPE}", host(jt.ifft(xf)),
           jt.ifft(host(xf)), 1e-5)
    del xf
    xd = signal(*DFT_SHAPE)
    yd = jt.dft(xd)
    rel_to(smoke, f"dft {DFT_SHAPE} (pinned complex product)", host(yd),
           jt.dft(host(xd)), 1e-5)
    rel_to(smoke, f"idft {DFT_SHAPE}", host(jt.idft(yd)),
           jt.idft(host(yd)), 1e-5)
    rel_to(smoke, f"dft {DFT_SHAPE} vs fft", yd, jt.fft(xd), 1e-5)
    del yd

    xc = signal(*CWT_BENCH)
    xc64 = host(xc)
    xl = signal(*CWT_SHAPE)
    banded = [(f"Morlet {CWT_BENCH}", xc, xc64, morlet, None, 2e-5, 0.0),
              (f"Morlet {CWT_BENCH}", xc, xc64, morlet, "high", 1e-3, 1e-6),
              (f"Morlet {CWT_BENCH}", xc, xc64, morlet, "default", 2e-2,
               0.0),
              (f"Mexican Hat {CWT_BENCH}", xc, xc64, mexhat, None, 2e-5,
               0.0),
              (f"DOG 1 {CWT_BENCH}", xc, xc64, dog1, None, 2e-5, 0.0),
              (f"Morlet {CWT_SHAPE}", xl, host(xl), morlet, None, 2e-5,
               0.0)]
    for tag, xs_, x64, wav, tier, tol, atol in banded:
        got = jt.cwt(xs_, scales, wav, method="banded",
                     precision=tier).coefficients
        want = jt.cwt(x64, scales, wav, method="banded").coefficients
        err = float((host(got) - want).abs().max())
        scale = float(want.abs().max())
        smoke.check(f"cwt banded {tag} S={CWT_SCALES} precision={tier} vs "
                    f"CPU f64 (relative; bound {tol:g} + {atol:g}/max|ref|)",
                    err / scale, tol + atol / scale)
        fft = jt.cwt(xs_, scales, wav, method="fft").coefficients
        print(f"  cwt banded {tag} precision={tier} vs the card's 'fft' "
              f"path: {float((got - fft).abs().max()) / scale:.3e} "
              f"relative", flush=True)
        del got, want, fft
    cd = jt.cwt_direct(xc, direct_scales, morlet)
    # the (…, N, W) windows of the widest scale: W = 2·⌊4·64⌋ + 1 = 513
    win = cb * cn * (2 * int(4.0 * direct_scales[-1]) + 1) * 4
    print(f"  cwt_direct {CWT_BENCH}: the widest scale's windows take "
          f"{win / 2**20:.1f} MiB", flush=True)
    rel_to(smoke, f"cwt_direct {CWT_BENCH} S={DIRECT_SCALES} Morlet",
           host(cd.coefficients),
           jt.cwt_direct(xc64, direct_scales, morlet).coefficients, 1e-4)
    del cd
    res = jt.cwt(xl, scales, morlet)
    rel_to(smoke, f"icwt of the {CWT_SHAPE} S={CWT_SCALES} Morlet "
           f"scalogram", host(jt.icwt(res)),
           jt.icwt(jt.cwt(host(xl), scales, morlet)), 1e-4)
    del res

    z = jt.hilbert(x)
    z64 = jt.hilbert(xh)
    rel_to(smoke, f"hilbert {MAIN_SHAPE}", host(z), z64, 1e-5)
    rel_to(smoke, f"envelope {MAIN_SHAPE}", host(jt.envelope(x)),
           jt.envelope(xh), 1e-5)
    f = host(jt.instantaneous_frequency(x))
    f64 = jt.instantaneous_frequency(xh)
    # a phase increment is ill-conditioned where the envelope is small:
    # compare (wrapped) where both neighbours keep 1% of the peak
    env = z64.abs()
    keep = torch.minimum(env[..., 1:], env[..., :-1]) >= 1e-2 * env.max()
    dphi = torch.remainder((f - f64) * 2 * math.pi + math.pi,
                           2 * math.pi) - math.pi
    print(f"  instantaneous_frequency: {float(keep.double().mean()):.4%} "
          f"of the increments compared", flush=True)
    smoke.check(f"instantaneous_frequency {MAIN_SHAPE} vs CPU f64 "
                f"(radians a sample, where the envelope is ≥ 1% of its "
                f"peak)", float(dphi.abs()[keep].max()), 1e-3)
    del z, z64, f, f64

    y = 0.5 * torch.roll(xc, 3, dims=-1) + signal(*CWT_BENCH)
    wc = jt.wavelet_coherence(xc, y, scales, morlet)
    wc64 = jt.wavelet_coherence(xc64, host(y), scales, morlet)
    smoke.require(f"wavelet_coherence {CWT_BENCH} float32, in [0, 1]",
                  wc.coherence.dtype == torch.float32
                  and float(wc.coherence.min()) >= 0.0
                  and float(wc.coherence.max()) <= 1.0)
    # the coherence is a ratio of smoothed spectra: float32 arithmetic
    # alone moves it by ~4e-4 at the largest scales (the port's own CPU
    # float32 run of the same rows, printed beside it), hence 1e-3
    wc32 = jt.wavelet_coherence(xc[:2].cpu(), y[:2].cpu(), scales, morlet)
    e32 = float((wc32.coherence.double() - wc64.coherence).abs().max())
    print(f"  wavelet_coherence: the CPU float32 run of the same rows errs "
          f"by {e32:.3e} against f64", flush=True)
    smoke.check(f"wavelet_coherence {CWT_BENCH} S={CWT_SCALES} vs CPU f64 "
                f"(absolute)", float((host(wc.coherence)
                                      - wc64.coherence).abs().max()), 1e-3)
    strong = wc64.coherence > 1e-2
    dp = torch.remainder(host(wc.phase) - wc64.phase + math.pi,
                         2 * math.pi) - math.pi
    smoke.check(f"wavelet_coherence phase vs CPU f64 (radians, where the "
                f"coherence is > 1e-2)", float(dp.abs()[strong].max()),
                1e-3)
    del wc, wc64
    print(f"  phase 24 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    t_phase = time.perf_counter()
    print(f"== phase 25: the slice's walls and bounds on {card}", flush=True)
    c = jt.fwt(x, w, LEVEL)
    yl = jt.cdf97(x)
    yl53 = jt.cdf53(x)
    ya = jt.aed_forward(xa, w)
    ys, yo = jt.swt_forward(x, haar), jt.swt_forward(xo, haar)
    r = jt.dtcwt(x, LEVEL)
    r2 = jt.dtcwt2(img, DTCWT2_LEVEL)
    xf = jt.fft(x)
    yd = jt.dft(xd)
    res = jt.cwt(xl, scales, morlet)
    calls = [
        (f"cdf97 {MAIN_SHAPE}", lambda: jt.cdf97(x), x),
        (f"icdf97 {MAIN_SHAPE}", lambda: jt.icdf97(yl), yl),
        (f"cdf53 {MAIN_SHAPE}", lambda: jt.cdf53(x), x),
        (f"icdf53 {MAIN_SHAPE}", lambda: jt.icdf53(yl53), yl53),
        (f"compress_magnitude {MAIN_SHAPE}",
         lambda: jt.compress_magnitude(c), c),
        (f"compress_peaks_average {MAIN_SHAPE}",
         lambda: jt.compress_peaks_average(c), c),
        (f"compression_rate {MAIN_SHAPE}", lambda: jt.compression_rate(c),
         c),
        (f"aed_forward {AED_SHAPE}", lambda: jt.aed_forward(xa, w), xa),
        (f"aed_inverse {AED_SHAPE}", lambda: jt.aed_inverse(ya, w), ya),
        (f"swt_forward {MAIN_SHAPE} Haar", lambda: jt.swt_forward(x, haar),
         x),
        (f"swt_inverse {MAIN_SHAPE} Haar", lambda: jt.swt_inverse(ys, haar),
         ys),
        (f"swt_forward {SWT_ODD} Haar", lambda: jt.swt_forward(xo, haar),
         xo),
        (f"swt_inverse {SWT_ODD} Haar", lambda: jt.swt_inverse(yo, haar),
         yo),
        (f"dtcwt {MAIN_SHAPE} L{LEVEL}", lambda: jt.dtcwt(x, LEVEL), x),
        (f"idtcwt {MAIN_SHAPE} L{LEVEL}", lambda: jt.idtcwt(r), r),
        (f"dtcwt_denoise {MAIN_SHAPE} L{LEVEL}",
         lambda: jt.dtcwt_denoise(x, LEVEL), x),
        (f"dtcwt2 {DTCWT2_SHAPE} L{DTCWT2_LEVEL}",
         lambda: jt.dtcwt2(img, DTCWT2_LEVEL), img),
        (f"idtcwt2 {DTCWT2_SHAPE} L{DTCWT2_LEVEL}",
         lambda: jt.idtcwt2(r2), r2),
        (f"dtcwt2_denoise {DTCWT2_SHAPE} L{DTCWT2_LEVEL}",
         lambda: jt.dtcwt2_denoise(img, DTCWT2_LEVEL), img),
        (f"fft {MAIN_SHAPE}", lambda: jt.fft(x), x),
        (f"ifft {MAIN_SHAPE}", lambda: jt.ifft(xf), xf),
        (f"dft {DFT_SHAPE}", lambda: jt.dft(xd), xd),
        (f"idft {DFT_SHAPE}", lambda: jt.idft(yd), yd),
    ]
    for tag, xs_, _, wav, tier, _, _ in banded:
        for method in ("banded", "fft"):
            if method == "fft" and tier is not None:
                continue
            label = f" precision={tier}" if method == "banded" else ""
            calls.append((f"cwt {method} {tag} S={CWT_SCALES}{label}",
                          lambda xs_=xs_, wav=wav, method=method, tier=tier:
                          jt.cwt(xs_, scales, wav, method=method,
                                 precision=tier), xs_))
    calls += [
        (f"cwt_direct {CWT_BENCH} S={DIRECT_SCALES}",
         lambda: jt.cwt_direct(xc, direct_scales, morlet), xc),
        (f"icwt {CWT_SHAPE} S={CWT_SCALES}", lambda: jt.icwt(res),
         res.coefficients),
        (f"hilbert {MAIN_SHAPE}", lambda: jt.hilbert(x), x),
        (f"envelope {MAIN_SHAPE}", lambda: jt.envelope(x), x),
        (f"instantaneous_frequency {MAIN_SHAPE}",
         lambda: jt.instantaneous_frequency(x), x),
        (f"wavelet_coherence {CWT_BENCH} S={CWT_SCALES}",
         lambda: jt.wavelet_coherence(xc, y, scales, morlet), (xc, y)),
    ]
    counted_run(smoke, torch, all_launchers(), "the continuous slice",
                lambda: [call() for _, call, _ in calls], {"cwt_ifft": 2})
    for name, call, inputs in calls:
        out = call()
        nbytes = tensor_bytes(inputs) + tensor_bytes(out)
        del out
        flops = op_flops(call)
        wall = wall_ms(torch, call)
        t_bound, by = bound(nbytes, flops)
        print(f"  slice {name}: wall {wall:.3f} ms (host clock, median of "
              f"3); flops {flops:.4e}, bytes {nbytes:.4e}, bound "
              f"{t_bound:.4f} ms by {by} ({t_bound / wall:.1%} of the wall) "
              f"[{card}]", flush=True)
    print(f"  phase 25 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def run_backward_pin(smoke: Smoke, torch, jt, signal, card) -> None:
    """Phase 26: the decimated backward in IEEE float32.  With the process
    set to TF32 through either of torch's settings, the gradient of
    sum(f(x)·g) for fwt, ifwt, wpt and the DTCWT at the north-star shape
    stays within 1e-5 of the CPU float64 gradient on the first two rows;
    beside it, the error of a product pinned in its forward only (its
    backward under the process's setting)."""
    import importlib

    mods = [importlib.import_module(f"jwave_pro_tpu_torch.ops.{m}")
            for m in ("fwt", "wpt")]
    pinned = mods[0]._mm
    w, ws = jt.wavelet(WAVELET), jt.wavelet(WPT_WAVELET)

    def forward_pin_only(u, m, tf32=False):
        if not u.is_cuda:
            return torch.matmul(u, m)
        with mods[0]._f32_products():
            return torch.matmul(u, m)

    def dtcwt_flat(v):
        r = jt.dtcwt(v, LEVEL)
        parts = [p for h in r.highpass for p in (h.real, h.imag)]
        return torch.cat(parts + [r.lowpass_a, r.lowpass_b], dim=-1)

    def vjp(f, v, g):
        v = v.detach().requires_grad_()
        return torch.autograd.grad(f(v), v, grad_outputs=g)[0]

    t_phase = time.perf_counter()
    print(f"== phase 26: gradients under TF32 (either setting) against the "
          f"CPU f64 gradient on the first two rows", flush=True)
    x = signal(*MAIN_SHAPE)
    cases = [(f"fwt {MAIN_SHAPE} L{LEVEL}", lambda v: jt.fwt(v, w, LEVEL)),
             (f"ifwt {MAIN_SHAPE} L{LEVEL}", lambda v: jt.ifwt(v, w, LEVEL)),
             (f"wpt {MAIN_SHAPE} {WPT_WAVELET} L{WPT_LEVEL}",
              lambda v: jt.wpt(v, ws, WPT_LEVEL)),
             (f"dtcwt {MAIN_SHAPE} L{LEVEL}", dtcwt_flat)]
    settings = [("matmul precision 'high'",
                 lambda: torch.set_float32_matmul_precision("high"))]
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        settings.append(("per-backend fp32_precision 'tf32'", lambda: setattr(
            torch.backends.cuda.matmul, "fp32_precision", "tf32")))
    for name, f in cases:
        g = signal(*f(x).shape)
        want = vjp(f, host64(x[:2]), host64(g[:2]))
        for what, turn_on in settings:
            try:
                turn_on()
                got = vjp(f, x, g)
                for mod in mods:
                    mod._mm = forward_pin_only
                loose = vjp(f, x, g)
            finally:
                for mod in mods:
                    mod._mm = pinned
                torch.set_float32_matmul_precision("highest")
            loose_err = float((host64(loose[:2]) - want).abs().max())
            print(f"  {name} under {what}: a backward pinned in its forward "
                  f"only errs by {loose_err / float(want.abs().max()):.3e} "
                  f"relative", flush=True)
            rel_to(smoke, f"grad {name} under {what}", host64(got[:2]), want,
                   1e-5)
            del got, loose
    print(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def ssq_planes(torch, jt, x, scales):
    """The irfft front end's (W, ∂_t W) quadrature planes of ``x``, as
    ``ssq_cwt`` computes them (zero padding, the same chunking)."""
    import importlib

    tssq = importlib.import_module("jwave_pro_tpu_torch.ops.ssq")
    n = x.shape[-1]
    p = jt.next_power_of_two(n)
    f64 = x.dtype == torch.float64
    mults = tssq._ssq_multipliers(jt.MorletWavelet(),
                                  tuple(float(s) for s in scales), p, 1.0)
    return tssq._ssq_planes(jt.pad_signal(x, p), n, mults,
                            torch.float64 if f64 else torch.float32,
                            torch.complex128 if f64 else torch.complex64)


def ssq_grid(scales, fc=1.0):
    """(log_lo, dlog) of ssq_cwt's default bin grid for scales of a wavelet
    of centre frequency ``fc`` (MorletWavelet()'s is 1)."""
    log_lo = math.log(fc / max(scales))
    return log_lo, (math.log(fc / min(scales)) - log_lo) / (len(scales) - 1)


def check_ssq(smoke: Smoke, torch, jt, x, scales, tag: str):
    """ssq_cwt of ``x`` on the card against the port's CPU f64 result on
    the first two rows.

    Bin decisions (which coefficients are reassigned, and to which bin)
    are compared one by one.  A coefficient's fractional bin idx_f is
    Im(∂W/W) through a log, so its float32 error grows as |W| and the
    frequency ω fall: at most COND·ε₃₂·(max_t|∂W| + ω·max_t|W|)/(ω·|W|·Δ)
    bins (Δ the bins' log spacing, the maxima over the row; the CPU's
    float32 run stays within 12 of those units at these shapes).  Every
    coefficient the card and the CPU both reassign must have its card
    idx_f within that bound of the f64 one, and a decision that differs
    must lie within it (and within 1e-4 at least) of a half-integer bin,
    or as near the threshold γ.  Tx is held to 1e-5 on the time columns
    where every decision agrees, and the card's Σ_bins Tx to its own
    Σ_a w_a·W over the coefficients it reassigned, an identity no bin
    decision moves.  Returns the card's result and the CPU's."""
    import importlib

    tssq = importlib.import_module("jwave_pro_tpu_torch.ops.ssq")
    log_lo, dlog = ssq_grid(scales)
    nf = len(scales)
    eps32 = torch.finfo(torch.float32).eps
    res = jt.ssq_cwt(x, scales, gamma=SSQ_GAMMA)
    x64 = host64(x[:2])
    res64 = jt.ssq_cwt(x64, scales, gamma=SSQ_GAMMA)
    rel_to(smoke, f"ssq_cwt {tag} Wx", host64(res.Wx[:2]), res64.Wx, 1e-5)
    planes = ssq_planes(torch, jt, x, scales)
    idx, valid, idxf = tssq._bins(*planes, log_lo, dlog, nf, SSQ_GAMMA,
                                  torch.float32)
    w_re, w_im = planes[0], planes[1]
    del planes
    p64 = ssq_planes(torch, jt, x64, scales)
    idx64, valid64, idxf64 = tssq._bins(*p64, log_lo, dlog, nf, SSQ_GAMMA,
                                        torch.float64)
    w64 = torch.sqrt(p64[0] ** 2 + p64[1] ** 2)
    dw64 = torch.sqrt(p64[2] ** 2 + p64[3] ** 2)
    del p64
    omega = 2 * math.pi * torch.exp(log_lo + dlog * idxf64)
    cond = eps32 * (dw64.amax(dim=-1, keepdim=True) + omega * w64.amax(
        dim=-1, keepdim=True)) / (omega * w64 * dlog)
    bin_tol = torch.clamp_min(SSQ_COND * cond, 1e-4)
    thr_tol = torch.clamp_min(SSQ_COND * 2 * eps32 * w64.amax(
        dim=-1, keepdim=True) / w64, 1e-4)
    idx2, valid2 = idx[:2].cpu(), valid[:2].cpu()
    both = valid2 & valid64
    drift = ((idxf[:2].cpu().double() - idxf64).abs() / (SSQ_COND * cond))
    smoke.check(f"ssq_cwt {tag}: each reassigned coefficient's bin vs CPU "
                f"f64, in units of its float32 bound (COND = {SSQ_COND})",
                float(drift[both].max()), 1.0)
    differ = (valid2 != valid64) | (valid64 & (idx2 != idx64))
    half = (idxf64 - torch.floor(idxf64) - 0.5).abs()
    near_thr = (w64 ** 2 / SSQ_GAMMA ** 2 - 1.0).abs()
    ties = differ & (half <= 1e-4)
    cond_ok = differ & ~ties & (half <= bin_tol)
    thr_ok = differ & (near_thr <= thr_tol)
    bad = differ & ~(ties | cond_ok | thr_ok)
    print(f"  ssq_cwt {tag}: {int(differ.sum())} of {differ.numel()} bin "
          f"decisions differ from CPU f64: {int(ties.sum())} within 1e-4 "
          f"bins of a half-integer, {int(cond_ok.sum())} within their "
          f"coefficient's float32 bound of one, {int(thr_ok.sum())} at the "
          f"threshold, {int(bad.sum())} otherwise", flush=True)
    for k in torch.nonzero(differ & ~ties)[:8].tolist():
        k = tuple(k)
        print(f"    {k}: {float(half[k]):.3e} bins from a half-integer, "
              f"bound {float(bin_tol[k]):.3e}; |W| / the row's max "
              f"{float(w64[k] / w64[k[:2]].max()):.3e}", flush=True)
    smoke.require(f"ssq_cwt {tag}: every differing bin decision lies at a "
                  f"half-integer bin or the threshold, within its bound",
                  not bool(bad.any()))
    agree = ~differ.any(dim=-2, keepdim=True)                # (2, 1, N)
    got, want = host64(res.Tx[:2]), res64.Tx
    err = float(((got - want).abs() * agree).max())
    smoke.check(f"ssq_cwt {tag} Tx vs CPU f64 where the decisions agree "
                f"(relative to max|ref| {float(want.abs().max()):.3g})",
                err / float(want.abs().max()), 1e-5)
    wts = torch.from_numpy(tssq._ssq_weights(tuple(float(s)
                                                   for s in scales))).to(
        x.device, torch.float32)
    lhs = res.Tx.sum(dim=-2)
    rhs = (torch.complex(w_re, w_im) * valid * wts[:, None]).sum(dim=-2)
    rel_to(smoke, f"ssq_cwt {tag}: Σ_bins Tx against Σ_a w_a·W of the "
           f"reassigned", lhs, rhs, 1e-5)
    return res, res64


def ridge_cost(u, path, penalty=2.0) -> float:
    """The DP's cost of ``path`` (N,) on the log-energy plane u (L, N)."""
    import torch

    l = u.shape[0]
    unary = -u[path, torch.arange(u.shape[1])].sum()
    dl = (path[1:] - path[:-1]).double()
    return float(unary + (penalty * (dl / l) ** 2 * l).sum())


def check_ridges(smoke: Smoke, torch, jt, tx, n_ridges=2, mask_width=2):
    """extract_ridges on the card against the port's CPU run on the card's
    own Tx moved to the host: indices equal, or, where a ridge differs,
    both paths' costs (each on its own masked plane, float64) within
    1e-5 relative — a tie."""
    got = jt.extract_ridges(tx, n_ridges=n_ridges, mask_width=mask_width)
    tx_h = tx.cpu()
    want = jt.extract_ridges(tx_h, n_ridges=n_ridges, mask_width=mask_width)
    gi, wi = got.indices.cpu().long(), want.indices.long()
    ncols = int((gi != wi).sum())
    u = torch.log(tx_h.real.double() ** 2 + tx_h.imag.double() ** 2
                  + 1e-12)
    worst = 0.0
    bins = torch.arange(u.shape[-2])[:, None]
    for b in range(u.shape[0]):
        cur_g, cur_w = u[b].clone(), u[b].clone()
        for r in range(n_ridges):
            pg, pw = gi[b, r], wi[b, r]
            if not torch.equal(pg, pw):
                cg, cw = ridge_cost(cur_g, pg), ridge_cost(cur_w, pw)
                worst = max(worst, abs(cg - cw) / abs(cw))
            cur_g = torch.where((bins - pg[None]).abs() <= mask_width,
                                -torch.inf, cur_g)
            cur_w = torch.where((bins - pw[None]).abs() <= mask_width,
                                -torch.inf, cur_w)
    print(f"  extract_ridges {tuple(tx.shape)}: {ncols} of {gi.numel()} "
          f"ridge columns differ from the CPU run on the same Tx",
          flush=True)
    smoke.check(f"extract_ridges {tuple(tx.shape)}: differing ridges' costs "
                f"(relative)", worst, 1e-5)
    return got


def run_continuous2_slice(smoke: Smoke, torch, jt, signal, card) -> list:
    """The second continuous slice through the public API (phase 27):
    ssq_cwt and issq_cwt, extract_ridges, cwt2/icwt2, scattering1d and
    scattering2d, ewt1d/iewt1d, float32 on the card at bench.py's shapes,
    each against the port's own CPU float64 result on the first two rows.
    Returns phase 29's calls: (name, call, inputs, extra flops)."""
    import importlib

    tssq = importlib.import_module("jwave_pro_tpu_torch.ops.ssq")
    t_phase = time.perf_counter()
    print(f"== phase 27: synchrosqueezing, ridges, 2D CWT, scattering and "
          f"EWT, f32, against the port's CPU f64 result on the first two "
          f"rows", flush=True)
    fc = jt.MorletWavelet().center_frequency
    scales = jt.generate_log_scales(fc / 0.4, fc / 0.01, SSQ_SCALES)
    wide = jt.generate_log_scales(fc / 0.4, fc / 0.01, SSQ_WIDE_SCALES)
    xs, xw = signal(*SSQ_BENCH), signal(*SSQ_WIDE)
    res, res64 = check_ssq(smoke, torch, jt, xs, scales, f"{SSQ_BENCH} "
                           f"S={SSQ_SCALES}")
    resw, _ = check_ssq(smoke, torch, jt, xw, wide, f"{SSQ_WIDE} "
                        f"S={SSQ_WIDE_SCALES}")
    del resw
    band = (0.05, 0.2)
    rel_to(smoke, f"issq_cwt(ssq_cwt) {SSQ_BENCH} vs CPU f64",
           host64(jt.issq_cwt(res)[:2]), jt.issq_cwt(res64), 1e-4)
    rel_to(smoke, f"issq_cwt(ssq_cwt, freq_range={band}) {SSQ_BENCH} vs "
           f"CPU f64", host64(jt.issq_cwt(res, freq_range=band)[:2]),
           jt.issq_cwt(res64, freq_range=band), 1e-4)
    check_ridges(smoke, torch, jt, res.Tx)

    mh, mo = jt.MexicanHat2D(), jt.Morlet2D()
    s_real = jt.generate_log_scales(1.0, 16.0, CWT2_REAL_SCALES)
    s_dir = jt.generate_log_scales(1.0, 16.0, CWT2_DIR_SCALES)
    angles = np.pi * np.arange(CWT2_ANGLES) / CWT2_ANGLES
    img_r, img_d = signal(*CWT2_REAL), signal(*CWT2_DIR)
    for tag, img, sc, wav, ang in (
            (f"MexicanHat2D {CWT2_REAL} S={CWT2_REAL_SCALES}", img_r,
             s_real, mh, None),
            (f"Morlet2D {CWT2_DIR} S={CWT2_DIR_SCALES} A={CWT2_ANGLES}",
             img_d, s_dir, mo, angles)):
        r = jt.cwt2(img, sc, wav, ang)
        r64 = jt.cwt2(host64(img[:2]), sc, wav, ang)
        smoke.require(f"cwt2 {tag}: {r.coefficients.dtype}",
                      r.coefficients.dtype == (torch.float32 if ang is None
                                               else torch.complex64))
        rel_to(smoke, f"cwt2 {tag}", host64(r.coefficients[:2]),
               r64.coefficients, 1e-5)
        rel_to(smoke, f"icwt2(cwt2) {tag} vs CPU f64",
               host64(jt.icwt2(r, wav)[:2]), jt.icwt2(r64, wav), 1e-4)
        del r, r64

    x1 = signal(*SCAT1_SHAPE)
    sc1 = jt.scattering1d(x1, SCAT1_J, SCAT1_Q)
    sc1_64 = jt.scattering1d(host64(x1[:2]), SCAT1_J, SCAT1_Q)
    for order in ("s0", "s1", "s2"):
        rel_to(smoke, f"scattering1d {SCAT1_SHAPE} J={SCAT1_J} Q={SCAT1_Q} "
               f"{order}", host64(getattr(sc1, order)[:2]),
               getattr(sc1_64, order), 1e-5)
    x2 = signal(*SCAT2_SHAPE)
    sc2 = jt.scattering2d(x2, SCAT2_J, SCAT2_L)
    sc2_64 = jt.scattering2d(host64(x2[:2]), SCAT2_J, SCAT2_L)
    for order in ("s0", "s1", "s2"):
        rel_to(smoke, f"scattering2d {SCAT2_SHAPE} J={SCAT2_J} L={SCAT2_L} "
               f"{order}", host64(getattr(sc2, order)[:2]),
               getattr(sc2_64, order), 1e-5)
    del sc1, sc1_64, sc2, sc2_64

    xe = ewt_signal(torch, signal)
    e = jt.ewt1d(xe, EWT_MODES)
    e64 = jt.ewt1d(host64(xe[:2]), EWT_MODES)
    n = xe.shape[-1]
    pb = torch.round(host64(e.peaks[:2]) * n / (2 * math.pi))
    pb64 = torch.round(e64.peaks * n / (2 * math.pi))
    smoke.require(f"ewt1d {EWT_SHAPE} K={EWT_MODES}: peak bins equal the "
                  f"CPU f64 ones", torch.equal(pb, pb64),
                  f"(bins {pb64[0].long().tolist()})")
    smoke.check(f"ewt1d {EWT_SHAPE} boundaries vs CPU f64 (relative; one "
                f"float32 ulp is 1.2e-7)", float(
                    ((host64(e.boundaries[:2]) - e64.boundaries).abs()
                     / e64.boundaries.abs()).max()), 1.2e-7)
    rel_to(smoke, f"ewt1d {EWT_SHAPE} components", host64(
        e.components[:2]), e64.components, 1e-5)
    rel_to(smoke, f"iewt1d(ewt1d) {EWT_SHAPE} round trip",
           jt.iewt1d(e.components, e.filters), xe, 1e-4)
    del e, e64
    print(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    banded_front = (lambda xx, ss: ssq_banded(torch, jt, tssq, xx, ss))
    r2 = jt.cwt2(img_r, s_real, mh)
    rd = jt.cwt2(img_d, s_dir, mo, angles)
    e = jt.ewt1d(xe, EWT_MODES)
    b, l, nn = res.Tx.shape
    return [
        (f"ssq_cwt {SSQ_BENCH} S={SSQ_SCALES} (irfft front end)",
         lambda: jt.ssq_cwt(xs, scales, gamma=SSQ_GAMMA), xs, 0),
        (f"ssq banded front end + _reassign_planes {SSQ_BENCH} "
         f"S={SSQ_SCALES}", lambda: banded_front(xs, scales), xs, 0),
        (f"ssq_cwt {SSQ_WIDE} S={SSQ_WIDE_SCALES} (irfft front end)",
         lambda: jt.ssq_cwt(xw, wide, gamma=SSQ_GAMMA), xw, 0),
        (f"ssq banded front end + _reassign_planes {SSQ_WIDE} "
         f"S={SSQ_WIDE_SCALES}", lambda: banded_front(xw, wide), xw, 0),
        (f"issq_cwt {SSQ_BENCH}", lambda: jt.issq_cwt(res), res.Tx, 0),
        (f"issq_cwt {SSQ_BENCH} band {band}",
         lambda: jt.issq_cwt(res, freq_range=band), res.Tx, 0),
        (f"extract_ridges {(b, l, nn)} 2 ridges (the DP loop)",
         lambda: jt.extract_ridges(res.Tx, n_ridges=2, mask_width=2),
         res.Tx, 2 * 2 * b * l * l * nn),
        (f"cwt2 MexicanHat2D {CWT2_REAL} S={CWT2_REAL_SCALES}",
         lambda: jt.cwt2(img_r, s_real, mh), img_r, 0),
        (f"icwt2 MexicanHat2D {CWT2_REAL}", lambda: jt.icwt2(r2, mh),
         r2.coefficients, 0),
        (f"cwt2 Morlet2D {CWT2_DIR} S={CWT2_DIR_SCALES} A={CWT2_ANGLES}",
         lambda: jt.cwt2(img_d, s_dir, mo, angles), img_d, 0),
        (f"icwt2 Morlet2D {CWT2_DIR}", lambda: jt.icwt2(rd, mo),
         rd.coefficients, 0),
        (f"scattering1d {SCAT1_SHAPE} J={SCAT1_J} Q={SCAT1_Q}",
         lambda: jt.scattering1d(x1, SCAT1_J, SCAT1_Q), x1, 0),
        (f"scattering2d {SCAT2_SHAPE} J={SCAT2_J} L={SCAT2_L}",
         lambda: jt.scattering2d(x2, SCAT2_J, SCAT2_L), x2, 0),
        (f"ewt1d {EWT_SHAPE} K={EWT_MODES}",
         lambda: jt.ewt1d(xe, EWT_MODES), xe, 0),
        (f"iewt1d {EWT_SHAPE} K={EWT_MODES}",
         lambda: jt.iewt1d(e.components, e.filters), e.components, 0),
    ]


def ssq_banded(torch, jt, tssq, x, scales):
    """JAX's TPU front end on the card: cwt_banded_wd feeding
    _reassign_planes (what ssq_cwt would run with the banded front end)."""
    n = x.shape[-1]
    p = jt.next_power_of_two(n)
    log_lo, dlog = ssq_grid(scales)
    w_c, d_c = jt.cwt_banded_wd(torch.fft.rfft(jt.pad_signal(x, p)), n,
                                np.asarray(scales), jt.MorletWavelet(), 1.0,
                                p)
    return tssq._reassign_planes(
        w_c.real, w_c.imag, d_c.real, d_c.imag,
        tssq._ssq_weights(tuple(float(s) for s in scales)), log_lo, dlog,
        len(scales), SSQ_GAMMA, torch.float32, torch.complex64)


def ewt_signal(torch, signal):
    """EWT_SHAPE rows of six tones (distinct per row) in unit noise."""
    b, n = EWT_SHAPE
    noise = signal(b, n)
    t = torch.arange(n, device=noise.device, dtype=torch.float64)
    rows = []
    for r in range(b):
        f = [0.013, 0.041, 0.09, 0.16, 0.27, 0.38]
        rows.append(sum((k + 2) * torch.cos(2 * math.pi * (fk + 1e-4 * r)
                                            * t)
                        for k, fk in enumerate(f)))
    return torch.stack(rows).float() + noise


def run_streaming_slice(smoke: Smoke, torch, jt, signal, card) -> list:
    """Streaming on the card (phase 28): the causal tail at bench.py's
    streaming shape, StreamingMODWT incremental and full recompute,
    modwt_chunked, StreamingVariance, one update of each windowed
    transform and a save/load round trip.  The forward kernel's counter
    is read around each call: 1D windows run the flat forward (#2),
    batched ones the batched forward (#1); both must run.  Returns phase
    29's calls and the launches each makes."""
    from jwave_pro_tpu_torch import streaming as st
    from jwave_pro_tpu_torch.kernels import _launch as kl

    t_phase = time.perf_counter()
    w = jt.wavelet(WAVELET)
    halo = (w.length - 1) * ((1 << LEVEL) - 1)
    chunk, buf = STREAM_CHUNK, STREAM_BUF
    print(f"== phase 28: streaming on the card, {WAVELET} L{LEVEL}, buffer "
          f"{buf}, chunks of {chunk} (halo {halo})", flush=True)
    launched = {"#1 batched": 0, "#2 flat": 0}

    def counted(kind, fn):
        torch.cuda.synchronize()
        before = kl.LAUNCHES["modwt_fwd"]
        out = fn()
        torch.cuda.synchronize()
        launched[kind] += kl.LAUNCHES["modwt_fwd"] - before
        return out

    kl.LAUNCHES["modwt_fwd"] = 0
    c0 = signal(LEVEL + 1, STREAM_CH, buf)
    window = c0[-1, :, :halo + chunk]
    tail = counted("#1 batched",
                   lambda: st._causal_tail(window, chunk, w, LEVEL))
    rel_to(smoke, f"_causal_tail {tuple(window.shape)} vs CPU f64",
           host64(tail[:, :2]), st._causal_tail(host64(window[:2]), chunk,
                                                w, LEVEL), 1e-5)
    sig = signal(STREAM_UPDATES * chunk)
    cfg = st.StreamingConfig(buf, LEVEL, device=sig.device)
    sm = st.StreamingMODWT(w, cfg)
    for i in range(STREAM_UPDATES):
        out = counted("#2 flat", lambda: sm.update(
            sig[i * chunk:(i + 1) * chunk]))
    whole = jt.modwt(sig, w, LEVEL)[..., -buf:]
    scale = float(whole.abs().max())
    smoke.check(f"StreamingMODWT incremental, {STREAM_UPDATES} updates, vs "
                f"modwt of the whole signal on the columns ≥ halo "
                f"(relative to max {scale:.3g})", float(
                    (out[..., halo:] - whole[..., halo:]).abs().max())
                / scale, 1e-6)
    full_cfg = st.StreamingConfig(
        buf, LEVEL, update_strategy=st.UpdateStrategy.FULL_RECOMPUTE,
        device=sig.device)
    sf = st.StreamingMODWT(w, full_cfg)
    for i in range(STREAM_UPDATES):
        outf = sf.update(sig[i * chunk:(i + 1) * chunk])
    rel_to(smoke, f"StreamingMODWT full recompute vs CPU f64 modwt of the "
           f"buffer", outf, jt.modwt(host64(sf.get_current_buffer()), w,
                                     LEVEL, method="direct"), 1e-5)
    xc = signal(*CHUNKED_SHAPE)
    parts = counted("#1 batched", lambda: list(st.modwt_chunked(
        xc.split(chunk, dim=-1), w, LEVEL)))
    got = torch.cat(parts, dim=-1)
    del parts
    want = jt.modwt(xc, w, LEVEL)
    scale = float(want.abs().max())
    smoke.check(f"modwt_chunked {CHUNKED_SHAPE} in chunks of {chunk} vs "
                f"modwt on the columns ≥ halo (relative to max "
                f"{scale:.3g})", float((got[..., halo:] - want[..., halo:])
                                       .abs().max()) / scale, 1e-6)
    del got, want
    sv = st.StreamingVariance(w, cfg)
    sv64 = st.StreamingVariance(w, st.StreamingConfig(
        buf, LEVEL, dtype=torch.float64, device="cpu"))
    for i in range(STREAM_UPDATES):
        piece = sig[i * chunk:(i + 1) * chunk]
        v = counted("#2 flat", lambda: sv.update(piece))
        v64 = sv64.update(host64(piece))
    rel_to(smoke, f"StreamingVariance {STREAM_UPDATES} updates vs CPU f64",
           v, v64, 1e-5)
    xs_ = jt.generate_log_scales(1.0, 64.0, 16)
    windowed = {"fwt": w, "wpt": w, "fft": None, "cwt": jt.MorletWavelet()}
    for kind, wav in windowed.items():
        kw = {"scales": xs_} if kind == "cwt" else {}
        s = st.streaming_transform(kind, wav, cfg, **kw)
        s64 = st.streaming_transform(kind, wav, st.StreamingConfig(
            buf, LEVEL, dtype=torch.float64, device="cpu"), **kw)
        rel_to(smoke, f"Streaming{kind.upper()} one update vs CPU f64",
               s.update(sig[:chunk]), s64.update(host64(sig[:chunk])), 1e-5)
    state = Path(__file__).resolve().parent / "build" / "smoke_stream.npz"
    state.parent.mkdir(exist_ok=True)
    st.save_state(sm, str(state))
    again = st.StreamingMODWT(w, cfg)
    st.load_state(again, str(state))
    state.unlink()
    same = True
    for i in range(2):
        piece = sig[i * chunk:(i + 1) * chunk]
        a = counted("#2 flat", lambda: sm.update(piece))
        b = counted("#2 flat", lambda: again.update(piece))
        same &= torch.equal(a, b)
    smoke.require("save_state/load_state round trip: the next two updates "
                  "bitwise equal the saved stream's", same)
    print(f"  forward kernel launches in phase 28: {launched}", flush=True)
    smoke.require("phase 28 ran the batched forward (#1) and the flat "
                  "forward (#2)", all(n > 0 for n in launched.values()),
                  str(launched))
    print(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    fwt_s = st.streaming_transform("fwt", w, cfg)
    wpt_s = st.streaming_transform("wpt", w, cfg)
    fft_s = st.streaming_transform("fft", None, cfg)
    cwt_s = st.streaming_transform("cwt", jt.MorletWavelet(), cfg,
                                   scales=xs_)
    piece = sig[:chunk]
    return [
        (f"_causal_tail {tuple(window.shape)}",
         lambda: st._causal_tail(window, chunk, w, LEVEL), window, 0, 1),
        (f"StreamingMODWT.update incremental ({chunk},)",
         lambda: sm.update(piece), piece, 0, 1),
        (f"StreamingMODWT.update full recompute ({chunk},)",
         lambda: sf.update(piece), piece, 0, 0),
        (f"modwt_chunked {CHUNKED_SHAPE} in chunks of {chunk}",
         lambda: list(st.modwt_chunked(xc.split(chunk, dim=-1), w, LEVEL)),
         xc, 0, CHUNKED_SHAPE[1] // chunk),
        (f"StreamingVariance.update ({chunk},)", lambda: sv.update(piece),
         piece, 0, 1),
        (f"StreamingFWT.update ({chunk},)", lambda: fwt_s.update(piece),
         piece, 0, 0),
        (f"StreamingWPT.update ({chunk},)", lambda: wpt_s.update(piece),
         piece, 0, 0),
        (f"StreamingFFT.update ({chunk},)", lambda: fft_s.update(piece),
         piece, 0, 0),
        (f"StreamingCWT.update ({chunk},) S=16",
         lambda: cwt_s.update(piece), piece, 0, 0),
    ]


def run_slice_walls(smoke: Smoke, torch, jt, calls: list, stream_calls: list,
                    card) -> None:
    """Phase 29: every call of phases 27-28 in a counted window (phase
    27's launch none of the 14 kernels, phase 28's the forward kernel as
    many times as their windows and the streaming CWT's update #14 once),
    then each call's wall beside its bound:
    max(bytes / 3.35 TB/s, FFT-and-product flops / 67 TFLOP/s), with
    each FFT 5·n·log₂n (a real one half) and the ridge DP's adds and
    compares counted too."""
    t_phase = time.perf_counter()
    print(f"== phase 29: walls and bounds of phases 27-28 on {card}",
          flush=True)
    counted_run(smoke, torch, all_launchers(), "the second continuous "
                "slice", lambda: [c() for _, c, _, _ in calls], {})
    counted_run(smoke, torch, all_launchers(), "the streaming calls",
                lambda: [c() for _, c, _, _, _ in stream_calls],
                {"modwt_fwd": sum(n for *_, n in stream_calls),
                 "cwt_ifft": 1})
    for name, call, inputs, extra, *_ in calls + stream_calls:
        out = call()
        nbytes = tensor_bytes(inputs) + tensor_bytes(out)
        del out
        flops = op_flops(call) + extra
        wall = wall_ms(torch, call)
        t_bound, by = bound(nbytes, flops)
        print(f"  slice {name}: wall {wall:.3f} ms (host clock, median of "
              f"3); flops {flops:.4e}, bytes {nbytes:.4e}, bound "
              f"{t_bound:.4f} ms by {by} ({t_bound / wall:.1%} of the wall) "
              f"[{card}]", flush=True)
    print(f"  phase 29 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


EPS32 = 2.0 ** -24      # float32 unit roundoff


def chain_stages(jt, prices):
    """preprocess_prices stage by stage: (filled, returns, winsorized, z,
    sigma), each stage the public function the chain calls."""
    filled = jt.fill_gaps(prices)
    r = jt.log_returns(filled)
    rw = jt.winsorize_outliers(r)
    return (filled, r, rw) + tuple(jt.normalize_volatility(rw))


def check_chain(smoke: Smoke, torch, jt, got, want) -> dict:
    """The card's float32 stages (``chain_stages``) against the CPU f64
    ones on the same prices, each element within FIN_COND float32 error
    units of its own size: a log return's unit ε·(|ln p_t| + |ln p_{t−1}|
    + |r_t|); σ's ε·(2·L + 32·σ_t), L the row's max |ln p| (a return's
    error reaches σ at most once, Cauchy–Schwarz; 32 ≈ √512 for the FIR's
    summation); z's (ε·2L + |z_t|·unit(σ_{t−1}))/d_t + 2ε·|z_t|, d_t the
    divisor max(σ_{t−1}, floor).  The gap fill and the medians are
    selections: exact.  The clip decisions are counted; one that differs
    must lie within FIN_COND units, ε·(4L + lim), of its edge
    med ± 5·MAD/0.6745.  Returns the counts and the worst ratios."""
    f32, r32, w32, z32, s32 = (host64(t) for t in got)
    f64, r64, w64, z64, s64 = want
    smoke.require("fill_gaps: the card's fill is the CPU's, exactly",
                  torch.equal(f32, f64))
    lp = torch.log(f64)
    big = lp.abs().amax(-1, keepdim=True)
    u_r = EPS32 * (lp.abs() + torch.cat([lp[:, :1], lp[:, :-1]], -1).abs()
                   + r64.abs()) + 1e-300
    ratio_r = float(((r32 - r64).abs() / u_r).max())
    # the winsorizer's edges, from the f64 returns
    med = jt.median_select(r64)[:, None]
    lim = 5.0 * jt.median_select((r64 - med).abs())[:, None] / 0.6745
    clip32, clip64 = w32 != r32, w64 != r64
    differ = clip32 != clip64
    dist = torch.minimum((r64 - (med - lim)).abs(), (r64 - (med + lim)).abs())
    allowed = FIN_COND * EPS32 * (4 * big + lim)
    worst_clip = float((dist / allowed).expand_as(r64)[differ].max()) \
        if bool(differ.any()) else 0.0
    u_s = EPS32 * (2 * big + 32 * s64)
    ratio_s = float(((s32 - s64).abs() / (u_s + 1e-300)).max())
    lag = torch.cat([s64[:, :1], s64[:, :-1]], -1)
    u_lag = torch.cat([u_s[:, :1], u_s[:, :-1]], -1)
    n = r64.shape[-1]
    t = torch.arange(n, dtype=torch.float64)
    rms = torch.sqrt(torch.cumsum(w64 * w64, -1) / (t + 1.0))
    d = torch.maximum(lag, 1e-12 + 1e-3 * torch.cat([rms[:, :1],
                                                     rms[:, :-1]], -1))
    u_z = (EPS32 * 2 * big + z64.abs() * u_lag) / d + 2 * EPS32 * z64.abs()
    ratio_z = float(((z32 - z64).abs() / (u_z + 1e-300)).max())
    counts = {"clipped_card": int(clip32.sum()), "clipped_f64":
              int(clip64.sum()), "differing": int(differ.sum())}
    print(f"  clip decisions: {counts['clipped_card']} clipped on the card, "
          f"{counts['clipped_f64']} in f64, {counts['differing']} differ "
          f"(worst at {worst_clip:.3g} of its allowance); float32 units: "
          f"returns {ratio_r:.3g}, sigma {ratio_s:.3g}, z {ratio_z:.3g} "
          f"(limit {FIN_COND})", flush=True)
    smoke.require("log returns within their float32 units of f64",
                  ratio_r <= FIN_COND, f"({ratio_r:.3g})")
    smoke.require("each differing clip decision within its units of the "
                  "edge", worst_clip <= 1.0, f"({worst_clip:.3g})")
    smoke.require("sigma within its float32 units of f64",
                  ratio_s <= FIN_COND, f"({ratio_s:.3g})")
    smoke.require("z within its float32 units of f64", ratio_z <= FIN_COND,
                  f"({ratio_z:.3g})")
    return dict(counts, ratio_r=ratio_r, ratio_s=ratio_s, ratio_z=ratio_z)


def kc_halo(m: int, level: int) -> int:
    """The MODWT cascade's reach: (M − 1)(2^L − 1) samples."""
    return (m - 1) * ((1 << level) - 1)


def run_financial_slice(smoke: Smoke, torch, jt, card) -> None:
    """Phase 30: the financial chain at bench.py:172's shape (FIN_SHAPE
    float32 prices, FIN_GAPS of them gaps, one 20% print in every row):
    ``preprocess_prices`` stage by stage against the port's CPU float64
    run on the same prices (``check_chain``), ``median_select`` on the
    card exactly the CPU's, then z into ``modwt`` Db4 L5 (one #1 launch)
    and ``modwt_variance`` (one #5 launch) in counted windows, against
    the CPU f64 transforms of the card's z; walls beside bounds."""
    t_phase = time.perf_counter()
    print(f"== phase 30: the financial chain {FIN_SHAPE} f32, "
          f"{FIN_GAPS:.0%} gaps, against the port's CPU f64 result",
          flush=True)
    w = jt.wavelet(WAVELET)
    b, n = FIN_SHAPE
    rng = np.random.default_rng(SEED + 30)
    p = np.exp(np.cumsum(0.01 * rng.standard_normal(FIN_SHAPE), axis=-1))
    p[np.arange(b), rng.integers(1, n, b)] *= 1.2     # a bad print a row
    p[rng.random(FIN_SHAPE) < FIN_GAPS] = np.nan
    p32 = p.astype(np.float32)
    x = torch.from_numpy(p32).cuda()
    x64 = torch.from_numpy(p32.astype(np.float64))
    got = chain_stages(jt, x)
    z, sigma = jt.preprocess_prices(x)
    smoke.require("preprocess_prices is its stages, bitwise",
                  torch.equal(z, got[3]) and torch.equal(sigma, got[4]))
    smoke.require(f"z and sigma {FIN_SHAPE} float32, finite",
                  z.dtype == sigma.dtype == torch.float32
                  and tuple(z.shape) == FIN_SHAPE
                  and bool(torch.isfinite(z).all())
                  and bool(torch.isfinite(sigma).all()))
    check_chain(smoke, torch, jt, got, chain_stages(jt, x64))
    r = got[1]
    for what, v in (("returns", r), ("|returns − median|",
                                     (r - jt.median_select(r)[:, None]).abs())):
        smoke.require(f"median_select of the {what} on the card is the "
                      f"CPU's, exactly", torch.equal(
                          jt.median_select(v).cpu(),
                          jt.median_select(v.cpu())))
    counters = all_launchers()
    c, _ = counted_run(smoke, torch, counters, f"modwt of z {FIN_SHAPE} "
                       f"L{LEVEL}", lambda: jt.modwt(z, w, LEVEL),
                       {"modwt_fwd": 1})
    z64 = host64(z)
    # z[:, 1] = r[1]/1e-12 (σ_0 = 0 and the floor's RMS 0 at t = 0, as in
    # the JAX package's chain); outside that spike's reach (the forward's
    # halo) the coefficients are held to their own scale
    c64, reach = jt.modwt(z64, w, LEVEL), 2 + kc_halo(w.length, LEVEL)
    rel_to(smoke, f"modwt of z {FIN_SHAPE} L{LEVEL} vs CPU f64", c, c64,
           1e-5)
    rel_to(smoke, f"modwt of z {FIN_SHAPE} L{LEVEL} vs CPU f64, columns "
           f"≥ {reach}", c[..., reach:], c64[..., reach:], 1e-5)
    # the spike sets every level's variance of the whole z, so #5 is held
    # on the columns past the spike's reach, where no sample dominates;
    # the whole z's variance is checked beside it
    zt = z[:, reach:]
    nu, _ = counted_run(smoke, torch, counters, f"modwt_variance of z "
                        f"{tuple(zt.shape)} (columns ≥ {reach}) L{LEVEL}",
                        lambda: jt.modwt_variance(zt, w, LEVEL),
                        {"modwt_var": 1})
    rel_to(smoke, f"modwt_variance of z, columns ≥ {reach}, L{LEVEL} vs "
           f"CPU f64", nu, jt.modwt_variance(z64[:, reach:], w, LEVEL), 1e-4)
    nu, _ = counted_run(smoke, torch, counters, f"modwt_variance of z "
                        f"{FIN_SHAPE} L{LEVEL}",
                        lambda: jt.modwt_variance(z, w, LEVEL),
                        {"modwt_var": 1})
    rel_to(smoke, f"modwt_variance of z {FIN_SHAPE} L{LEVEL} vs CPU f64",
           nu, jt.modwt_variance(z64, w, LEVEL), 1e-4)
    del c, nu, zt
    cells = b * n
    for name, call, nbytes in (
            (f"preprocess_prices {FIN_SHAPE}", lambda: jt.preprocess_prices(x),
             12 * cells),
            (f"median_select {FIN_SHAPE}", lambda: jt.median_select(r),
             4 * (cells + b)),
            (f"modwt of z {FIN_SHAPE} L{LEVEL}", lambda: jt.modwt(z, w, LEVEL),
             4 * cells * (LEVEL + 2)),
            (f"modwt_variance of z {FIN_SHAPE} L{LEVEL}",
             lambda: jt.modwt_variance(z, w, LEVEL), 4 * (cells + b * LEVEL))):
        flops = op_flops(call)
        if name.startswith("modwt "):
            flops = cells * 4 * w.length * LEVEL
        elif name.startswith("modwt_variance"):
            flops = cells * (4 * w.length + 2) * LEVEL
        wall = wall_ms(torch, call)
        t_bound, by = bound(nbytes, flops)
        print(f"  financial {name}: wall {wall:.3f} ms (host clock, median "
              f"of 3); flops {flops:.4e}, bytes {nbytes:.4e}, bound "
              f"{t_bound:.4f} ms by {by} ({t_bound / wall:.1%} of the wall) "
              f"[{card}]", flush=True)
    print(f"  phase 30 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


FACADES = ("Fast Wavelet Transform", "Wavelet Packet Transform",
           "Maximal Overlap Discrete Wavelet Transform",
           "Shifting Wavelet Transform", "Fast Fourier Transform",
           "Discrete Fourier Transform")


def run_facade_slice(smoke: Smoke, torch, jt, signal, card) -> None:
    """Phase 31: the facades at the main shape, Db4 L5: ``build_transform``
    for each name, a round trip through each engine on the card (the
    decimated, packet, MODWT and shifting engines over MAIN_SHAPE, the
    FFT over 2²⁰ complex samples, the DFT over DFT_SHAPE's 4096) within
    1e-4 of the signal (``tools/tpu_smoke.py:55``), each forward against
    the port's CPU f64 result on two rows within 1e-5; the MODWT engine's
    forward, reverse and MRA in counted windows (1 #1; 1 #3; 1 #1 and 6
    #3), every other engine's none; and the console demo in a
    subprocess on the card, exit 0."""
    t_phase = time.perf_counter()
    print(f"== phase 31: the transform facades {MAIN_SHAPE} {WAVELET} "
          f"L{LEVEL}", flush=True)
    x = signal(*MAIN_SHAPE)
    x1 = signal(2 << 20)                   # 2^20 complex, interleaved
    xd = signal(2 * DFT_SHAPE[1])
    counters = all_launchers()
    runs = {
        FACADES[0]: (x, (LEVEL,), {}),
        FACADES[1]: (x, (LEVEL,), {}),
        FACADES[2]: (x, (LEVEL,), {"modwt_fwd": 1}),
        FACADES[3]: (x, (), {}),
        FACADES[4]: (x1, (), {}),
        FACADES[5]: (xd, (), {}),
    }
    for name, (v, args, launches) in runs.items():
        t = jt.build_transform(name, WAVELET)
        eng = t.engine
        forward = (lambda: t.forward(v, *args)) if v.ndim == 1 or \
            isinstance(eng, jt.MODWTTransform) else \
            (lambda: eng.forward_1d(v, *args))
        reverse_1d = getattr(eng, "reverse_1d")
        y, _ = counted_run(smoke, torch, counters, f"{name} forward",
                           forward, launches)
        back_launches = {"modwt_inv": 1} if launches else {}
        back, _ = counted_run(
            smoke, torch, counters, f"{name} reverse",
            (lambda: t.reverse(y)) if isinstance(eng, jt.MODWTTransform)
            else (lambda: reverse_1d(y, *args)), back_launches)
        smoke.check(f"{name} round trip {tuple(v.shape)}", max_err(back, v),
                    1e-4)
        rows = v[:2] if v.ndim > 1 else v
        host_eng = jt.build_transform(name, WAVELET).engine
        want = (host_eng.forward(host64(rows), *args)
                if isinstance(eng, jt.MODWTTransform) or v.ndim == 1 else
                host_eng.forward_1d(host64(rows), *args))
        got = y[:, :2] if isinstance(eng, jt.MODWTTransform) else \
            (y[:2] if v.ndim > 1 else y)
        rel_to(smoke, f"{name} forward vs CPU f64", got, want, 1e-5)
        wall = wall_ms(torch, forward)
        print(f"  facade {name} forward {tuple(v.shape)}: wall {wall:.3f} "
              f"ms (host clock, median of 3) [{card}]", flush=True)
        del y, back
    eng = jt.MODWTTransform(jt.wavelet(WAVELET))
    mra, _ = counted_run(smoke, torch, counters, "MODWTTransform.mra",
                         lambda: eng.mra(x, LEVEL),
                         {"modwt_fwd": 1, "modwt_inv": LEVEL + 1})
    smoke.check("MODWTTransform.mra components sum to the signal",
                max_err(mra.sum(0), x), 1e-4)
    del mra
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "jwave_pro_tpu_torch.cli",
         "Fast Wavelet Transform", WAVELET], capture_output=True, text=True,
        timeout=300, cwd=Path(__file__).resolve().parent)
    print("  " + "\n  ".join(done.stdout.strip().splitlines()), flush=True)
    smoke.require("python -m jwave_pro_tpu_torch.cli exits 0 on the card",
                  done.returncode == 0 and "reconstructed" in done.stdout,
                  f"(rc {done.returncode}, {time.perf_counter() - t0:.1f} s"
                  f"{'; ' + done.stderr[-300:] if done.returncode else ''})")
    print(f"  phase 31 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def host_cost_per_launch(torch, jt, signal) -> tuple:
    """(µs through ``torch.ops.jwave.modwt_fwd``, µs through the
    launchers' eager entry ``modwt_fwd_op``, which calls the launch
    without the dispatcher) per launch of the forward kernel at
    a host-bound shape (1, 4096) L5: 200 launches a run between a
    synchronize and another, median of 5."""
    from jwave_pro_tpu_torch.kernels import _launch as kl
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc

    w = jt.wavelet(WAVELET)
    v = signal(1, 4096)
    taps = kl.op_taps(w)
    direct = kc.modwt_fwd_op

    def per_launch(fn):
        for _ in range(20):
            fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 200 * 1e6)
        return sorted(times)[2]

    op = per_launch(lambda: torch.ops.jwave.modwt_fwd(v, *taps, LEVEL))
    raw = per_launch(lambda: direct(v, *taps, LEVEL))
    return op, raw


def run_export_slice(smoke: Smoke, torch, jt, signal, card) -> None:
    """Phase 32: export and serving.  ``export_pipeline`` of the denoise
    (``method='auto'``: #1 and #3 shrinking), the fused denoise (#4) and the
    wavelet variance (#5) at MAIN_SHAPE, batch-polymorphic, to bytes and
    back; each served at SERVE_BATCHES from the one artifact in counted
    windows (its kernels once a call, nothing else) and bitwise the eager
    call.  An exported ``fwt`` L5 served with the process set to TF32
    (through either of torch's settings) within the 1e-5 IEEE bound of
    CPU f64 (phase 23's), beside an unpinned product's error.  And the
    operator route's host time per launch (``host_cost_per_launch``)
    beside ``modwt``'s wall and its kernel time."""
    import importlib

    fwt_mod = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")
    t_phase = time.perf_counter()
    print(f"== phase 32: export and serving {MAIN_SHAPE} {WAVELET} "
          f"L{LEVEL}", flush=True)
    w = jt.wavelet(WAVELET)
    x = signal(*MAIN_SHAPE)
    counters = all_launchers()
    pipelines = (
        ("modwt_denoise(threshold=0.8)",
         lambda v: jt.modwt_denoise(v, w, LEVEL, threshold=0.8),
         {"modwt_fwd": 1, "modwt_inv_shrink": 1}),
        ("modwt_denoise(threshold=0.8, method='fused')",
         lambda v: jt.modwt_denoise(v, w, LEVEL, threshold=0.8,
                                    method="fused"), {"modwt_denoise": 1}),
        ("modwt_variance", lambda v: jt.modwt_variance(v, w, LEVEL),
         {"modwt_var": 1}))
    for name, fn, want in pipelines:
        t0 = time.perf_counter()
        art = jt.export_pipeline(fn, x, batch_polymorphic=True)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = jt.load_pipeline(art)
        t_load = time.perf_counter() - t0
        print(f"  exported {name}: {len(art)} bytes, export {t_export:.2f} "
              f"s, load {t_load:.2f} s", flush=True)
        smoke.require(f"exported {name} is bytes", isinstance(art, bytes))
        for b in SERVE_BATCHES:
            got, _ = counted_run(smoke, torch, counters,
                                 f"served {name} at b = {b}",
                                 lambda: served(x[:b]), want)
            smoke.require(f"served {name} at b = {b}: bitwise the eager "
                          f"call", torch.equal(got, fn(x[:b])))
        print(f"  wall served {name} {MAIN_SHAPE}: "
              f"{wall_ms(torch, lambda: served(x)):.3f} ms, eager "
              f"{wall_ms(torch, lambda: fn(x)):.3f} ms (host clock, median "
              f"of 3) [{card}]", flush=True)
        del art, served
    # the exported fwt keeps its products in IEEE f32 under TF32
    art = jt.export_pipeline(lambda v: jt.fwt(v, w, LEVEL), x)
    served = jt.load_pipeline(art)
    ref = jt.fwt(host64(x[:2]), w, LEVEL)
    settings = [("matmul precision 'high'",
                 lambda: torch.set_float32_matmul_precision("high"))]
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        settings.append(("per-backend fp32_precision 'tf32'", lambda: setattr(
            torch.backends.cuda.matmul, "fp32_precision", "tf32")))
    for what, turn_on in settings:
        try:
            turn_on()
            y = served(x)
            xr = x[:2].reshape(-1, 256)
            wm = torch.from_numpy(fwt_mod._analysis_matrix_fused(
                (w,) * LEVEL)[:256]).to(x.device, torch.float32)
            unpinned = xr @ wm
        finally:
            torch.set_float32_matmul_precision("highest")
        rel_to(smoke, f"served fwt {MAIN_SHAPE} L{LEVEL} under {what} vs "
               f"CPU f64", y[:2], ref, 1e-5)
        print(f"  an unpinned product under {what} errs by "
              f"{max_err(unpinned, xr @ wm):.3e} (the pinned one's "
              f"yardstick)", flush=True)
        del y
    del art, served
    op_us, raw_us = host_cost_per_launch(torch, jt, signal)
    kernel = event_time(torch, lambda v: jt.modwt(v, w, LEVEL), x, k=10,
                        repeats=5) * 1e3
    wall = wall_ms(torch, lambda: jt.modwt(x, w, LEVEL))
    print(f"  operator route: {op_us:.2f} µs a launch through "
          f"torch.ops.jwave.modwt_fwd, {raw_us:.2f} µs through the "
          f"launchers' eager entry ({op_us - raw_us:.2f} µs the "
          f"dispatcher's; (1, 4096) L{LEVEL}, host clock); modwt "
          f"{MAIN_SHAPE} wall {wall:.3f} ms, {kernel:.4f} ms a call "
          f"between CUDA events [{card}]", flush=True)
    print(f"  phase 32 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def rel_card(smoke: Smoke, name: str, got, want, tol: float) -> float:
    """max|got − want| ≤ tol × max|want|, computed on the card in the
    tensors' own dtype (a DTensor gathered first)."""
    from torch.distributed.tensor import DTensor

    if isinstance(got, DTensor):
        got = got.full_tensor()
    scale = float(want.abs().max())
    return smoke.check(f"{name} (relative to max|ref| {scale:.3g})",
                       float((got - want).abs().max()) / scale, tol)


def sharded_calls(torch, jt, par, meshes, signal) -> list:
    """Phase 33's calls at bench.py's shapes: (name, sharded call, the
    port's single-device call, check), where check(smoke, got, want, x)
    holds the gathered result to the single-device one."""
    sig, sca, dat = meshes
    w, sym8 = jt.wavelet(WAVELET), jt.wavelet(WPT_WAVELET)
    mor, mh = jt.MorletWavelet(), jt.MexicanHat2D()
    x = signal(*MAIN_SHAPE)
    img = signal(*IMAGE_SHAPE)
    dimg = signal(*DEC_IMAGE)
    xw = signal(*WPT_SHAPE)
    xp = signal(*PACKET_SHAPE)
    xc = signal(*CWT_SHAPE)
    xi = signal(*CWT2_REAL)
    x1, x2 = signal(*SCAT1_SHAPE), signal(*SCAT2_SHAPE)
    cwt_scales = jt.generate_log_scales(1.0, 256.0, CWT_SCALES)
    long_scales = jt.generate_log_scales(*SHARD_CWT_SCALES, CWT_SCALES)
    fc = mor.center_frequency
    wide = jt.generate_log_scales(fc / 0.4, fc / 0.01, SSQ_WIDE_SCALES)
    s_real = jt.generate_log_scales(1.0, 16.0, CWT2_REAL_SCALES)
    c = jt.modwt(x, w, LEVEL)
    c2 = jt.modwt2(img, w, IMAGE_LEVEL)
    y = jt.fwt(x, w, LEVEL)
    d = jt.dtcwt(x, LEVEL)
    p = jt.wpt(xw, sym8, WPT_LEVEL)
    q = jt.modwpt(xp, w, PACKET_LEVEL)

    def fwd(smoke, name, got, want, inp):
        rel_card(smoke, name, got, want, 1e-5)

    def inv(smoke, name, got, want, inp):
        rel_card(smoke, name + " vs the single-device inverse", got, want,
                 1e-5)
        rel_card(smoke, name + " round trip", got, inp, 1e-4)

    def dtc(smoke, name, got, want, inp):
        for i, (g, v) in enumerate(zip(got.highpass, want.highpass)):
            rel_card(smoke, f"{name} highpass {i + 1}", g, v, 1e-5)
        rel_card(smoke, f"{name} lowpass a", got.lowpass_a, want.lowpass_a,
                 1e-5)
        rel_card(smoke, f"{name} lowpass b", got.lowpass_b, want.lowpass_b,
                 1e-5)

    def coeffs(smoke, name, got, want, inp):
        rel_card(smoke, name, got.coefficients, want.coefficients, 1e-5)

    def ssq(smoke, name, got, want, inp):
        tx = got.Tx.full_tensor()
        moved = int(((tx != 0) != (want.Tx != 0)).sum())
        smoke.require(f"{name}: every bin decision as ssq_cwt's on the "
                      f"card", moved == 0, f"({moved} differ)")
        rel_card(smoke, f"{name} Tx", tx, want.Tx, 1e-5)
        rel_card(smoke, f"{name} Wx", got.Wx, want.Wx, 1e-5)

    def scattering(smoke, name, got, want, inp):
        keep = got.pairs[:, 0] >= 0
        smoke.require(f"{name}: the unpadded pairs are the single-device "
                      f"ones", np.array_equal(got.pairs[keep], want.pairs))
        for order in ("s0", "s1"):
            rel_card(smoke, f"{name} {order}", getattr(got, order),
                     getattr(want, order), 1e-5)
        s2 = got.s2.full_tensor()    # (B, paths, ...): padding rows out
        rows = torch.from_numpy(np.nonzero(keep)[0]).to(s2.device)
        rel_card(smoke, f"{name} s2", s2.index_select(1, rows), want.s2,
                 1e-5)

    lv = f"{WAVELET} L{LEVEL} {MAIN_SHAPE}"
    return [
        (f"modwt_sharded {lv}", x, lambda: par.modwt_sharded(x, w, LEVEL, sig),
         lambda: jt.modwt(x, w, LEVEL), fwd),
        (f"imodwt_sharded {lv}", x, lambda: par.imodwt_sharded(c, w, sig),
         lambda: jt.imodwt(c, w), inv),
        (f"fwt_sharded {lv}", x, lambda: par.fwt_sharded(x, w, LEVEL, sig),
         lambda: jt.fwt(x, w, LEVEL), fwd),
        (f"ifwt_sharded {lv}", x,
         lambda: par.ifwt_sharded(y, w, LEVEL, sig),
         lambda: jt.ifwt(y, w, LEVEL), inv),
        (f"dtcwt_sharded L{LEVEL} {MAIN_SHAPE}", x,
         lambda: par.dtcwt_sharded(x, LEVEL, sig),
         lambda: jt.dtcwt(x, LEVEL), dtc),
        (f"idtcwt_sharded L{LEVEL} {MAIN_SHAPE}", x,
         lambda: par.idtcwt_sharded(d, sig), lambda: jt.idtcwt(d), inv),
        (f"modwt2_sharded {WAVELET} L{IMAGE_LEVEL} {IMAGE_SHAPE}", img,
         lambda: par.modwt2_sharded(img, w, IMAGE_LEVEL, sig),
         lambda: jt.modwt2(img, w, IMAGE_LEVEL), fwd),
        (f"imodwt2_sharded {WAVELET} L{IMAGE_LEVEL} {IMAGE_SHAPE}", img,
         lambda: par.imodwt2_sharded(c2, w, sig),
         lambda: jt.imodwt2(c2, w), inv),
        (f"fwt2_sharded {WAVELET} {DEC_IMAGE}", dimg,
         lambda: par.fwt2_sharded(dimg, w, dat), lambda: jt.fwt2(dimg, w),
         fwd),
        (f"wpt_sharded {WPT_WAVELET} L{WPT_LEVEL} {WPT_SHAPE}", xw,
         lambda: par.wpt_sharded(xw, sym8, WPT_LEVEL, sca),
         lambda: jt.wpt(xw, sym8, WPT_LEVEL), fwd),
        (f"iwpt_sharded {WPT_WAVELET} L{WPT_LEVEL} {WPT_SHAPE}", xw,
         lambda: par.iwpt_sharded(p, sym8, WPT_LEVEL, sca),
         lambda: jt.iwpt(p, sym8, WPT_LEVEL), inv),
        (f"modwpt_sharded {WAVELET} L{PACKET_LEVEL} {PACKET_SHAPE}", xp,
         lambda: par.modwpt_sharded(xp, w, PACKET_LEVEL, sca),
         lambda: jt.modwpt(xp, w, PACKET_LEVEL), fwd),
        (f"imodwpt_sharded {WAVELET} L{PACKET_LEVEL} {PACKET_SHAPE}", xp,
         lambda: par.imodwpt_sharded(q, w, sca),
         lambda: jt.imodwpt(q, w), inv),
        (f"cwt_sharded Morlet {CWT_SHAPE} S={CWT_SCALES}", xc,
         lambda: par.cwt_sharded(xc, cwt_scales, mor, sca),
         lambda: jt.cwt(xc, cwt_scales, mor), coeffs),
        (f"cwt_signal_sharded Morlet {CWT_SHAPE} S={CWT_SCALES} "
         f"a in {SHARD_CWT_SCALES}", xc,
         lambda: par.cwt_signal_sharded(xc, long_scales, mor, sig),
         lambda: jt.cwt(xc, long_scales, mor), coeffs),
        (f"ssq_sharded {SSQ_WIDE} S={SSQ_WIDE_SCALES}", xc,
         lambda: par.ssq_sharded(xc, wide, mesh=sca),
         lambda: jt.ssq_cwt(xc, wide), ssq),
        (f"cwt2_sharded MexicanHat2D {CWT2_REAL} S={CWT2_REAL_SCALES}", xi,
         lambda: par.cwt2_sharded(xi, s_real, mh, sca),
         lambda: jt.cwt2(xi, s_real, mh), coeffs),
        (f"scattering_sharded {SCAT1_SHAPE} J={SCAT1_J} Q={SCAT1_Q}", x1,
         lambda: par.scattering_sharded(x1, SCAT1_J, SCAT1_Q, mesh=sca),
         lambda: jt.scattering1d(x1, SCAT1_J, SCAT1_Q, oversampling=64),
         scattering),
        (f"scattering2d_sharded {SCAT2_SHAPE} J={SCAT2_J} L={SCAT2_L}", x2,
         lambda: par.scattering2d_sharded(x2, SCAT2_J, SCAT2_L, mesh=sca),
         lambda: jt.scattering2d(x2, SCAT2_J, SCAT2_L, oversampling=64),
         scattering),
    ]


def run_sharded_slice(smoke: Smoke, torch, jt, signal, card) -> None:
    """Phase 33: the sharded tier (``jwave_pro_tpu_torch.parallel``) over
    a one-rank NCCL world.  The world starts through ``init_distributed``
    (a file store in a temporary directory) and ends with the phase; a
    failure of NCCL fails the run.  All 19 transforms run on
    ``make_mesh`` meshes at bench.py's shapes, each gathered result held
    to the port's single-device call on the card (forwards 1e-5 ×
    max|ref|, round trips 1e-4, synchrosqueezing's bin decisions all the
    single-device ones); a counted window shows they launch two kernels,
    the forward's context variant for ``modwt_sharded`` and the CWT's
    (#14) for each of the two sharded CWTs, and none other (plain torch
    and collectives); each call's collectives posted (none on
    one rank) and its wall beside the single-device wall."""
    import tempfile

    import torch.distributed as dist

    from jwave_pro_tpu_torch import parallel as par
    from jwave_pro_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    print(f"== phase 33: the sharded tier over a one-rank NCCL world, f32, "
          f"against the single-device calls on {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        par.init_distributed(f"file://{tmp}/store", 1, 0,
                             device_type="cuda", timeout=600)
        try:
            probe = torch.ones(4, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            smoke.require(f"NCCL {torch.cuda.nccl.version()} world of "
                          f"{dist.get_world_size()} answers an all-reduce "
                          f"(backend {dist.get_backend()})",
                          float(probe.sum()) == 4.0)
            meshes = (par.make_mesh({"signal": 1}), par.make_mesh(
                {"scale": 1}), par.make_mesh())
            calls = sharded_calls(torch, jt, par, meshes, signal)
            def every_call():
                for _, _, run, _, _ in calls:
                    run()

            counted_run(smoke, torch, all_launchers(), "the sharded tier",
                        every_call, {"modwt_fwd_ctx": 1, "cwt_ifft": 2})
            for name, inp, run, single, check in calls:
                sharded.reset_collectives()
                got = run()
                torch.cuda.synchronize()
                posted = dict(sharded.COLLECTIVES)
                check(smoke, name, got, single(), inp)
                del got
                wall = wall_ms(torch, run)
                wall1 = wall_ms(torch, single)
                print(f"  {name}: wall {wall:.3f} ms, single-device "
                      f"{wall1:.3f} ms (host clock, median of 3); "
                      f"collectives posted {posted} [{card}]", flush=True)
            del calls
        finally:
            dist.destroy_process_group()
    print(f"  phase 33 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def trace_summary(events) -> dict:
    """A ``torch.profiler`` trace's device kernels summed by name
    (``{name: [events, µs]}``) and the device's busy share of the window
    (the kernels' summed durations over the span from the first kernel's
    start to the last one's end)."""
    kernels = [e for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    by_name = {}
    for e in kernels:
        entry = by_name.setdefault(e["name"], [0, 0.0])
        entry[0] += 1
        entry[1] += float(e["dur"])
    busy = None
    if kernels:
        span = (max(e["ts"] + e["dur"] for e in kernels)
                - min(e["ts"] for e in kernels))
        busy = sum(e["dur"] for e in kernels) / span if span > 0 else None
    return {"kernels": by_name, "busy": busy}


def run_profiling_slice(smoke: Smoke, torch, jt, signal, card) -> None:
    """Phase 34: the north star measured as ``bench.py:39-70`` defines it,
    through the port's ``utils.profiling.measure_samples_per_sec`` with
    the JAX package's defaults (chains of 4 and 24 steps, 3 repeats):
    ``bench_modwt``'s step ``modwt(v)[L]`` at (32, 2²⁰) f32 Db4 L5 (in
    eager torch nothing is dead-code-eliminated, so it is the kernel
    branch) and ``bench_modwt_roundtrip``'s ``imodwt(modwt(v))`` at
    (8, 2²⁰), each in a counted window of (4 + 24)·(1 + 3) launches of
    each kernel it runs, each rate held to at most 1.05 × the rate at its
    kernels' bound; then three chained forward steps inside
    ``utils.profiling.trace``, whose trace must hold the forward kernel
    with device time, and after it a steady trace of 24 chained steps,
    whose file gives the top kernels by device time and the device's busy
    share (the first trace takes the profiler's start-up host work, which
    would otherwise set the busy share of a short window)."""
    import tempfile

    from jwave_pro_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    print(f"== phase 34: the north star through measure_samples_per_sec "
          f"(chains {CHAIN_SHORT}/{CHAIN_LONG}, {CHAIN_REPEATS} repeats, "
          f"CUDA events) on {card}", flush=True)
    w = jt.wavelet(WAVELET)
    chained = (CHAIN_SHORT + CHAIN_LONG) * (1 + CHAIN_REPEATS)

    def step(v):
        return jt.modwt(v, w, LEVEL)[LEVEL]

    def roundtrip(v):
        return jt.imodwt(jt.modwt(v, w, LEVEL), w)

    m = w.length
    x = signal(*MAIN_SHAPE)
    for name, fn, arg, want in (
            (f"north star modwt {WAVELET} L{LEVEL}", step, x,
             {"modwt_fwd": chained}),
            (f"round trip imodwt(modwt) {WAVELET} L{LEVEL}", roundtrip,
             signal(*ROUNDTRIP_SHAPE),
             {"modwt_fwd": chained, "modwt_inv": chained})):
        rate, _ = counted_run(
            smoke, torch, all_launchers(), f"the {name} chains",
            lambda: profiling.measure_samples_per_sec(
                fn, arg, CHAIN_SHORT, CHAIN_LONG, CHAIN_REPEATS), want)
        # a forward, or a forward and an inverse: the same bytes and flops
        cells, passes = arg.numel(), len(want)
        bound_ms, by = bound(4 * cells * (LEVEL + 2) * passes,
                             cells * 4 * m * LEVEL * passes)
        bound_rate = cells / bound_ms * 1e3
        print(f"  {name} {tuple(arg.shape)} f32: {rate:.6e} samples/s, "
              f"{cells / rate * 1e3:.4f} ms a step; at its kernels' bound "
              f"{bound_ms:.4f} ms ({by}) {bound_rate:.6e} samples/s, "
              f"{rate / bound_rate:.1%} of it [{card}]", flush=True)
        smoke.require(f"{name}: rate positive and at most 1.05 × the "
                      f"bound's", 0 < rate <= 1.05 * bound_rate,
                      f"({rate:.4e} against {bound_rate:.4e} samples/s)")
        del arg

    def traced(steps, logdir):
        """The trace of ``steps`` chained forward steps, summarised; None
        if ``trace`` wrote no single file or it lacks the forward kernel's
        device time."""
        v = x
        torch.cuda.synchronize()
        with profiling.trace(logdir):
            for _ in range(steps):
                v = step(v)
            torch.cuda.synchronize()
        files = sorted(Path(logdir).glob("*.pt.trace.json"))
        smoke.require(f"utils.profiling.trace of {steps} steps wrote one "
                      f"trace file", len(files) == 1,
                      f"({[f.name for f in files]})")
        if len(files) != 1:
            return None
        summary = trace_summary(json.loads(files[0].read_text())[
            "traceEvents"])
        fwd = [entry for name, entry in summary["kernels"].items()
               if "jw_modwt_fwd_kernel" in name]
        ok = (sum(c for c, _ in fwd) == steps
              and sum(us for _, us in fwd) > 0)
        smoke.require(f"trace of {steps} steps holds jw_modwt_fwd_kernel "
                      f"{steps} times with device time", ok, f"({fwd})")
        return summary if ok else None

    with tempfile.TemporaryDirectory() as tmp:
        first = traced(TRACE_STEPS, Path(tmp) / "first")
        steady = traced(STEADY_TRACE_STEPS, Path(tmp) / "steady")
    if first is None or steady is None:
        return
    top = sorted(steady["kernels"].items(), key=lambda kv: -kv[1][1])[:5]
    for name, (count, us) in top:
        print(f"  trace kernel {name[:96]}: {count} events, {us:.1f} µs "
              f"[{card}]", flush=True)
    for label, summary, steps in (("first", first, TRACE_STEPS),
                                  ("steady", steady, STEADY_TRACE_STEPS)):
        print(f"  {label} trace of {steps} chained steps: device busy "
              f"{summary['busy']:.1%} of the span from the first kernel's "
              f"start to the last one's end [{card}]", flush=True)
    print(f"  phase 34 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def run_median_slice(smoke: Smoke, torch, jt, signal, card) -> tuple:
    """Phase 35: the threshold's median kernel (#15) against its plain
    version and the sort path (``ops/denoise.py:_sort_median``), bitwise,
    at MEDIAN_SHAPES and at small and NaN rows; one default
    ``modwt_denoise`` in a counted window (one median launch); the kernel
    timed at MEDIAN_SHAPES beside its one-read bound, its plain version and
    the sort-median (``library_ms``: the yardstick, never called by the
    port); the walls of the fused denoise at MAIN_SHAPE and the 2D denoise
    at IMAGE_SHAPE with the kernel, and with the sort path in its place
    (before), in the order sort, kernel, kernel, sort.  Returns the
    kernel's (launches, errors, times, library times)."""
    from jwave_pro_tpu_torch.kernels import median_cuda as km
    from jwave_pro_tpu_torch.ops import denoise as dn

    t_phase = time.perf_counter()
    print(f"== phase 35: the threshold's median kernel (#15) on {card}",
          flush=True)
    w = jt.wavelet(WAVELET)

    def bits_err(got, want) -> float:
        """0 where the bits agree, else the largest |difference| (inf
        where only one is NaN)."""
        if torch.equal(got.view(torch.int32), want.view(torch.int32)):
            return 0.0
        return max_err(got.nan_to_num(math.inf), want.nan_to_num(math.inf)
                       ) or math.inf

    err = 0.0
    shapes = ((1, 1), (3, 2), (16, 1001), (16, 100003)) + MEDIAN_SHAPES
    for shape in shapes:
        x = signal(*shape)
        if shape[0] > 8:
            x[1, 0] = math.nan
        got = km.median_op(x, True)
        for what, want in (("plain", km.median_plain(x, True)),
                           ("sort", dn._sort_median(x.abs(), -1))):
            e = bits_err(got, want)
            err = max(err, e)
            smoke.require(f"median kernel {shape} = {what} bitwise", e == 0)
    x = signal(16, 300007)
    _, got = counted_run(smoke, torch, all_launchers() + ("median",),
                         "a default modwt_denoise (16, 300007)",
                         lambda: jt.modwt_denoise(x, w, LEVEL),
                         {"modwt_fwd": 1, "modwt_inv_shrink": 1, "median": 1})
    times, library = {}, {}
    for shape in MEDIAN_SHAPES:
        x = signal(*shape)
        tk, tp = time_pair(torch, lambda v: km.median_op(v, True),
                           lambda v: km.median_plain(v, True), x)
        ts = event_time(torch, lambda v: dn._sort_median(v.abs(), -1), x,
                        k=5) * 1e3
        bound_ms, by = bound(4 * x.numel(), 0)
        print(f"  median |x| {shape}: kernel {tk:.4f} ms, plain {tp:.4f} "
              f"ms, sort-median {ts:.4f} ms, bound {bound_ms:.4f} ms ({by}),"
              f" {bound_ms / tk:.1%} of it [{card}]", flush=True)
        if shape == MEDIAN_SHAPES[0]:
            times["median"], library["median"] = (tk, tp), ts
    kernel_median = dn._median

    def sort_median(a, axis, absolute=False):
        return dn._sort_median(torch.abs(a) if absolute else a, axis)

    for what, arg, call in (
            (f"modwt_denoise(method='fused') {MAIN_SHAPE}",
             signal(*MAIN_SHAPE),
             lambda v: jt.modwt_denoise(v, w, LEVEL, method="fused")),
            (f"modwt2_denoise {IMAGE_SHAPE} L{IMAGE_LEVEL}",
             signal(*IMAGE_SHAPE),
             lambda v: jt.modwt2_denoise(v, w, IMAGE_LEVEL))):
        walls = {"kernel": [], "sort": []}
        try:
            for side in ("sort", "kernel", "kernel", "sort"):
                dn._median = kernel_median if side == "kernel" \
                    else sort_median
                walls[side].append(wall_ms(torch, lambda: call(arg)))
        finally:
            dn._median = kernel_median
        print(f"  wall {what}: {statistics.mean(walls['kernel']):.3f} ms "
              f"with the kernel, {statistics.mean(walls['sort']):.3f} ms "
              f"with the sort path (host clock, median of 3, two turns "
              f"each) [{card}]", flush=True)
        del arg
    print(f"  phase 35 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"median": got["median"]}, {"median": err}, times, library


def run_shard_slice(smoke: Smoke, torch, jt, signal, card) -> tuple:
    """Phase 36: the forward's context variant (``jwave::modwt_fwd_ctx``,
    one shard of a longer signal, the samples before it given) against its
    plain model at the forward's edges, f32 and bf16, and bitwise the
    forward kernel where the context is the row's own wrapped end; one
    launch at the sharded cell's shard SHARD_SHAPE (6.4·10⁹ outputs, past
    2³¹) held to the float64 segment reference
    (``wavebench/reference/modwt_segment.py``) on W₁'s first block, a
    block of W₃ in the middle and V₅'s last block, 1e-5 absolute; timed
    at MAIN_SHAPE and SHARD_SHAPE beside the forward kernel and the
    bound.  Returns (launches, errors, times) under ``modwt_fwd_ctx``."""
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
    from jwave_pro_tpu_torch.kernels._launch import LAUNCHES
    from wavebench.reference import filters
    from wavebench.reference import modwt_segment as seg

    t_phase = time.perf_counter()
    print(f"== phase 36: the forward's context variant on {card}",
          flush=True)
    w = jt.wavelet(WAVELET)
    err = 0.0
    for b, n, lvl, name in FWD_EDGES + ((8, 4096, LEVEL, WAVELET),
                                        (3, 100, LEVEL, WAVELET)):
        wv = jt.wavelet(name)
        h = kc.halo(wv.length, lvl)
        for dtype in (torch.float32, torch.bfloat16):
            x, ctx = signal(b, n, dtype=dtype), signal(b, h, dtype=dtype)
            got = kc.modwt_fwd_ctx_cuda(x, ctx, wv, lvl)
            e = max_err(got, kc.modwt_fwd_ctx_plain(x, ctx, wv, lvl))
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            smoke.check(f"fwd_ctx ({b}, {n}) {name} L{lvl} {dtype} vs "
                        f"plain", e, tol)
            if dtype == torch.float32:
                err = max(err, e)
            own = x[:, torch.arange(-h, 0, device=x.device) % n]
            smoke.require(f"fwd_ctx ({b}, {n}) {name} L{lvl} {dtype} with "
                          f"the row's own end = the forward bitwise",
                          torch.equal(kc.modwt_fwd_ctx_cuda(
                              x, own.contiguous(), wv, lvl),
                              kc.modwt_fwd_cuda(x, wv, lvl)))
    rows, n = SHARD_SHAPE
    h = kc.halo(w.length, LEVEL)
    dev = signal(1, 1).device
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def large(*shape):
        # the shard's 10⁹ samples made on the card, not through the host
        return torch.randn(shape, generator=gen, device=dev)

    x, ctx = large(rows, n), large(rows, h)
    before = LAUNCHES["modwt_fwd_ctx"]
    c = kc.modwt_fwd_ctx_cuda(x, ctx, w, LEVEL)
    torch.cuda.synchronize()
    launched = LAUNCHES["modwt_fwd_ctx"] - before
    smoke.require(f"fwd_ctx {SHARD_SHAPE}: one launch, {c.numel():.3e} "
                  f"outputs", launched == 1 and c.numel() > 2 ** 31)
    f = filters.BY_NAME[WAVELET]
    for row, start in ((0, 0), (2, n // 2), (LEVEL, n - SHARD_BLOCK)):
        want = seg.modwt_segment(x, ctx, f, LEVEL, start, SHARD_BLOCK)[row]
        e = max_err(c[row, :, start:start + SHARD_BLOCK].double(), want)
        smoke.check(f"fwd_ctx {SHARD_SHAPE} row {row} columns {start}+"
                    f"{SHARD_BLOCK} vs f64 segment reference", e, 1e-5)
    del c
    del x, ctx
    times = {}
    for shape, k in ((MAIN_SHAPE, 10), (SHARD_SHAPE, 3)):
        rows, n = shape
        x, ctx = large(rows, n), large(rows, h)
        tc1 = event_time(torch, lambda v: kc.modwt_fwd_ctx_cuda(
            v, ctx, w, LEVEL), x, k=k, repeats=3) * 1e3
        tf = event_time(torch, lambda v: kc.modwt_fwd_cuda(v, w, LEVEL), x,
                        k=k, repeats=3) * 1e3
        tc2 = event_time(torch, lambda v: kc.modwt_fwd_ctx_cuda(
            v, ctx, w, LEVEL), x, k=k, repeats=3) * 1e3
        tc = (tc1 + tc2) / 2
        cells = rows * n
        bound_ms, by = bound(4 * cells * (LEVEL + 2) + 4 * rows * h,
                             cells * 4 * w.length * LEVEL)
        print(f"  fwd_ctx {shape}: kernel {tc:.4f} ms, the forward "
              f"{tf:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"{bound_ms / tc:.1%} of it [{card}]", flush=True)
        if shape == MAIN_SHAPE:
            tp = event_time(torch, lambda v: kc.modwt_fwd_ctx_plain(
                v, ctx, w, LEVEL), x, k=2, repeats=3) * 1e3
            times["modwt_fwd_ctx"] = (tc, tp)
        del x, ctx
    torch.cuda.empty_cache()
    print(f"  phase 36 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"modwt_fwd_ctx": launched}, {"modwt_fwd_ctx": err}, times


def run_inv_shrink_slice(smoke: Smoke, torch, jt, signal, card) -> tuple:
    """Phase 37: the inverse that shrinks its detail rows as it loads them
    (``jwave::modwt_inv_shrink``) against the pipeline it replaces, the
    shrink and ``imodwt`` on the inverse kernel, bit for bit, at the
    inverse's edges, f32 and bf16, soft and hard, for a number, a
    threshold a signal and one a level and signal, a NaN and both zeros
    among the details; against its plain model within the inverse's
    bound; one default ``modwt_denoise`` (16, 1 000 003) in a counted
    window (the forward, the median and the shrinking inverse once, the
    plain inverse never), its output bitwise the pipeline it replaces
    (``modwt``, the universal threshold, the shrink and ``imodwt``) on the
    same input; at SHRINK_SHAPES, with the universal threshold, bitwise
    that pipeline and within 1e-4 of its plain model, then timed beside
    the pipeline (#3, the shrink's passes and the ``cat``) and #3 alone,
    in the order pipeline, kernel, kernel, pipeline, with the bound of
    #3's 7 planes.  Returns (launches, errors, times) under
    ``modwt_inv_shrink``; the error is the one at MAIN_SHAPE."""
    from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
    from jwave_pro_tpu_torch.ops import denoise as dn

    t_phase = time.perf_counter()
    print(f"== phase 37: the shrinking inverse on {card}", flush=True)
    w = jt.wavelet(WAVELET)

    def bits(a, b) -> bool:
        a, b = a.float(), b.float()
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (a.isnan() & b.isnan())).all())

    for b, n, lvl, name in INV_EDGES:
        wv = jt.wavelet(name)
        for dtype in (torch.float32, torch.bfloat16):
            c = signal(lvl + 1, b, n, dtype=dtype)
            c[0, 0, 5] = math.nan
            c[1, -1, 7], c[1, -1, 8] = 0.0, -0.0
            dev = c.device
            for kind, t in (
                    ("0.8", 0.8),
                    ("(B, 1)", torch.linspace(0.2, 1.0, b, device=dev,
                                              dtype=dtype)[:, None]),
                    ("(L, B, 1)", torch.linspace(
                        0.1, 1.5, lvl * b, device=dev,
                        dtype=dtype).reshape(lvl, b, 1))):
                for mode in ("soft", "hard"):
                    hard = int(mode != "soft")
                    ops = dn._shrink_operands(c, t, wv, hard)
                    got = kc.modwt_inv_shrink_cuda(c, *ops, wv, hard)
                    want = jt.imodwt(dn._shrunk(c, lvl, t, mode), wv)
                    smoke.require(f"inv_shrink ({b}, {n}) {name} L{lvl} "
                                  f"{dtype} {mode} t {kind} = shrink and "
                                  f"imodwt bitwise", bits(got, want))
                    plain = kc.modwt_inv_shrink_plain(c, *ops, wv, hard)
                    e = max_err(got.nan_to_num(0.0), plain.nan_to_num(0.0))
                    smoke.check(f"inv_shrink ({b}, {n}) {name} L{lvl} "
                                f"{dtype} {mode} t {kind} vs plain", e,
                                1e-4 if dtype == torch.float32 else 5e-2)

    def pipeline(c, t):
        """What the denoise ran before the shrink moved into #3."""
        return jt.imodwt(dn._shrunk(c, LEVEL, t, "soft"), w)

    def universal(c):
        return dn._rule_threshold("universal", c[0], c[:LEVEL],
                                  c.shape[-1])[..., None]

    x = signal(16, 1_000_003)
    out, got = counted_run(smoke, torch, all_launchers() + ("median",),
                           "a default modwt_denoise (16, 1000003)",
                           lambda: jt.modwt_denoise(x, w, LEVEL),
                           {"modwt_fwd": 1, "median": 1,
                            "modwt_inv_shrink": 1})
    c = jt.modwt(x, w, LEVEL)
    smoke.require("a default modwt_denoise (16, 1000003) = modwt, the "
                  "universal threshold, the shrink and imodwt bitwise",
                  bits(out, pipeline(c, universal(c))))
    del x, c, out
    times, err = {}, math.inf
    for shape in SHRINK_SHAPES:
        rows, n = shape
        c = kc.modwt_fwd_cuda(signal(*shape), w, LEVEL)
        t = universal(c)
        ops = dn._shrink_operands(c, t, w, 0)
        cut = lambda v: kc.modwt_inv_shrink_cuda(v, *ops, w, 0)  # noqa: E731
        before = lambda v: pipeline(v, t)  # noqa: E731
        got_c = cut(c)
        smoke.require(f"inv_shrink {shape} = shrink and imodwt bitwise",
                      bits(got_c, before(c)))
        e = smoke.check(f"inv_shrink {shape} vs plain", max_err(
            got_c, kc.modwt_inv_shrink_plain(c, *ops, w, 0)), 1e-4)
        del got_c
        if shape == MAIN_SHAPE:
            err = e
        tb1 = event_time(torch, before, c, k=10, repeats=3) * 1e3
        tk1 = event_time(torch, cut, c, k=10, repeats=3) * 1e3
        tk2 = event_time(torch, cut, c, k=10, repeats=3) * 1e3
        tb2 = event_time(torch, before, c, k=10, repeats=3) * 1e3
        tinv = event_time(torch, lambda v: kc.modwt_inv_cuda(v, w), c, k=10,
                          repeats=3) * 1e3
        tk, tb = (tk1 + tk2) / 2, (tb1 + tb2) / 2
        bound_ms, by = bound(4 * rows * n * (LEVEL + 2) + 4 * rows * LEVEL,
                             rows * n * (4 * w.length + 3) * LEVEL)
        print(f"  inv_shrink {shape}: kernel {tk:.4f} ms; #3, the shrink "
              f"and the cat {tb:.4f} ms ({tb / tk:.2f}x); #3 alone "
              f"{tinv:.4f} ms; bound {bound_ms:.4f} ms ({by}), "
              f"{bound_ms / tk:.1%} of it [{card}]", flush=True)
        if shape == MAIN_SHAPE:
            tp = event_time(torch, lambda v: kc.modwt_inv_shrink_plain(
                v, *ops, w, 0), c, k=2, repeats=3) * 1e3
            print(f"  inv_shrink {shape}: plain version {tp:.4f} ms "
                  f"[{card}]", flush=True)
            times["modwt_inv_shrink"] = (tk, tp)
        del c, t, ops
    torch.cuda.empty_cache()
    print(f"  phase 37 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return ({"modwt_inv_shrink": got["modwt_inv_shrink"]},
            {"modwt_inv_shrink": err}, times)


def run_inv2_shrink_slice(smoke: Smoke, torch, jt, signal, card) -> tuple:
    """Phase 38: the 2D inverse that shrinks its detail bands as it loads
    them (``jwave::modwt2_inv_shrink``, #10s) against the pipeline it
    replaces, the shrink and ``imodwt2`` on the 2D inverse kernel #10, bit
    for bit, at INV2_SHRINK_EDGES, f32 and bf16, soft and hard, for a
    number, a threshold an image and one a band and image, a NaN and both
    zeros among the details; against its plain model within the 2D
    inverse's bound; one default ``modwt2_denoise`` at IMAGE_SHAPE in a
    counted window (the 2D forward, the median and #10s once, #10 never),
    its output bitwise the pipeline it replaces (``modwt2``, the universal
    threshold, the shrink and ``imodwt2``) on the same input; on that
    input's (10, 16, 2048²) coefficients with the universal threshold,
    bitwise that pipeline and within 1e-4 of its plain model, then timed
    beside the pipeline (#10, the shrink's passes and the ``cat``) and #10
    alone, in the order pipeline, kernel, kernel, pipeline, with the bound
    of #10's bands and the thresholds.  Returns (launches, errors, times)
    under ``modwt2_inv_shrink``."""
    from jwave_pro_tpu_torch.kernels import modwt2_cuda as k2
    from jwave_pro_tpu_torch.ops import denoise as dn

    t_phase = time.perf_counter()
    print(f"== phase 38: the 2D shrinking inverse on {card}", flush=True)
    w = jt.wavelet(WAVELET)
    lvl = IMAGE_LEVEL
    bands = 3 * lvl

    def bits(a, b) -> bool:
        a, b = a.float(), b.float()
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (a.isnan() & b.isnan())).all())

    for b, r, cols, level, name in INV2_SHRINK_EDGES:
        wv = jt.wavelet(name)
        nb = 3 * level
        for dtype in (torch.float32, torch.bfloat16):
            c = signal(nb + 1, b, r, cols, dtype=dtype)
            c[0, 0, 1, 5] = math.nan
            c[1, -1, 2, 7], c[1, -1, 2, 8] = 0.0, -0.0
            dev = c.device
            for kind, t in (
                    ("0.8", 0.8),
                    ("(B, 1, 1)", torch.linspace(
                        0.2, 1.0, b, device=dev,
                        dtype=dtype).reshape(b, 1, 1)),
                    ("(3L, B, 1, 1)", torch.linspace(
                        0.1, 1.5, nb * b, device=dev,
                        dtype=dtype).reshape(nb, b, 1, 1))):
                for mode in ("soft", "hard"):
                    hard = int(mode != "soft")
                    ops = dn._shrink2_operands(c, t, wv, hard)
                    got = k2.modwt2_inv_shrink_cuda(c, *ops, wv, hard)
                    want = jt.imodwt2(dn._shrunk(c, nb, t, mode), wv)
                    tag = (f"inv2_shrink ({b}, {r}, {cols}) {name} L{level} "
                           f"{dtype} {mode} t {kind}")
                    smoke.require(f"{tag} = shrink and imodwt2 bitwise",
                                  bits(got, want))
                    plain = k2.modwt2_inv_shrink_plain(c, *ops, wv, hard)
                    e = max_err(got.nan_to_num(0.0), plain.nan_to_num(0.0))
                    smoke.check(f"{tag} vs plain", e,
                                1e-4 if dtype == torch.float32 else 5e-2)

    def pipeline(c, t):
        """What the 2D denoise ran before the shrink moved into #10."""
        return jt.imodwt2(dn._shrunk(c, bands, t, "soft"), w)

    def universal(c):
        hh1 = c[2].flatten(-2)
        return dn._rule_threshold("universal", hh1, c[:bands].flatten(-2),
                                  hh1.shape[-1])[..., None, None]

    x = signal(*IMAGE_SHAPE)
    out, got = counted_run(smoke, torch, all_launchers() + ("median",),
                           f"a default modwt2_denoise {IMAGE_SHAPE}",
                           lambda: jt.modwt2_denoise(x, w, lvl),
                           {"modwt2_fwd": 1, "median": 1,
                            "modwt2_inv_shrink": 1})
    c = k2.modwt2_fwd_cuda(x, w, lvl)
    del x
    t = universal(c)
    smoke.require(f"a default modwt2_denoise {IMAGE_SHAPE} = modwt2, the "
                  f"universal threshold, the shrink and imodwt2 bitwise",
                  bits(out, pipeline(c, t)))
    del out
    ops = dn._shrink2_operands(c, t, w, 0)
    cut = lambda v: k2.modwt2_inv_shrink_cuda(v, *ops, w, 0)  # noqa: E731
    before = lambda v: pipeline(v, t)  # noqa: E731
    got_c = cut(c)
    shape = tuple(c.shape)
    smoke.require(f"inv2_shrink {shape} = shrink and imodwt2 bitwise",
                  bits(got_c, before(c)))
    err = smoke.check(f"inv2_shrink {shape} vs plain", max_err(
        got_c, k2.modwt2_inv_shrink_plain(c, *ops, w, 0)), 1e-4)
    del got_c
    torch.cuda.empty_cache()
    tb1 = event_time(torch, before, c, k=5, repeats=3) * 1e3
    tk1 = event_time(torch, cut, c, k=10, repeats=3) * 1e3
    tk2 = event_time(torch, cut, c, k=10, repeats=3) * 1e3
    tb2 = event_time(torch, before, c, k=5, repeats=3) * 1e3
    tinv = event_time(torch, lambda v: k2.modwt2_inv_cuda(v, w), c, k=10,
                      repeats=3) * 1e3
    tk, tb = (tk1 + tk2) / 2, (tb1 + tb2) / 2
    img = math.prod(IMAGE_SHAPE)
    bound_ms, by = bound(4 * img * (bands + 2) + 4 * IMAGE_SHAPE[0] * bands,
                         img * (12 * w.length + 9) * lvl)
    print(f"  inv2_shrink {shape}: kernel {tk:.4f} ms ({tk1:.4f}, "
          f"{tk2:.4f}); #10, the shrink and the cat {tb:.4f} ms ({tb1:.4f}, "
          f"{tb2:.4f}; {tb / tk:.2f}x); #10 alone {tinv:.4f} ms "
          f"(#10s {tk / tinv - 1:+.1%}); bound {bound_ms:.4f} ms ({by}), "
          f"{bound_ms / tk:.1%} of it [{card}]", flush=True)
    tp = event_time(torch, lambda v: k2.modwt2_inv_shrink_plain(
        v, *ops, w, 0), c, k=2, repeats=3) * 1e3
    print(f"  inv2_shrink {shape}: plain version {tp:.4f} ms [{card}]",
          flush=True)
    del c, t, ops
    torch.cuda.empty_cache()
    print(f"  phase 38 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return ({"modwt2_inv_shrink": got["modwt2_inv_shrink"]},
            {"modwt2_inv_shrink": err}, {"modwt2_inv_shrink": (tk, tp)})


def run_wpt_cell_slice(smoke: Smoke, torch, jt, card) -> None:
    """Phase 39: the packet denoise cell's call, ``wpt_denoise`` of
    WPT_CELL_SHAPE Symlet 8 L6 with a basis a row, on the cell's own
    signals: its 36 products in IEEE float32 and one launch (the median)
    a call, no host synchronisation inside it, each of its five spans once
    under a profiler, WPT_CELL_ROWS seeded rows held to the float64
    reference under the cell's check (``wavebench/reference/wpt.py:
    error``, the cell's limit); the float32 tree of those rows against the
    float64 tree in units of the check's modelled σ, and each packet's
    SURE cost within the check's bound of the float64 cost; the call's
    time, peak memory and bound."""
    import importlib
    import warnings

    from wavebench import traffic
    from wavebench.entries import wpt_denoise as cell
    from wavebench.reference import wpt as ref

    fwt_ops = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")
    wpt_ops = importlib.import_module("jwave_pro_tpu_torch.ops.wpt")
    t_phase = time.perf_counter()
    print(f"== phase 39: the packet denoise cell's call on {card}",
          flush=True)
    root = Path(__file__).resolve().parent / "wavebench"
    work = json.loads((root / "workloads" / "wpt_sym8_l6.denoise.json")
                      .read_text())
    limit = work["check"]["limits"]["wpt_err"]
    w = jt.wavelet("Symlet 8")
    level = 6
    b, n = WPT_CELL_SHAPE
    dev = torch.device("cuda", 0)
    x = cell.signals(work["signal"], b, n,
                     traffic.generator(WPT_CELL_SEED, dev), dev)
    call = lambda: jt.wpt_denoise(x, w, level, per_sample=True)  # noqa: E731
    call()
    before = fwt_ops.PRODUCTS.copy()
    out, _ = counted_run(smoke, torch, all_launchers() + ("median",),
                         f"a wpt_denoise {WPT_CELL_SHAPE}", call,
                         {"median": 1})
    made = {k: fwt_ops.PRODUCTS[k] - before[k] for k in fwt_ops.PRODUCTS
            if fwt_ops.PRODUCTS[k] != before[k]}
    print(f"  products of a wpt_denoise {WPT_CELL_SHAPE}: {made}",
          flush=True)
    smoke.require("36 products, all IEEE float32", made == {"ieee": 36},
                  f"(got {made})")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    smoke.require("no host synchronisation inside the call", not syncs,
                  f"({[str(m.message)[:100] for m in syncs[:3]]})")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("jwave."))
    spans = ("jwave.wpt_denoise", "jwave.wpt.tree", "jwave.wpt.basis",
             "jwave.denoise.threshold", "jwave.wpt.reconstruct")
    print(f"  spans of a profiled call: {dict(names)}", flush=True)
    smoke.require("each of the five spans once a call",
                  all(names[s] == 1 for s in spans))
    rows = sorted(np.random.default_rng(WPT_CELL_SEED).choice(
        b, WPT_CELL_ROWS, replace=False).tolist())
    err, bases, opened = ref.error(out[rows], x[rows], ref.SYMLET_8, level)
    print(f"  wpt_err {err:.3e} (limit {limit:g}) on rows {rows}; at most "
          f"{bases} bases and {opened} open packets a row", flush=True)
    smoke.require("the cell's check passes", err <= limit
                  and bases <= ref.MAX_BASES)
    del out
    tree32 = jt.wpt_tree(x, w, level)[:, rows].double()
    tree64 = ref.tree(x[rows], ref.SYMLET_8, level)
    sigma = ref.deviation(tree64, ref.SYMLET_8)
    ratio = float(((tree32 - tree64)[1:].abs() / sigma[1:]).max())
    print(f"  float32 tree: max |error| / modelled sigma {ratio:.3f} "
          f"(the check admits {ref.DEVIATIONS:g}; the CPU's 2.80)",
          flush=True)
    smoke.require("the float32 tree within the check's deviations",
                  ratio <= ref.DEVIATIONS)
    bounds = ref.cost_bounds(tree64, ref.SYMLET_8)
    worst = 0.0
    for lv in range(level + 1):
        got = wpt_ops.sure_cost(ref.packets(tree32.float(), lv)).double()
        want = ref.sure(ref.packets(tree64, lv))
        worst = max(worst, float(((got - want).abs() / bounds[lv]).max()))
    print(f"  SURE costs: max |float32 - float64| / bound {worst:.3f}",
          flush=True)
    smoke.require("each packet's cost within the check's bound", worst <= 1)
    del tree32, tree64, sigma
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = event_time(torch, lambda v: jt.wpt_denoise(v, w, level,
                                                    per_sample=True),
                    x, k=5, repeats=3) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    samples = b * n
    bound_ms, by = bound(4 * (2 * samples + b),
                         samples * (4 * w.length * level + 4 * (level + 1)
                                    + 3))
    print(f"  wpt_denoise {WPT_CELL_SHAPE}: {ms:.3f} ms a call "
          f"({samples / ms * 1e3:.4e} samples/s), {peak:.3f} GiB above its "
          f"input; bound {bound_ms:.4f} ms ({by}), {bound_ms / ms:.2%} of "
          f"it [{card}]", flush=True)
    del x
    torch.cuda.empty_cache()
    print(f"  phase 39 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


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
