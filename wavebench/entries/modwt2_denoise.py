"""``modwt2_denoise(x, wavelet, level)`` with its defaults: the universal
threshold from each frame's finest diagonal band, soft shrinkage of every
detail band, the inverse, of a (frames, R, C) float32 stack.

The frames are synthetic fluorescence images made on the device from the
seed (:func:`frames`).  The check compares every pixel of a few seeded
frames, the same places in each of a few sampled stacks, with the
float64 reference, one frame at a time.
"""
from __future__ import annotations

import torch

import jwave_pro_tpu_torch as jt

from .. import traffic
from ..reference import compare, filters
from ..reference import modwt2 as ref
from .pool import PoolEntry


def frames(spec: dict, count: int, shape, gen: torch.Generator, device
           ) -> torch.Tensor:
    """A (count, R, C) float32 stack of fluorescence frames.

    Each frame: a background ``b`` uniform in ``background`` under a broad
    illumination profile, b·(1 + ½·exp(−((r − r₀)² + (c − c₀)²)/(2s²)))
    with (r₀, c₀) uniform in the middle half of the frame and s a share
    uniform in ``illumination`` of its smaller side; ``spots`` (a whole number uniform in the range) Gaussian spots,
    each at a uniform position, of width σ uniform in ``width`` pixels
    and peak uniform in ``brightness``; and additive Gaussian noise of
    standard deviation ``noise`` times the median of the frame's spot
    peaks.  Every term is separable, so a frame is one product of a
    (R, K) and a (K, C) matrix, made in float64 and rounded once."""
    if spec["kind"] != "fluorescence":
        raise ValueError(f"unknown frame kind {spec['kind']!r}")
    rows, cols = shape
    lo, hi = spec["spots"]
    f64 = dict(device=device, dtype=torch.float64)

    def uniform(lo_hi, size):
        a, b = lo_hi
        return a + (b - a) * torch.rand(size, generator=gen, **f64)

    counts = torch.randint(lo, hi + 1, (count,), generator=gen,
                           device=device)
    active = torch.arange(hi, device=device)[None, :] < counts[:, None]
    peak = uniform(spec["brightness"], (count, hi))
    sigma = uniform(spec["width"], (count, hi))
    at_r = uniform((0.0, rows), (count, hi))
    at_c = uniform((0.0, cols), (count, hi))
    base = uniform(spec["background"], (count, 1))
    glow = uniform(spec["illumination"], (count, 1)) * min(rows, cols)
    # the illumination profile is one more, broad spot
    peak = torch.cat([peak * active, base / 2], 1)
    sigma = torch.cat([sigma, glow], 1)
    at_r = torch.cat([at_r, uniform((0.25 * rows, 0.75 * rows),
                                     (count, 1))], 1)
    at_c = torch.cat([at_c, uniform((0.25 * cols, 0.75 * cols),
                                    (count, 1))], 1)
    r = torch.arange(rows, **f64)
    c = torch.arange(cols, **f64)
    along_r = torch.exp(-(r - at_r[..., None]) ** 2
                        / (2 * sigma[..., None] ** 2))           # (n, K, R)
    along_c = torch.exp(-(c - at_c[..., None]) ** 2
                        / (2 * sigma[..., None] ** 2))           # (n, K, C)
    clean = base[..., None] + torch.bmm(
        (peak[..., None] * along_r).transpose(1, 2), along_c)
    median_peak = torch.stack([p[a].median() for p, a in
                               zip(peak[:, :hi], active)])
    noise = torch.randn((count, rows, cols), generator=gen, **f64)
    return (clean + spec["noise"] * median_peak[:, None, None] * noise
            ).float()


class Entry(PoolEntry):
    CHECK = "denoise2_err"

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, dtype: torch.dtype):
        self.configure(config)
        host = traffic.rng(seed)
        gen = traffic.generator(seed, device)
        shape = tuple(workload["frame"])
        lengths = traffic.lengths(workload["lengths"], host)
        if set(lengths) != {shape[0] * shape[1]}:
            raise ValueError(f"lengths {sorted(set(lengths))} are not the "
                             f"frame's {shape[0]} x {shape[1]} pixels")
        self.inputs = [frames(workload["signal"], workload["rows"], shape,
                              gen, device) for _ in lengths]
        self.args = [x.to(dtype) for x in self.inputs]
        self.samples = [x.numel() for x in self.inputs]
        self.order = traffic.order(len(lengths), workload, host)
        check = workload["check"]
        self.kept = dict.fromkeys(traffic.sample(lengths, check["sample"],
                                                 host))
        # the frames of every sampled stack that the check compares
        self.images = sorted(host.choice(workload["rows"], check["images"],
                                         replace=False).tolist())
        self.run(self.args[self.order[0]])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def configure(self, config):
        self.wavelet = jt.wavelet(config["wavelet"])
        self.filters = filters.BY_NAME[config["wavelet"]]
        self.level = config["level"]

    def run(self, x):
        return jt.modwt2_denoise(x, self.wavelet, self.level)

    def error(self, x, out):
        images = self.images
        return compare.rel_err_rows(
            out[images], lambda i, j: ref.denoise_images(
                x[images[i:j]], self.filters, self.level),
            len(images), axis=0, block=1)
