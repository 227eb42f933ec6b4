"""Variants of the MODWT forward kernel (#1, and #2 at B = 1) timed against
each other on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 probes/fwd_probe.py [--parent DIR]

``DIR``: the ``jwave_pro_tpu_torch/csrc`` directory of another checkout
(for example the parent commit, unpacked with ``git archive``); its
``modwt.cu`` is built and timed beside these, through the same C entry
point, as the variant ``parent``, and every output of the checkout's
kernel is compared with the parent's bit for bit: at both main shapes and
at the smoke's forward edge shapes (``chip_smoke.FWD_EDGES``), in float32
and bfloat16.  With ``--parent``, the probe also compiles ``variance.cu``,
``modwpt.cu`` and ``denoise.cu`` of both checkouts and compares the SASS
of every kernel but the forward (the inverse's from ``modwt.cu``): the
shared helpers' per-warp step compiles out of the kernels that pass none.

Each other variant is the checkout's ``common.cuh`` and ``modwt.cu`` after
a text substitution, built with the package's nvcc flags into
``build/probes/fwd/<variant>/``:

* ``new``: the sources as they are (W_j staged in a slice of shared
  memory a warp, stored as consecutive addresses);
* ``direct``: W_j stored straight from the register chains at every
  dilation (a warp's lanes R d apart);
* ``stcs``: the staged stores as streaming stores (``__stcs``, evict
  first);
* ``vec4``: the staged float32 stores as 16-byte vector stores over the
  run's aligned part (bfloat16 as in ``new``);
* ``R5``, ``R7``: register chains of that many outputs instead of 9;
* ``t128``, ``t512``: 128-thread blocks (``__launch_bounds__(128, 8)``)
  and 512-thread blocks (``(512, 2)``) instead of 256 (``(256, 4)``);
* ``floor``: no level computed; each level's row is the window, stored
  coalesced (the loads and stores alone, one barrier a level);
* ``nostores``: the cascade and the staging with no device stores.

Each runs at the tiles listed beside it, with its layout's shared memory.
Times are device ms per launch from a CUDA graph of 20 launches replayed
between CUDA events (median of 5), the variants alternated in two rounds of
opposite order, at (32, 2^20) and (2^24,) f32 Db4 L5; each transform's
result is checked against the plain version, and each time stands beside
the card's name and power limit.  Before the times: ptxas's registers,
stack and spill stores of each variant's forward instantiations, and the
SASS instruction mix of the M = 8 float32 forward of ``new`` and
``parent``.  The last line is one JSON object of every time.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jwave_pro_tpu_torch as jt  # noqa: E402
from chip_smoke import FWD_EDGES  # noqa: E402
from jwave_pro_tpu_torch.kernels import _launch as kl  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc  # noqa: E402
from probes import harness as hz  # noqa: E402
from probes.harness import sub as _sub  # noqa: E402

OUT = hz.ROOT / "build" / "probes" / "fwd"
LEVEL = 5
SHAPES = ((32, 1 << 20), (1, 1 << 24))
OTHER_SOURCES = ("variance.cu", "modwpt.cu", "denoise.cu")

STAGED = '''#pragma unroll
            for (int k = 0; k < JW_FWD_R; ++k) {
              const int i = first + k * 32 + lane;
              if (i >= halo && i < end) {
                jw_store(dst(sj, i), slice[k * 32 + lane]);
                if (last) jw_store(dst(level, i), b[i]);
              }
            }'''

# the run [first, first + 32 R) cut to [halo, end), for each row it goes
# to: scalar head up to a 16-byte boundary, float4 body, scalar tail
VEC4 = '''if constexpr (sizeof(T) == 4) {
              const int i_lo = max(first, halo);
              const int i_hi = min(first + 32 * JW_FWD_R, end);
              for (int rr = 0; rr < (last ? 2 : 1); ++rr) {
                float* q = reinterpret_cast<float*>(dst(rr ? level : sj, 0));
                const float* src = rr ? b : slice - first;
                const int mis = (int)(((unsigned long long)(q + i_lo)) >> 2) & 3;
                const int a0 = min(i_lo + ((4 - mis) & 3), i_hi);
                const int nv = (i_hi - a0) >> 2;
                const int a1 = a0 + 4 * nv;
                if (i_lo + lane < a0) q[i_lo + lane] = src[i_lo + lane];
                if (a1 + lane < i_hi) q[a1 + lane] = src[a1 + lane];
                for (int u = lane; u < nv; u += 32) {
                  const int i = a0 + 4 * u;
                  *reinterpret_cast<float4*>(q + i) =
                      make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
                }
              }
            } else {
''' + STAGED + '''
            }'''

STREAMING = '''#include "common.cuh"

__device__ __forceinline__ void jw_store_cs(float* p, float v) {
  __stcs(p, v);
}
__device__ __forceinline__ void jw_store_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
'''

LEVEL_CALL = '''    jw_level_pair<MT, JW_FWD_R>(
        a, lo, end, sj, m, taps, sg, sh,'''

FLOOR = '''    for (int i = halo + (int)threadIdx.x; i < end; i += blockDim.x) {
      jw_store(dst(sj, i), a[i]);
      if (last) jw_store(dst(level, i), a[i]);
    }
    if (0) jw_level_pair<MT, JW_FWD_R>(
        a, lo, end, sj, m, taps, sg, sh,'''


def _chain(r: int):
    return _sub("#define JW_FWD_R 9 ", f"#define JW_FWD_R {r} ")


def _threads(threads: int, blocks: int):
    def apply(src: str) -> str:
        src = _sub("#define JW_FWD_THREADS 256 ",
                   f"#define JW_FWD_THREADS {threads} ")(src)
        return _sub("__launch_bounds__(JW_FWD_THREADS, 4)",
                    f"__launch_bounds__(JW_FWD_THREADS, {blocks})")(src)
    return apply


def _streaming(src: str) -> str:
    src = _sub('#include "common.cuh"\n', STREAMING)(src)
    return _sub("jw_store(dst(", "jw_store_cs(dst(")(src)


# variant -> (modwt.cu substitution, threads, chain length R, tiles, whether
# its output is the transform)
VARIANTS = {
    "new": (None, 256, 9, (2048, 4096, 8192), True),
    "direct": (_sub("const bool staged = sj < 5;",
                    "const bool staged = false;"), 256, 9, (4096,), True),
    "stcs": (_streaming, 256, 9, (4096,), True),
    "vec4": (_sub(STAGED, VEC4), 256, 9, (4096,), True),
    "R5": (_chain(5), 256, 5, (4096,), True),
    "R7": (_chain(7), 256, 7, (4096,), True),
    "t128": (_threads(128, 8), 128, 9, (2048, 4096), True),
    "t512": (_threads(512, 2), 512, 9, (4096, 8192), True),
    "floor": (_sub(LEVEL_CALL, FLOOR), 256, 9, (4096,), False),
    "nostores": (_sub("jw_store(dst(", "if (0) jw_store(dst("), 256, 9,
                 (4096,), False),
}

def smem(name: str, threads: int, r: int, tile: int, m: int,
         level: int) -> int:
    """The variant's layout: the parent's has no W slices."""
    return kc.smem_bytes(level, m, "fwd", tile=tile,
                         slice_floats=0 if name == "parent"
                         else threads * r)


def build(parent: Path | None):
    jobs = {name: (hz.CSRC, ("modwt.cu",), {"modwt.cu": sub} if sub else {})
            for name, (sub, *_) in VARIANTS.items()}
    if parent is not None:
        jobs["parent"] = (parent, ("modwt.cu",), {})
    # the other kernels' sources of both checkouts, for the SASS comparison
    cubins, extra = [], []
    if parent is not None:
        for side, src_dir in (("new_other", hz.CSRC),
                              ("parent_other", parent)):
            d = OUT / side
            d.mkdir(parents=True, exist_ok=True)
            for f in hz.headers(src_dir) + OTHER_SOURCES:
                (d / f).write_text((src_dir / f).read_text())
            for f in OTHER_SOURCES:
                cubins.append((side, d / (f + ".cubin")))
                extra.append((side, hz.nvcc(
                    "-cubin", "-o", str(cubins[-1][1]), str(d / f))))
    libs, logs = hz.build(jobs, OUT, extra)
    for name, lib in libs.items():
        regs = " ".join(hz.ptxas(logs[name], "fwd_kernel"))
        print(f"  ptxas {name}: {regs}", flush=True)
    for name in ("new", "parent"):
        if name not in libs:
            continue
        for fn, body in hz.sass(OUT / name / "lib.so").items():
            if "fwd_kernel" not in fn or not ("IfLi8E" in fn or "IfE" in fn):
                continue
            count, top = hz.sass_mix(body)
            print(f"  {name} {fn[:30]} SASS {count} instructions: {top}",
                  flush=True)
    if parent is not None:
        same, differ = 0, []
        sides = {"new": {}, "parent": {}}
        for side, cubin in cubins:
            sides[side.split("_")[0]].update(hz.sass(cubin))
        for side in sides:
            sides[side].update(
                (fn, body) for fn, body in hz.sass(
                    OUT / side / "lib.so").items()
                if "fwd_kernel" not in fn)
        for fn in sorted(set(sides["new"]) | set(sides["parent"])):
            if sides["new"].get(fn) == sides["parent"].get(fn):
                same += 1
            else:
                differ.append(fn)
        print(f"  other kernels' SASS, new vs parent: {same} identical, "
              f"{len(differ)} differ {differ}", flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc directory of another checkout to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = hz.card()
    print(card, flush=True)
    libs = build(args.parent)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(name, x, out, wav, level, tile, threads, r):
        b, n = x.shape
        m = wav.length
        g, h = kl.kernel_taps(wav)
        code = libs[name].jw_modwt_fwd(
            x.data_ptr(), out.data_ptr(), b, n, level, g.ctypes.data,
            h.ctypes.data, m, tile, kc.halo(m, level),
            smem(name, threads, r, tile, m, level), kl.DTYPE_CODES[x.dtype],
            0, torch.cuda.current_stream().cuda_stream)
        assert code == 0, (name, code)
        return out

    def run(name, x, wav, level):
        threads, r = (512, 9) if name == "parent" else VARIANTS[name][1:3]
        out = torch.empty((level + 1,) + tuple(x.shape), dtype=x.dtype,
                          device=dev)
        tile = (kc.TILES["fwd"] if name == "parent"
                else kc.tile_of("fwd", level, wav.length))
        return call(name, x, out, wav, level, tile, threads, r)

    db4 = jt.wavelet("Daubechies 4")
    if "parent" in libs:
        cases = [(b, n, LEVEL, "Daubechies 4") for b, n in SHAPES]
        cases += list(FWD_EDGES)
        for b, n, level, wname in cases:
            wav = jt.wavelet(wname)
            x32 = torch.randn(b, n, device=dev, generator=gen)
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                eq = torch.equal(run("new", x, wav, level),
                                 run("parent", x, wav, level))
                print(f"  bitwise new == parent ({b}, {n}) L{level} {wname} "
                      f"{dt}: {eq}", flush=True)
        torch.cuda.empty_cache()

    res = {}
    for b, n in SHAPES:
        x = torch.randn(b, n, device=dev, generator=gen)
        want = kc.modwt_fwd_plain(x, db4, LEVEL)
        out = torch.empty_like(want)
        cases = [("parent", 4096, 512, 9)] if "parent" in libs else []
        for name, (_, threads, r, tiles, _) in VARIANTS.items():
            cases += [(name, t, threads, r) for t in tiles]
        for rnd, order in enumerate((cases, cases[::-1])):
            for name, tile, threads, r in order:
                got = call(name, x, out, db4, LEVEL, tile, threads, r)
                checked = name == "parent" or VARIANTS[name][4]
                err = (f"max-abs-err vs plain "
                       f"{float((got - want).abs().max()):.2e}" if checked
                       else "not the transform")
                ms = hz.graph_ms(lambda: call(name, x, out, db4, LEVEL,
                                              tile, threads, r))
                key = f"{name} tile {tile} ({b}, {n})"
                res.setdefault(key, []).append(ms)
                print(f"round {rnd} {key}: {ms:.4f} ms, {err} [{card}]",
                      flush=True)
        del x, want, out
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
