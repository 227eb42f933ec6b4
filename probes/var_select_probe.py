"""Variants of the fused variance kernel (#5) and the packet select kernel
(#7) timed against each other on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 probes/var_select_probe.py

Each variant is the checkout's ``csrc/common.cuh``, ``variance.cu`` and
``modwpt.cu`` after a text substitution, built with the package's nvcc
flags into ``build/probes/<variant>/``:

* ``new``: the sources as they are;
* ``old``: ``jw_level_pair`` as first written, every load clamped to the
  level's end and every output guarded, the dilation a run-time value;
* ``var_noload``: the variance kernel's window filled with constants
  instead of read from device memory (its cascade alone);
* ``var_nocompute``: the variance kernel with no level computed (its
  window loads and the in-launch finish alone);
* ``var_R13``: register chains of 13 outputs instead of 9.

Times are device ms per launch from a CUDA graph of 20 launches replayed
between CUDA events (median of 5), the variants alternated in two rounds
of opposite order; each stands beside the card's name and power limit.
The variance runs at (32, 2^20) f32, the select at (8, 65536) Db4 L3 at two
tiles; each result is checked against the plain version (variance) or the
arg-max of the packet forward kernel's output (select).  Then the select
wrapper's host-side pieces, on the host clock.  The last line is one JSON
object of every time.
"""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jwave_pro_tpu_torch as jt  # noqa: E402
from jwave_pro_tpu_torch.kernels import _launch as kl  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc  # noqa: E402
from jwave_pro_tpu_torch.kernels import variance_cuda as kv  # noqa: E402
from probes import harness as hz  # noqa: E402
from probes.harness import sub as _sub  # noqa: E402

OUT = hz.ROOT / "build" / "probes"

OLD_LEVEL_PAIR = r'''template <int MT, int R, typename Emit>
__device__ __forceinline__ void jw_level_pair(const float* par, int lo,
                                              int end, int s, int m,
                                              const JwTaps& taps,
                                              const float* sg,
                                              const float* sh, Emit&& emit) {
  const int d = 1 << s;
  const int count = end - lo;
  if (count <= 0) return;
  const int chains = ((count + R * d - 1) / (R * d)) << s;
  for (int c = threadIdx.x; c < chains; c += blockDim.x) {
    const int i0 = lo + (c >> s) * R * d + (c & (d - 1));
    if constexpr (MT > 0) {
      float v[R], w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = w[r] = 0.f;
#pragma unroll
      for (int u = R - 1; u > -MT; --u) {
        const int idx = i0 + u * d;
        const float t = par[idx < end ? idx : end - 1];
#pragma unroll
        for (int k = 0; k < MT; ++k) {
          if (u + k >= 0 && u + k < R) {
            v[u + k] = fmaf(taps.g[k], t, v[u + k]);
            w[u + k] = fmaf(taps.h[k], t, w[u + k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r * d < end) emit(i0 + r * d, v[r], w[r]);
    } else {
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r * d;
        if (i >= end) break;
        float v = 0.f, w = 0.f;
        for (int k = 0; k < m; ++k) {
          const float t = par[i - k * d];
          v = fmaf(sg[k], t, v);
          w = fmaf(sh[k], t, w);
        }
        emit(i, v, w);
      }
    }
  }
}

'''


def _old_common(src: str) -> str:
    start = src.index("// One register chain of an à-trous pair level")
    stop = src.index("// The kernel instantiated for filter length m")
    return src[:start] + OLD_LEVEL_PAIR + src[stop:]


# variant -> {file: substitution}
VARIANTS = {
    "new": {},
    "old": {"common.cuh": _old_common},
    "var_noload": {"variance.cu": _sub(
        "  jw_load_window(xr, base, n, a, end);",
        "  for (int i = threadIdx.x; i < end; i += blockDim.x)\n"
        "    a[i] = (float)(i & 7);")},
    "var_nocompute": {"variance.cu": _sub(
        "  for (int j = 1; j <= level; ++j) {",
        "  for (int j = 1; j <= 0; ++j) {")},
    "var_R13": {"variance.cu": _sub("#define JW_VAR_R 9",
                                    "#define JW_VAR_R 13")},
}


def build():
    libs, logs = hz.build({name: (hz.CSRC, ("variance.cu", "modwpt.cu"), subs)
                           for name, subs in VARIANTS.items()}, OUT)
    for name, lib in libs.items():
        regs = [f"{k} {' '.join(hz.ptxas(logs[name], k + '_kernelIfLi8E'))}"
                for k in ("var", "select")]
        print(f"  ptxas {name} (f32, M = 8): {', '.join(regs)}", flush=True)
    for name in ("old", "new"):
        sass = hz.sass(OUT / name / "lib.so")
        for fn in ("_Z19jw_modwt_var_kernelIfLi8E",
                   "_Z23jw_modwpt_select_kernelIfLi8E"):
            body = next(b for f, b in sass.items() if f.startswith(fn))
            count, top = hz.sass_mix(body, 10)
            print(f"  {name} {fn[4:24]} SASS {count} instructions: {top}",
                  flush=True)
    return libs


def host_us(fn, k=2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / k * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = hz.card()
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(32, 1 << 20, device=dev, generator=gen)
    xm = torch.randn(8, 65536, device=dev, generator=gen)
    ticket = torch.zeros(4096, dtype=torch.int32, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    wavs = {name: jt.wavelet(name)
            for name in ("Daubechies 4", "Haar", "Symlet 8")}

    def var_call(lib, wname, level, tile=kc.TILES["var"]):
        w = wavs[wname]
        m = w.length
        g, h = kl.kernel_taps(w)
        b, n = x.shape
        nt = -(-n // tile)
        partial = torch.empty((level + 1, b, nt), device=dev)
        out = torch.empty((level + 1, b), device=dev)
        smem = kc.smem_bytes(level, m, "var", tile=tile)
        code = lib.jw_modwt_var(x.data_ptr(), partial.data_ptr(),
                                ticket.data_ptr(), out.data_ptr(), b, n,
                                level, g.ctypes.data, h.ctypes.data, m, tile,
                                smem, 0, 0, stream())
        assert code == 0, code
        return out

    def sel_call(lib, tile, level=3):
        g, h = kl.kernel_taps(wavs["Daubechies 4"])
        b, n = xm.shape
        nt = -(-n // tile)
        partial = torch.empty((1 << level, b, nt), dtype=torch.int64,
                              device=dev)
        out = torch.empty((3, 1 << level, b), device=dev)
        smem = kc.smem_bytes(level, 8, "select", tile=tile)
        code = lib.jw_modwpt_select(xm.data_ptr(), partial.data_ptr(),
                                    ticket.data_ptr(), out.data_ptr(), b, n,
                                    level, g.ctypes.data, h.ctypes.data, 8,
                                    tile, smem, 0, 0, stream())
        assert code == 0, code
        return out

    cases = [("Daubechies 4", 5), ("Haar", 5), ("Symlet 8", 3)]
    want = {c: kv.modwt_var_plain(x, wavs[c[0]], c[1]) for c in cases}
    c = kp.modwpt_fwd_cuda(xm, wavs["Daubechies 4"], 3)
    want_t = torch.argmax(c.abs(), dim=-1)
    del c
    res = {}
    names = list(VARIANTS)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib = libs[name]
            for wname, level in (cases if name in ("old", "new")
                                 else cases[:1]):
                got = var_call(lib, wname, level)
                err = float(((got.double() - want[wname, level].double())
                             .abs() / want[wname, level].double().abs())
                            .max())
                ms = hz.graph_ms(lambda: var_call(lib, wname, level))
                res.setdefault(f"var {name} {wname} L{level}", []).append(ms)
                print(f"round {rnd} var {name} {wname} L{level}: {ms:.4f} ms"
                      f", rel err vs plain {err:.1e} [{card}]", flush=True)
            if name not in ("old", "new"):
                continue
            for tile in (2511, 4096):
                out = sel_call(lib, tile)
                exact = torch.equal(out[1].view(torch.int32).long(), want_t)
                ms = hz.graph_ms(lambda: sel_call(lib, tile))
                res.setdefault(f"select {name} tile {tile}", []).append(ms)
                print(f"round {rnd} select {name} tile {tile}: "
                      f"{ms * 1e3:.2f} us, positions exact {exact} [{card}]",
                      flush=True)

    w = wavs["Daubechies 4"]
    g, h = kl.kernel_taps(w)
    st = stream()
    partial = torch.empty((8, 8, 16), dtype=torch.int64, device=dev)
    out = torch.empty((3, 8, 8), device=dev)
    smem = kp.select_plan(8, 65536, 3, 8).smem
    pieces = {
        "modwpt_select_cuda (the wrapper)":
            lambda: kp.modwpt_select_cuda(xm, w, 3),
        "two torch.empty": lambda: (
            torch.empty((8, 8, 16), dtype=torch.int64, device=dev),
            torch.empty((3, 8, 8), device=dev)),
        "torch.cuda.current_stream": lambda: stream(),
        "kernel_taps": lambda: kl.kernel_taps(w),
        "select_plan": lambda: kp.select_plan(8, 65536, 3, 8),
        "tickets": lambda: kl.tickets(dev, st, 8),
        "C entry point and launch": lambda: libs["new"].jw_modwpt_select(
            xm.data_ptr(), partial.data_ptr(), ticket.data_ptr(),
            out.data_ptr(), 8, 65536, 3, g.ctypes.data, h.ctypes.data, 8,
            4096, smem, 0, 0, st),
    }
    for key, fn in pieces.items():
        us = host_us(fn)
        res[f"host us {key}"] = us
        print(f"  host {key}: {us:.2f} us a call [{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
