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
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jwave_pro_tpu_torch as jt  # noqa: E402
from jwave_pro_tpu_torch.kernels import _build  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc  # noqa: E402
from jwave_pro_tpu_torch.kernels import variance_cuda as kv  # noqa: E402

CSRC = ROOT / "jwave_pro_tpu_torch" / "csrc"
OUT = ROOT / "build" / "probes"
GRAPH_CALLS = 20

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


def _sub(old: str, new: str):
    def apply(src: str) -> str:
        if old not in src:
            raise SystemExit(f"substitution target not found: {old!r}")
        return src.replace(old, new)
    return apply


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
    nvcc = _build._nvcc()
    procs = []
    for name, subs in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("common.cuh", "variance.cu", "modwpt.cu"):
            src = (CSRC / f).read_text()
            (d / f).write_text(subs[f](src) if f in subs else src)
        for f in ("variance.cu", "modwpt.cu"):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / (f + ".o")),
                   str(d / f)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    t0 = time.time()
    logs = {}
    for name, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{err[-3000:]}")
        logs[name] = logs.get(name, "") + err
    print(f"built {len(VARIANTS)} variants in {time.time() - t0:.1f} s",
          flush=True)
    libs = {}
    for name in VARIANTS:
        d = OUT / name
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                        str(d / "lib.so"), str(d / "variance.cu.o"),
                        str(d / "modwpt.cu.o")], check=True)
        for m in re.finditer(r"Compiling entry function '(\w+)'(.*?)Used "
                             r"(\d+) registers", logs[name], re.S):
            if "IfLi8E" in m.group(1) and ("var_kernel" in m.group(1)
                                           or "select_kernel" in m.group(1)):
                sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                               r"stores, (\d+) bytes spill loads", m.group(2))
                print(f"  {name} {m.group(1)[:34]}: {m.group(3)} registers, "
                      f"stack/spill stores/loads "
                      f"{sp.groups() if sp else None}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.jw_modwt_var.argtypes = args
        lib.jw_modwpt_select.argtypes = args
        libs[name] = lib
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    for name in ("old", "new"):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(OUT / name / "lib.so")],
                              capture_output=True, text=True).stdout
        for fn in ("_Z19jw_modwt_var_kernelIfLi8E",
                   "_Z23jw_modwpt_select_kernelIfLi8E"):
            i = sass.index("Function : " + fn)
            j = sass.find("Function : ", i + 10)
            body = sass[i:j if j > 0 else None]
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", body)
            hist = {}
            for o in ops:
                hist[o] = hist.get(o, 0) + 1
            top = sorted(hist.items(), key=lambda kv: -kv[1])[:10]
            print(f"  {name} {fn[4:24]} SASS {len(ops)} instructions: {top}",
                  flush=True)
    return libs


def graph_ms(fn, rep=5) -> float:
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
    for _ in range(rep):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_CALLS)
    return statistics.median(times)


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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
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
        g, h = kc.kernel_taps(w)
        b, n = x.shape
        nt = -(-n // tile)
        partial = torch.empty((level + 1, b, nt), device=dev)
        out = torch.empty((level + 1, b), device=dev)
        smem = 4 * (2 * kc.MAX_TAPS + kc.WARPS * (level + 1)
                    + 2 * (tile + kc.halo(m, level)))
        code = lib.jw_modwt_var(x.data_ptr(), partial.data_ptr(),
                                ticket.data_ptr(), out.data_ptr(), b, n,
                                level, g.ctypes.data, h.ctypes.data, m, tile,
                                smem, 0, 0, stream())
        assert code == 0, code
        return out

    def sel_call(lib, tile, level=3):
        g, h = kc.kernel_taps(wavs["Daubechies 4"])
        b, n = xm.shape
        nt = -(-n // tile)
        partial = torch.empty((1 << level, b, nt), dtype=torch.int64,
                              device=dev)
        out = torch.empty((3, 1 << level, b), device=dev)
        smem = 4 * (2 * kc.MAX_TAPS + 8 * kc.WARPS
                    + (2 * level - 1) * (tile + kc.halo(8, level)))
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
                ms = graph_ms(lambda: var_call(lib, wname, level))
                res.setdefault(f"var {name} {wname} L{level}", []).append(ms)
                print(f"round {rnd} var {name} {wname} L{level}: {ms:.4f} ms"
                      f", rel err vs plain {err:.1e} [{card}]", flush=True)
            if name not in ("old", "new"):
                continue
            for tile in (2511, 4096):
                out = sel_call(lib, tile)
                exact = torch.equal(out[1].view(torch.int32).long(), want_t)
                ms = graph_ms(lambda: sel_call(lib, tile))
                res.setdefault(f"select {name} tile {tile}", []).append(ms)
                print(f"round {rnd} select {name} tile {tile}: "
                      f"{ms * 1e3:.2f} us, positions exact {exact} [{card}]",
                      flush=True)

    w = wavs["Daubechies 4"]
    g, h = kc.kernel_taps(w)
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
        "kernel_taps": lambda: kc.kernel_taps(w),
        "select_plan": lambda: kp.select_plan(8, 65536, 3, 8),
        "tickets": lambda: kc.tickets(dev, st, 8),
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
