"""Variants of the MODWT inverse kernel (#3) and the fused denoise kernel
(#4) timed against each other on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 probes/inv_denoise_probe.py [--parent DIR]

``DIR``: the ``jwave_pro_tpu_torch/csrc`` directory of another checkout
(for example the parent commit, unpacked with ``git archive``); its
``modwt.cu`` and ``denoise.cu`` are built and timed beside these, through
the same C entry points, as the variant ``parent``.  Each other variant is
the checkout's headers and one of ``modwt.cu`` / ``denoise.cu`` after a
text substitution (the inverse's defines and body are in
``modwt_inv.cuh``), built with the package's nvcc flags into
``build/probes/<variant>/``:

* ``new``: the sources as they are;
* ``inv_R3``, ``inv_R5``, ``den_R3``, ``den_R7``: register chains of that
  many outputs instead of the sources' JW_INV_R / JW_DENOISE_R;
* ``inv_prefetch1``, ``inv_prefetch9``: the inverse holding one or nine
  next-row elements a thread in flight instead of JW_INV_PREFETCH (the
  rest of the row loads after the level, batched): what the prefetch buys;
* ``inv_nocompute``: the inverse with no level computed (its loads and
  stores alone);
* ``den_analysis``: the denoise with no synthesis level (its load, its
  analysis and its store);
* ``inv_t128``, ``inv_t512``, ``den_t512``, ``den_t512_lb1``: other
  block sizes (128 threads, eight blocks an SM; 512 threads, two blocks
  an SM; 512 threads and ``__launch_bounds__(512, 1)``, up to 128
  registers, for the denoise's one-block-an-SM tile of 4096).

Each variant runs at the tiles listed beside it through its C entry point,
with the shared memory of that tile's layout.  Times are device ms per
launch from a CUDA graph of 20 launches replayed between CUDA events
(median of 5), the variants alternated in two rounds of opposite order, at
(32, 2^20) f32 Db4 L5; each result is checked against the plain version,
and each time stands beside the card's name and power limit.  Before the
times: ptxas's registers / stack / spill stores of every instantiation of
the two kernels in each variant, and the SASS instruction mix of the M = 8
float32 kernels of ``new`` and ``parent``.  The last line is one JSON
object of every time.
"""
import argparse
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jwave_pro_tpu_torch as jt  # noqa: E402
from jwave_pro_tpu_torch.kernels import _launch as kl  # noqa: E402
from jwave_pro_tpu_torch.kernels import denoise_cuda as kd  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc  # noqa: E402
from probes import harness as hz  # noqa: E402
from probes.harness import sub as _sub  # noqa: E402

CSRC = hz.CSRC
OUT = hz.ROOT / "build" / "probes"
LEVEL = 5


def _r(name: str, r: int):
    """Register chains of r outputs instead of the sources' count."""
    f = "modwt_inv.cuh" if name == "JW_INV_R" else "denoise.cu"
    src = re.search(rf"#define {name} \d+", (CSRC / f).read_text()).group(0)
    return _sub(src, f"#define {name} {r}")


def _threads(kernel: str, threads: int, blocks: int):
    """The kernel's block size and launch bounds replaced (the inverse's
    size is defined in the header its body lives in)."""
    define = {"inv": "JW_INV_THREADS", "den": "JW_DENOISE_THREADS"}[kernel]
    f = {"inv": "modwt.cu", "den": "denoise.cu"}[kernel]
    fd = {"inv": "modwt_inv.cuh", "den": "denoise.cu"}[kernel]
    src = re.search(rf"#define {define} (\d+)",
                    (CSRC / fd).read_text()).group(0)
    bounds = re.search(rf"__launch_bounds__\({define}, \d+\)",
                       (CSRC / f).read_text()).group(0)
    size = _sub(src, f"#define {define} {threads}")
    launch = _sub(bounds, f"__launch_bounds__({define}, {blocks})")
    if f == fd:
        return {f: lambda text: launch(size(text))}
    return {fd: size, f: launch}


# variant -> (files built, {file: substitution}, inverse tiles timed,
# denoise tiles timed)
VARIANTS = {
    "new": (("modwt.cu", "denoise.cu"), {}, (2048, 4096),
            (1024, 1536, 2048)),
    "inv_R3": (("modwt.cu",), {"modwt_inv.cuh": _r("JW_INV_R", 3)}, (4096,), ()),
    "inv_R5": (("modwt.cu",), {"modwt_inv.cuh": _r("JW_INV_R", 5)}, (4096,), ()),
    "inv_prefetch1": (("modwt.cu",), {"modwt_inv.cuh": lambda t: re.sub(
        r"#define JW_INV_PREFETCH(_M16)? \d+", r"#define JW_INV_PREFETCH\1 1",
        t)}, (4096,), ()),
    "inv_prefetch9": (("modwt.cu",), {"modwt_inv.cuh": _sub(
        "#define JW_INV_PREFETCH 17", "#define JW_INV_PREFETCH 9")},
        (4096,), ()),
    "inv_nocompute": (("modwt.cu",), {"modwt_inv.cuh": _sub(
        "    jw_level_adjoint<MT, JW_INV_R>(v, w, 0, next, j - 1, m, taps, "
        "sg, sh,\n", "    if (0) jw_level_adjoint<MT, JW_INV_R>(v, w, 0, "
        "next, j - 1, m, taps, sg, sh,\n")}, (4096,), ()),
    "inv_t128": (("modwt.cu",), _threads("inv", 128, 8), (2048,), ()),
    "inv_t512": (("modwt.cu",), _threads("inv", 512, 2), (4096, 8192), ()),
    "den_R3": (("denoise.cu",), {"denoise.cu": _r("JW_DENOISE_R", 3)},
               (), (2048,)),
    "den_R7": (("denoise.cu",), {"denoise.cu": _r("JW_DENOISE_R", 7)},
               (), (2048,)),
    "den_analysis": (("denoise.cu",), {"denoise.cu": _sub(
        "  for (int j = level; j >= 1; --j) {\n    hi -=",
        "  for (int j = level; j >= 1 && 0; --j) {\n    hi -=")},
        (), (2048,)),
    "den_t512": (("denoise.cu",), _threads("den", 512, 2), (), (2048, 4096)),
    "den_t512_lb1": (("denoise.cu",), _threads("den", 512, 1), (), (4096,)),
}



def build(parent: Path | None):
    jobs = dict(VARIANTS)
    if parent is not None:
        jobs["parent"] = (("modwt.cu", "denoise.cu"), {}, (4096,), (2048,))
    built, logs = hz.build(
        {name: (parent if name == "parent" else CSRC, files, subs)
         for name, (files, subs, *_) in jobs.items()}, OUT)
    libs = {}
    for name, (files, _, tiles_inv, tiles_den) in jobs.items():
        regs = hz.ptxas(logs[name], "inv_kernel", "denoise_kernel")
        print(f"  ptxas {name}: {' '.join(regs)}", flush=True)
        lib = built[name]
        libs[name] = (files, lib, tiles_inv, tiles_den)
    for name in ("new", "parent"):
        if name not in libs:
            continue
        for fn, body in hz.sass(OUT / name / "lib.so").items():
            if not (("inv_kernel" in fn or "denoise_kernel" in fn)
                    and ("IfLi8E" in fn or "IfE" in fn)):
                continue
            count, top = hz.sass_mix(body)
            print(f"  {name} {fn[:30]} SASS {count} instructions: {top}",
                  flush=True)
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
    w = jt.wavelet("Daubechies 4")
    m = w.length
    g, h = kl.kernel_taps(w)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(32, 1 << 20, device=dev, generator=gen)
    b, n = x.shape
    c = kc.modwt_fwd_cuda(x, w, LEVEL)
    thr = torch.full((b,), 0.8, device=dev)
    out = torch.empty_like(x)
    hal = kc.halo(m, LEVEL)
    want_inv = kc.modwt_inv_plain(c, w)
    want_den = kd.modwt_denoise_plain(x, thr, w, LEVEL)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def inv_call(lib, tile):
        smem = kc.smem_bytes(LEVEL, m, "inv", tile=tile)
        code = lib.jw_modwt_inv(c.data_ptr(), out.data_ptr(), b, n, LEVEL,
                                g.ctypes.data, h.ctypes.data, m, tile, hal,
                                smem, 0, 0, stream())
        assert code == 0, code
        return out

    def den_call(lib, tile):
        smem = kc.smem_bytes(LEVEL, m, "denoise", tile=tile)
        code = lib.jw_modwt_denoise(x.data_ptr(), thr.data_ptr(),
                                    out.data_ptr(), b, n, LEVEL,
                                    g.ctypes.data, h.ctypes.data, m, tile,
                                    hal, smem, 0, 0, 0, stream())
        assert code == 0, code
        return out

    cases = []
    for name, (files, lib, tiles_inv, tiles_den) in libs.items():
        cases += [("inv", name, lib, t) for t in tiles_inv]
        cases += [("denoise", name, lib, t) for t in tiles_den]
    res = {}
    for rnd, order in enumerate((cases, cases[::-1])):
        for kind, name, lib, tile in order:
            call, want = ((inv_call, want_inv) if kind == "inv"
                          else (den_call, want_den))
            err = float((call(lib, tile) - want).abs().max())
            ms = hz.graph_ms(lambda: call(lib, tile))
            key = f"{kind} {name} tile {tile}"
            res.setdefault(key, []).append(ms)
            print(f"round {rnd} {key}: {ms:.4f} ms, max-abs-err vs plain "
                  f"{err:.2e} [{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
