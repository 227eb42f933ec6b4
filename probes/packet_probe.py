"""Variants of the packet forward (#6) and packet inverse (#8) kernels timed
against each other on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 probes/packet_probe.py [--parent DIR]

``DIR``: the ``jwave_pro_tpu_torch/csrc`` directory of another checkout
(for example the parent commit, unpacked with ``git archive``); its
``modwpt.cu`` is built and timed beside these, through the same C entry
points, as the variant ``parent``.  With ``--parent`` the probe also checks
every output of the checkout's forward against the parent's bit for bit (at
the main shape and at the smoke's packet edge shapes,
``chip_smoke.PACKET_EDGES``, f32 and bf16), gives the inverse's largest
difference from the parent's there (its summation order changed), times
both selects (#7, which shares the forward's walk), and compares the SASS of
every other kernel compiled from ``common.cuh`` (all of ``modwt.cu``,
``variance.cu``, ``denoise.cu``, ``modwt2.cu``, ``modwt3.cu``, ``cwt.cu``,
and the select) with the parent's.

Each other variant is the checkout's ``common.cuh`` and ``modwpt.cu`` after
a text substitution, built with the package's nvcc flags into
``build/probes/packet/<variant>/``:

* ``new``: the sources as they are (leaves staged a warp at a time);
* ``direct``: the forward's leaves stored straight from the register
  chains at every dilation (a warp's lanes R d apart);
* ``R7``, ``R9``: register chains of that many outputs in both kernels
  instead of 5;
* ``t128``, ``t512``: 128-thread blocks (``__launch_bounds__(128, 8)``)
  and 512-thread blocks (``(512, 2)``) instead of 256 (``(256, 4)``);
* ``floor``: the loads and stores alone -- the forward loads its window and
  stores it as every leaf, with no level computed; the inverse loads every
  leaf pair and stores the root row, with no level computed;
* ``pre0``, ``pre0_R7``: the inverse without the next path's leaves in
  flight while a path climbs (each path's leaves loaded before it), with
  chains of 5 and 7; ``pre0_idx64``: ``pre0`` with 64-bit leaf offsets;
* ``lb3``: the inverse under ``__launch_bounds__(256, 3)`` (three blocks
  an SM, up to 85 registers).

Each runs at the tiles listed beside it, with its layout's shared memory
(``kernels.modwt_cuda.smem_bytes``).  Times are device ms per launch from a
CUDA graph of 20 launches replayed between CUDA events (median of 5), the
variants alternated in two rounds of opposite order, at (32, 2^18) Db4 L3
for the forward and (8, 32, 2^18) for the inverse, f32; each result that is
the transform is checked against the plain version, and each time stands
beside the card's name and power limit.  Before the times: ptxas's
registers, stack and spill stores of each variant's instantiations and the
SASS instruction mix of the M = 8 float32 kernels of ``new`` and
``parent``.  The last line is one JSON object of every time.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jwave_pro_tpu_torch as jt  # noqa: E402
from chip_smoke import PACKET_EDGES  # noqa: E402
from jwave_pro_tpu_torch.kernels import _launch as kl  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp  # noqa: E402
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc  # noqa: E402
from probes import harness as hz  # noqa: E402
from probes.harness import sub as _sub  # noqa: E402

OUT = hz.ROOT / "build" / "probes" / "packet"
LEVEL = 3
FWD_SHAPE = (32, 1 << 18)
OTHER_SOURCES = ("modwt.cu", "variance.cu", "denoise.cu", "modwt2.cu",
                 "modwt3.cu", "cwt.cu")
SELECT_SHAPE = (8, 65536)

FWD_WALK = '''jw_packet_walk<MT, JW_PFWD_R>(
      rows, tile + halo, end, level, m, taps, sg, sh,'''
LEAF_PAIR = '''jw_level_pair<MT, JW_PFWD_R>(
            par, halo, end, sl, m, taps, sg, sh,'''
# the floor's forward: no level computed, each leaf pair is the window
# itself, stored coalesced
FLOOR_WALK = '''jw_packet_floor(
      rows, level,'''
FLOOR_LEAF = '''for (int i = halo + threadIdx.x; i < end; i += blockDim.x) {
          jw_store(dg + i, par[i]);
          jw_store(dh + i, par[i]);
        }
        if (0) jw_level_pair<MT, JW_PFWD_R>(
            par, halo, end, sl, m, taps, sg, sh,'''
FLOOR_HELPER = '''#include "common.cuh"

template <typename Leaf>
__device__ __forceinline__ void jw_packet_floor(float* rows, int level,
                                                Leaf&& leaf) {
  for (int q = 0; q < (1 << (level - 1)); ++q) leaf(q, rows);
}
'''


def _floor(src: str) -> str:
    src = _sub('#include "common.cuh"\n', FLOOR_HELPER)(src)
    src = _sub(FWD_WALK, FLOOR_WALK)(src)
    src = _sub(LEAF_PAIR, FLOOR_LEAF)(src)
    # the inverse: the leaf loads, the barriers and the root's store
    return _sub("jw_level_adjoint<MT, JW_PINV_R>(cg, ch, 0, len",
                "if (0) jw_level_adjoint<MT, JW_PINV_R>(cg, ch, 0, len")(src)


def _chain(r: int):
    def apply(src: str) -> str:
        src = _sub("#define JW_PFWD_R 5 ", f"#define JW_PFWD_R {r} ")(src)
        return _sub("#define JW_PINV_R 5 ", f"#define JW_PINV_R {r} ")(src)
    return apply


def _threads(threads: int, blocks: int):
    def apply(src: str) -> str:
        for name in ("JW_PFWD_THREADS", "JW_PINV_THREADS"):
            src = _sub(f"#define {name} 256", f"#define {name} {threads}")(
                src)
            src = _sub(f"__launch_bounds__({name}, 4)",
                       f"__launch_bounds__({name}, {blocks})")(src)
        return src
    return apply


def _then(*subs):
    def apply(src: str) -> str:
        for f in subs:
            src = f(src)
        return src
    return apply


NO_PREFETCH = _then(
    _sub("#define JW_PINV_PREFETCH 9", "#define JW_PINV_PREFETCH 0"),
    _sub("#define JW_PINV_PREFETCH_M16 4", "#define JW_PINV_PREFETCH_M16 0"))

# variant -> (modwpt.cu substitution, threads, chain length R, tiles,
# whether its output is the transform, the kernels it changes)
VARIANTS = {
    "new": (None, 256, 5, (2048, 4096), True, "fwd inv"),
    "direct": (_sub("const bool staged = sl < 5;",
                    "const bool staged = false;"), 256, 5, (2048,), True,
               "fwd"),
    "R7": (_chain(7), 256, 7, (2048,), True, "fwd inv"),
    "R9": (_chain(9), 256, 9, (2048,), True, "fwd inv"),
    "t128": (_threads(128, 8), 128, 5, (2048,), True, "fwd inv"),
    "t512": (_threads(512, 2), 512, 5, (2048,), True, "fwd inv"),
    "floor": (_floor, 256, 5, (2048,), False, "fwd inv"),
    # the inverse without the next path's leaves in flight, with chains of
    # 5 and 7, and with the leaf loads' 64-bit offsets
    "pre0": (NO_PREFETCH, 256, 5, (2048,), True, "inv"),
    "pre0_R7": (_then(NO_PREFETCH, _chain(7)), 256, 7, (2048,), True,
                "inv"),
    "pre0_idx64": (_then(NO_PREFETCH, _sub(
        "const int p = (int)jw_index(base + i, n);",
        "const long long p = jw_index(base + i, n);")), 256, 5, (2048,),
        True, "inv"),
    # three blocks an SM: up to 85 registers
    "lb3": (_sub("__launch_bounds__(JW_PINV_THREADS, 4)",
                 "__launch_bounds__(JW_PINV_THREADS, 3)"), 256, 5, (2048,),
            True, "inv"),
}


def layout(name: str, kind: str, threads: int, r: int, tile: int, m: int,
           level: int) -> int:
    """The variant's shared memory: the parent's forward has no leaf
    slices and its inverse no third row at L = 1."""
    if name == "parent":
        rows = 2 * level - 1 if kind == "pfwd" else 2 * level
        return 4 * (2 * kc.MAX_TAPS + rows * (tile + kc.halo(m, level)))
    return kc.smem_bytes(level, m, kind, tile=tile,
                         slice_floats=threads * 2 * r if kind == "pfwd"
                         else None)


def build(parent: Path | None):
    jobs = {name: (hz.CSRC, ("modwpt.cu",), {"modwpt.cu": sub} if sub else {})
            for name, (sub, *_) in VARIANTS.items()}
    if parent is not None:
        jobs["parent"] = (parent, ("modwpt.cu",), {})
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
        for kernel in ("modwpt_fwd", "modwpt_inv"):
            regs = " ".join(hz.ptxas(logs[name], kernel))
            print(f"  ptxas {name} {kernel}: {regs}", flush=True)
    sass = {name: hz.sass(OUT / name / "lib.so")
            for name in ("new", "parent") if name in libs}
    for name, fns in sass.items():
        for fn, body in fns.items():
            if ("fwd_kernel" in fn or "inv_kernel" in fn) and (
                    "IfLi8E" in fn or "IfE" in fn):
                count, top = hz.sass_mix(body)
                print(f"  {name} {fn[:30]} SASS {count} instructions: {top}",
                      flush=True)
    if parent is not None:
        sides = {"new": {}, "parent": {}}
        for side, cubin in cubins:
            sides[side.split("_")[0]].update(hz.sass(cubin))
        for side in sides:
            sides[side].update((fn, body) for fn, body in sass[side].items()
                               if "select" in fn)
        same, differ = 0, []
        for fn in sorted(set(sides["new"]) | set(sides["parent"])):
            if sides["new"].get(fn) == sides["parent"].get(fn):
                same += 1
            else:
                differ.append(fn)
        print(f"  other kernels' SASS (the select's included), new vs "
              f"parent: {same} identical, {len(differ)} differ {differ}",
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
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def config(name):
        return (512, 7) if name == "parent" else VARIANTS[name][1:3]

    def fwd(name, x, out, wav, level, tile):
        threads, r = config(name)
        b, n = x.shape
        m = wav.length
        g, h = kl.kernel_taps(wav)
        code = libs[name].jw_modwpt_fwd(
            x.data_ptr(), out.data_ptr(), b, n, level, g.ctypes.data,
            h.ctypes.data, m, tile, kc.halo(m, level),
            layout(name, "pfwd", threads, r, tile, m, level),
            kl.DTYPE_CODES[x.dtype], 0, stream())
        assert code == 0, (name, code)
        return out

    def inv(name, c, out, wav, tile):
        threads, r = config(name)
        nodes, b, n = c.shape
        level, m = nodes.bit_length() - 1, wav.length
        g, h = kl.kernel_taps(wav)
        code = libs[name].jw_modwpt_inv(
            c.data_ptr(), out.data_ptr(), b, n, level, g.ctypes.data,
            h.ctypes.data, m, tile, kc.halo(m, level),
            layout(name, "pinv", threads, r, tile, m, level),
            kl.DTYPE_CODES[c.dtype], 0, stream())
        assert code == 0, (name, code)
        return out

    def tile_for(name, kind, level, m):
        return 2048 if name == "parent" else kc.tile_of(kind, level, m)

    def run_fwd(name, x, wav, level):
        out = torch.empty((1 << level,) + tuple(x.shape), dtype=x.dtype,
                          device=dev)
        return fwd(name, x, out, wav, level,
                   tile_for(name, "pfwd", level, wav.length))

    def run_inv(name, c, wav):
        out = torch.empty(tuple(c.shape[1:]), dtype=c.dtype, device=dev)
        level = c.shape[0].bit_length() - 1
        return inv(name, c, out, wav, tile_for(name, "pinv", level,
                                               wav.length))

    db4 = jt.wavelet("Daubechies 4")
    res = {}
    if "parent" in libs:
        cases = [FWD_SHAPE + (LEVEL, "Daubechies 4")] + list(PACKET_EDGES)
        for b, n, level, wname in cases:
            wav = jt.wavelet(wname)
            x32 = torch.randn(b, n, device=dev, generator=gen)
            inv_ok = kc.kernel_supported(n, level, wav.length, "pinv")
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                c = run_fwd("new", x, wav, level)
                eq = torch.equal(c, run_fwd("parent", x, wav, level))
                diff = (float((run_inv("new", c, wav).float() - run_inv(
                    "parent", c, wav).float()).abs().max()) if inv_ok
                    else float("nan"))
                print(f"  ({b}, {n}) L{level} {wname} {dt}: forward bitwise "
                      f"new == parent: {eq}; inverse new vs parent max-abs "
                      f"{diff:.3e}", flush=True)
                del c
            torch.cuda.empty_cache()
        # the select (#7), whose walk the forward now shares
        xs = torch.randn(*SELECT_SHAPE, device=dev, generator=gen)
        plan = kp.select_plan(*SELECT_SHAPE, LEVEL, db4.length)
        g, h = kl.kernel_taps(db4)
        partial = torch.empty((1 << LEVEL, SELECT_SHAPE[0], plan.ntiles),
                              dtype=torch.int64, device=dev)
        tickets = torch.zeros(256, dtype=torch.int32, device=dev)
        outs = {}

        def select(name):
            out = outs.setdefault(name, torch.empty(
                (3, 1 << LEVEL, SELECT_SHAPE[0]), device=dev))
            code = libs[name].jw_modwpt_select(
                xs.data_ptr(), partial.data_ptr(), tickets.data_ptr(),
                out.data_ptr(), *SELECT_SHAPE, LEVEL, g.ctypes.data,
                h.ctypes.data, db4.length, plan.tile, plan.smem, 0, 0,
                stream())
            assert code == 0, (name, code)
            return out

        print(f"  select {SELECT_SHAPE} L{LEVEL}: new == parent bitwise "
              f"{torch.equal(select('new'), select('parent'))}", flush=True)
        for rnd, order in enumerate((("parent", "new"), ("new", "parent"))):
            for name in order:
                ms = hz.graph_ms(lambda: select(name))
                res.setdefault(f"select {name} {SELECT_SHAPE}", []).append(ms)
                print(f"round {rnd} select {name} {SELECT_SHAPE}: {ms:.4f} "
                      f"ms [{card}]", flush=True)

    x = torch.randn(*FWD_SHAPE, device=dev, generator=gen)
    want_c = kp.modwpt_fwd_plain(x, db4, LEVEL)
    c = want_c.clone()
    want_x = kp.modwpt_inv_plain(c, db4)
    out_c = torch.empty_like(want_c)
    out_x = torch.empty_like(want_x)
    cases = [("parent", 2048, 512, 7)] if "parent" in libs else []
    for name, (_, threads, r, tiles, _, _) in VARIANTS.items():
        cases += [(name, t, threads, r) for t in tiles]
    for kind in ("fwd", "inv"):
        shape = FWD_SHAPE if kind == "fwd" else tuple(c.shape)
        todo = [cs for cs in cases
                if cs[0] == "parent" or kind in VARIANTS[cs[0]][5]]
        for rnd, order in enumerate((todo, todo[::-1])):
            for name, tile, threads, r in order:
                if kind == "fwd":
                    call = lambda: fwd(name, x, out_c, db4, LEVEL,  # noqa
                                       tile)
                    want = want_c
                else:
                    call = lambda: inv(name, c, out_x, db4, tile)  # noqa
                    want = want_x
                got = call()
                checked = name == "parent" or VARIANTS[name][4]
                err = (f"max-abs-err vs plain "
                       f"{float((got - want).abs().max()):.2e}" if checked
                       else "not the transform")
                ms = hz.graph_ms(call)
                key = f"{kind} {name} tile {tile} {shape}"
                res.setdefault(key, []).append(ms)
                print(f"round {rnd} {key}: {ms:.4f} ms, {err} [{card}]",
                      flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
