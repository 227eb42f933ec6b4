"""The median kernel (``csrc/median.cu``) against the sort path, and its
variants, on one card.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 probes/median_probe.py [--quick]
    python3 probes/median_probe.py --variants

The first builds the package's kernels, prints the assembler's report for
``jw_median_kernel`` and holds the kernel bitwise to the sort path
(``ops/denoise.py:_sort_median``) and to its plain version on the card, at
(1, n) and (16, n) for n from 1 to 2·10⁶ on Gaussian, tied, all-equal,
NaN, split-middle and special-value rows, over |x| and x, at a row start
off 16 bytes and over a non-contiguous axis (``--quick``: the long rows
only Gaussian and split).  The exit code is 1 if a check failed.

``--variants`` builds the kernel after text substitutions, each into
``build/probes/<variant>/``: ``first`` (four loads deep, no block count in
the launch bounds: the design as first written), ``deep8`` (eight loads
deep, two blocks an SM), ``match`` (pass 0's atomics aggregated over the
warp with ``__match_any_sync``) and ``forward`` (every pass walks the
blocks forward), and times each beside the sources (``base``) in device ms
a call (a CUDA graph of 20 calls between CUDA events) at (16, 1.7·10⁶) and
(16, 2²⁰) with 4, 8 and 16 blocks an SM a row split, each result checked
against the sort; then the base's time by pass from a profiler trace.
Each number stands beside the card's name and power limit; the last line
is one JSON object.
"""
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from jwave_pro_tpu_torch.kernels import _build  # noqa: E402
from jwave_pro_tpu_torch.kernels import _launch as kl  # noqa: E402
from jwave_pro_tpu_torch.kernels import median_cuda as km  # noqa: E402
from jwave_pro_tpu_torch.ops import denoise as dn  # noqa: E402
from probes import harness as hz  # noqa: E402

DEV = torch.device("cuda", 0)
LENGTHS = (1, 2, 3, 4, 5, 7, 8, 100, 1001, 8191, 8192, 16384, 16385,
           100003, 1 << 20, 1048573, 1700001, 1999936, 2000000)
KINDS = ("gauss", "ties", "equal", "nan", "split", "special")


def rows_of(kind: str, rows: int, n: int, rng) -> np.ndarray:
    """``rows`` float32 rows of ``n`` of one kind."""
    if kind == "gauss":
        return rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 4, (rows, n)).astype(np.float32)
    if kind == "equal":
        return np.full((rows, n), -2.5, np.float32)
    if kind == "nan":
        x = rng.standard_normal((rows, n)).astype(np.float32)
        x[::2, rng.integers(n)] = np.nan
        return x
    if kind == "split":   # the two middles far apart (even n), in any order
        lo = rng.uniform(1e-30, 2e-30, (rows, n - n // 2))
        hi = rng.uniform(1e30, 2e30, (rows, n // 2))
        x = np.concatenate([lo, hi], 1)
        return x[:, rng.permutation(n)].astype(np.float32)
    x = rng.standard_normal((rows, n)).astype(np.float32)   # special
    x[:, ::3] = np.inf
    x[:, 1::5] = -np.inf
    x[:, 2::7] = 1e-40
    x[:, 3::11] = 0.0
    return x


def same_bits(got, want, absolute: bool) -> bool:
    """Bitwise equal; on signed input a zero may stand for either zero."""
    g, w = got.view(torch.int32), want.view(torch.int32)
    if torch.equal(g, w):
        return True
    return not absolute and bool((((got == 0) & (want == 0)) | (g == w)).all())


def check(quick: bool) -> bool:
    rng = np.random.default_rng(2026)
    ok, cases = True, 0
    for n in LENGTHS:
        for rows in (1, 16):
            for kind in KINDS:
                if quick and n > 16385 and kind not in ("gauss", "split"):
                    continue
                x = torch.from_numpy(np.ascontiguousarray(
                    rows_of(kind, rows, n, rng))).to(DEV)
                for absolute in (True, False):
                    got = km.median_op(x, absolute)
                    want = dn._sort_median(x.abs() if absolute else x, -1)
                    plain = km.median_plain(x, absolute)
                    cases += 1
                    if not (same_bits(got, want, absolute)
                            and same_bits(plain, want, absolute)):
                        ok = False
                        print(f"  MISMATCH ({rows}, {n}) {kind} abs="
                              f"{absolute}: kernel {got[:4].tolist()} sort "
                              f"{want[:4].tolist()} plain "
                              f"{plain[:4].tolist()}", flush=True)
    # a row start off 16 bytes, and a last axis that is not contiguous
    flat = torch.randn(16 * 100003 + 3, device=DEV)
    x = flat[3:].reshape(16, 100003)
    ok &= same_bits(km.median_op(x, True), dn._sort_median(x.abs(), -1),
                    True)
    y = torch.randn(5000, 16, device=DEV)
    ok &= same_bits(dn.mad_sigma(y, axis=0),
                    dn._sort_median(y.abs(), 0) / 0.6745, True)
    # two calls agree bitwise
    z = torch.randn(16, 1 << 20, device=DEV)
    ok &= torch.equal(km.median_op(z, True), km.median_op(z, True))
    print(f"  {cases} cases kernel == sort == plain (bitwise): {ok}",
          flush=True)
    return ok


OUT = hz.ROOT / "build" / "probes"
ATOMIC = "        atomicAdd(&hist[k >> 21], 1u);\n"
MATCH = """        const unsigned bin = k >> 21;
        const unsigned peers = __match_any_sync(__activemask(), bin);
        if ((unsigned)lane == __ffs(peers) - 1u)
          atomicAdd(&hist[bin], (unsigned)__popc(peers));
"""
# variant -> substitutions of median.cu
LB = "__global__ void __launch_bounds__(JW_THREADS, 4)"
UNROLL = "#define JW_MED_UNROLL 2"
# variant -> substitutions of median.cu (base: two loads deep, four blocks
# an SM)
VARIANTS = {
    "base": [],
    "first": [hz.sub(LB, LB[:-4] + ")"),          # as first written
              hz.sub(UNROLL, "#define JW_MED_UNROLL 4")],
    "deep8": [hz.sub(LB, LB[:-3] + "2)"),
              hz.sub(UNROLL, "#define JW_MED_UNROLL 8")],
    "match": [hz.sub(ATOMIC, MATCH)],
    "forward": [hz.sub("(p0 == 1) ? (int)gridDim.x",
                       "(p0 == 9) ? (int)gridDim.x")],
}


def variants(card: str) -> dict:
    """Each variant's device ms a call (CUDA graph), at two shapes and
    three block counts a row, and the base's split by pass (profiler)."""
    def chain(fs):
        def apply(src):
            for f in fs:
                src = f(src)
            return src
        return apply

    libs, logs = hz.build({name: (hz.CSRC, ("median.cu",),
                                  {"median.cu": chain(subs)})
                           for name, subs in VARIANTS.items()}, OUT)
    for name in VARIANTS:
        print(f"  ptxas {name}: {hz.ptxas(logs[name], 'median')}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for shape in ((16, 1700001), (16, 1 << 20)):
        x = torch.randn(shape, device=DEV)
        want = dn._sort_median(x.abs(), -1)
        rows, n = shape
        for bps in (4, 8, 16):
            parts = max(1, min(-(-bps * sms // rows), n // km.MIN_PART))
            for name, lib in libs.items():
                out = torch.empty(rows, device=DEV)
                state = torch.empty((rows, km.STATE), dtype=torch.int32,
                                    device=DEV)

                def call():
                    st = torch.cuda.current_stream().cuda_stream
                    code = lib.jw_median(
                        x.data_ptr(), state.data_ptr(),
                        kl.zeroed("median", DEV, st, rows * km.SLOTS),
                        kl.tickets(DEV, st, rows), out.data_ptr(), rows, n,
                        parts, 1, 0, st)
                    assert code == 0, code
                ms = statistics.median(hz.graph_ms(call) for _ in range(2))
                call()
                good = torch.equal(out, want)
                res[f"{name}{shape}/{bps}"] = ms
                print(f"  variant {name} {shape} parts {parts}: {ms:.4f} ms"
                      f" equal {good} [{card}]", flush=True)
    x = torch.randn(16, 1700001, device=DEV)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            km.median_op(x, True)
        torch.cuda.synchronize()
    durs = [e.device_time_total for e in prof.events()
            if "jw_median" in e.name]
    passes = ([statistics.median(durs[p::3]) for p in range(3)]
              if len(durs) >= 3 else durs)
    print(f"  base (16, 1700001) by pass (µs, profiler): {passes} "
          f"[{card}]", flush=True)
    res["passes_us"] = passes
    return res


def main() -> int:
    card = hz.card()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    if "--variants" in sys.argv:
        print(json.dumps({"card": card, **variants(card)}), flush=True)
        return 0
    t0 = time.perf_counter()
    _build.library()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in sorted(_build.ptxas_report().items()):
        if "median" in name:
            print(f"  ptxas {name}: registers, stack, spills {rep}",
                  flush=True)
    ok = check("--quick" in sys.argv)
    print(json.dumps({"card": card, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
