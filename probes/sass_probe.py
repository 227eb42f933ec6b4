"""cuobjdump's SASS of every kernel of this checkout's ``csrc/`` against
another checkout's, function by function.

Run from the root of a checkout, on a machine with nvcc (no card needed):

    python3 probes/sass_probe.py DIR [--same NAME ...]

``DIR``: the ``jwave_pro_tpu_torch/csrc`` directory of another checkout
(for example the parent commit, unpacked with ``git archive``).  Each
``.cu`` source of both sides is built alone to a cubin with the package's
nvcc flags under ``build/probes/sass/``, all at once, and the functions
are compared with ``harness.sass`` (branch labels and column padding
normalised).  Prints how many of DIR's kernels are identical here, the
names of those that differ and of those new here.  Exits 1 where a kernel
whose name holds one of the ``--same`` names (by default the forward #1,
its context variant and the inverse #3) is missing or differs.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from probes import harness as hz  # noqa: E402

OUT = hz.ROOT / "build" / "probes" / "sass"
SAME = ("jw_modwt_fwd_kernel", "jw_modwt_fwd_ctx_kernel",
        "jw_modwt_inv_kernel")


def functions(other: Path) -> dict:
    """{side: {function: SASS}} of this checkout ("new") and ``other``."""
    cubins, procs = {}, []
    for side, src in (("new", hz.CSRC), ("other", other)):
        d = OUT / side
        d.mkdir(parents=True, exist_ok=True)
        for f in sorted(src.glob("*.cu*")):
            (d / f.name).write_text(f.read_text())
        for f in sorted(src.glob("*.cu")):
            cubin = d / (f.name + ".cubin")
            cubins.setdefault(side, []).append(cubin)
            procs.append((side, hz.nvcc("-cubin", "-o", str(cubin),
                                        str(d / f.name))))
    hz.wait(procs)
    fns = {}
    for side, files in cubins.items():
        fns[side] = {}
        for cubin in files:
            fns[side].update(hz.sass(cubin))
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--same", nargs="+", default=SAME)
    args = ap.parse_args()
    fns = functions(args.other)
    new, other = fns["new"], fns["other"]
    same = [f for f in other if new.get(f) == other[f]]
    differ = sorted(set(other) - set(same))
    print(f"SASS against {args.other}: {len(same)} of {len(other)} kernels "
          f"identical; differ: {differ}; new: "
          f"{sorted(set(new) - set(other))}", flush=True)
    ok = True
    for kernel in args.same:
        mine = [f for f in other if kernel in f]
        good = bool(mine) and all(f in same for f in mine)
        print(f"{'ok  ' if good else 'FAIL'} every {kernel} instantiation "
              f"({len(mine)}) identical", flush=True)
        ok = ok and good
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
