"""Build the package's CUDA kernels with ``nvcc`` on first use.

All ``csrc/*.cu`` sources compile into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: seconds to build,
not minutes).  Each source compiles in its own ``nvcc`` process, all
started together, and one more links the objects: a cold build takes as
long as the largest source, not the sum.  The library lands in
``build/kernels/<hash>/`` at the root of the checkout, keyed on a hash of
the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file.  Nothing is
downloaded; a failed build raises with nvcc's stderr.  The flags include
``-Xptxas -v``: the assembler's report (registers, stack frame and
spills of every kernel) is kept beside the library as ``ptxas.log`` and
read back by :func:`ptxas_report`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "declare", "build_dir", "ptxas_report", "NVCC_FLAGS",
           "SIGNATURES"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libjwave_kernels.so"
_PTXAS_LOG = "ptxas.log"

# Every C entry point of the library, as the prototypes in the ``extern
# "C"`` blocks of ``csrc/*.cu`` declare it: (result, arguments), one letter
# a value: P a pointer, I an int, F a float, S a C string.  The int
# results are CUDA error codes, 0 for success (:func:`check`).
SIGNATURES = {
    "jw_error_string": ("S", "I"),
    "jw_modwt_fwd": ("I", "PPIIIPPIIIIIIP"),
    "jw_modwt_fwd_ctx": ("I", "PPPIIIPPIIIIIIP"),
    "jw_modwt_inv": ("I", "PPIIIPPIIIIIIP"),
    "jw_modwt_inv_shrink": ("I", "PPFIIIPIIIPPIIIIIIP"),
    "jw_modwt_denoise": ("I", "PPPIIIPPIIIIIIIP"),
    "jw_modwt_var": ("I", "PPPPIIIPPIIIIIP"),
    "jw_modwpt_fwd": ("I", "PPIIIPPIIIIIIP"),
    "jw_modwpt_select": ("I", "PPPPIIIPPIIIIIP"),
    "jw_modwpt_inv": ("I", "PPIIIPPIIIIIIP"),
    "jw_modwt2_fwd": ("I", "PPIIIIIPPIIIIIIIP"),
    "jw_modwt2_inv": ("I", "PPIIIIIPPIIIIIIIP"),
    "jw_modwt2_inv_shrink": ("I", "PPFIIIPIIIIIPPIIIIIIIP"),
    "jw_modwt2_denoise": ("I", "PPPPIIIIIPPIIIIIIIIP"),
    "jw_modwt2_blocks": ("I", "IIIIIP"),
    "jw_modwt3_fwd": ("I", "PPPIIIIIPPIPPIIP"),
    "jw_modwt3_inv": ("I", "PPPIIIIIPPIPIIP"),
    "jw_cwt_ifft": ("I", "PPPPIIIIIIP"),
    "jw_median": ("I", "PPPPPIIIIIP"),
}
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float,
           "S": ctypes.c_char_p}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def _run_all(cmds) -> list[str]:
    """Run the commands concurrently; return each one's stderr, or raise
    with the stderr of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def _compile(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build next to the target, then rename: concurrent builders never see
    # a half-written library
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                           for obj, src in zip(objs, _sources())])
        lib = str(Path(tmp) / _LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        (target.parent / _PTXAS_LOG).write_text("".join(report))
        os.replace(lib, target)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    target = build_dir() / _LIB_NAME
    if not target.exists():
        _compile(target)
    return declare(ctypes.CDLL(str(target)))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of every entry point of
    :data:`SIGNATURES` that ``lib`` exports (a probe's library built from
    some of the sources exports some); return ``lib``."""
    for name, (result, args) in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [_CTYPES[a] for a in args]
            fn.restype = _CTYPES[result]
    return lib


def ptxas_report() -> dict:
    """Per kernel of the built library (mangled name): (registers, stack
    frame bytes, spill store bytes, spill load bytes), from ``ptxas -v``."""
    text = (build_dir() / _PTXAS_LOG).read_text()
    out, name = {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            stack = tuple(int(v) for v in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = (int(m.group(1)),) + stack
            name = None
    return out


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code:
        msg = lib.jw_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
