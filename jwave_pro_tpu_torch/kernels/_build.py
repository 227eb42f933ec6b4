"""Build the package's CUDA kernels with ``nvcc`` on first use.

All ``csrc/*.cu`` sources compile into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: seconds to build,
not minutes).  The library lands in ``build/kernels/<hash>/`` at the root of
the checkout, keyed on a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file.  Nothing is
downloaded; a failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "build_dir", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_LIB_NAME = "libjwave_kernels.so"


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


def _compile(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    # build next to the target, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, target)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    target = build_dir() / _LIB_NAME
    if not target.exists():
        _compile(target)
    lib = ctypes.CDLL(str(target))
    lib.jw_error_string.argtypes = [ctypes.c_int]
    lib.jw_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code:
        msg = lib.jw_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
