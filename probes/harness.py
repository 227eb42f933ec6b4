"""What the kernel probes share: variant sources by text substitution, the
nvcc builds (all started together, one shared library a variant), ptxas's
and cuobjdump's reports, and device times from CUDA graphs.

Imported by ``probes/*_probe.py``; needs nvcc (and, for the times, an
NVIDIA card).
"""
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from jwave_pro_tpu_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "jwave_pro_tpu_torch" / "csrc"
GRAPH_CALLS = 20


def sub(old: str, new: str):
    """A substitution of a source's text that fails where ``old`` is not
    in it, so a probe never times a variant that silently is the base."""
    def apply(src: str) -> str:
        if old not in src:
            raise SystemExit(f"substitution target not found: {old[:60]!r}")
        return src.replace(old, new)
    return apply


def headers(src_dir: Path) -> tuple:
    """The ``.cuh`` headers of a ``csrc/`` directory, which every source
    may include."""
    return tuple(sorted(f.name for f in src_dir.glob("*.cuh")))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def nvcc(*args: str) -> subprocess.Popen:
    """nvcc with the package's flags, started in the background."""
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def wait(procs) -> dict:
    """Wait for [(name, process)]; each name's ptxas log (stderr).  Exits
    on the first failed build."""
    logs = {}
    for name, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: build failed\n{err[-3000:]}")
        logs[name] = logs.get(name, "") + err
    return logs


def build(jobs: dict, out: Path, extra=()):
    """Build every variant: ``jobs`` maps a name to (source directory,
    the .cu files it links, {file: substitution}).  Each variant's
    headers and files, substituted, go to ``out/<name>/``; every
    nvcc starts at once, ``extra`` [(name, process)] is waited for with
    them.  Returns ({name: its shared library}, {name: ptxas log})."""
    procs = list(extra)
    for name, (src_dir, files, subs) in jobs.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in headers(src_dir) + tuple(files):
            src = (src_dir / f).read_text()
            (d / f).write_text(subs[f](src) if f in subs else src)
        procs += [(name, nvcc("-c", "-o", str(d / (f + ".o")), str(d / f)))
                  for f in files]
    t0 = time.time()
    logs = wait(procs)
    print(f"built {len(jobs)} variants in {time.time() - t0:.1f} s",
          flush=True)
    libs = {}
    for name, (_, files, _) in jobs.items():
        d = out / name
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(d / "lib.so")] + [str(d / (f + ".o"))
                                              for f in files], check=True)
        libs[name] = _build.declare(ctypes.CDLL(str(d / "lib.so")))
    return libs, logs


def ptxas(log: str, *needles: str) -> list[str]:
    """'<type>[Li<M>E]:<registers>r/<stack>s/<spill stores>sp' of each
    kernel in a ptxas log whose name holds one of ``needles``."""
    regs = []
    for m in re.finditer(r"Compiling entry function '(\w+)'(.*?)Used "
                         r"(\d+) registers", log, re.S):
        fn = m.group(1)
        if not any(n in fn for n in needles):
            continue
        sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                       r"stores", m.group(2))
        inst = re.search(r"kernelI(\w+?)(Li\d+E)?E", fn)
        regs.append(f"{inst.group(1)[:2]}{inst.group(2) or ''}:"
                    f"{m.group(3)}r/{sp.group(1)}s/{sp.group(2)}sp")
    return regs


def sass(binary: Path) -> dict:
    """Function name -> its SASS text, with what depends on the rest of
    the file normalised: branch labels (numbered across the file)
    renumbered in order of first use within the function, and runs of
    blanks (the columns' padding follows the file's widest line) made
    one."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(binary)],
                          capture_output=True, text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        labels = {}
        out[name.strip()] = re.sub(r"[ \t]+", " ", re.sub(
            r"\.L_x_\d+", lambda m: labels.setdefault(
                m.group(0), f".L{len(labels)}"), body))
    return out


def sass_mix(body: str, top: int = 12) -> tuple[int, list]:
    """Instruction count of a function's SASS and its ``top`` opcodes."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", body)
    hist = {}
    for o in ops:
        hist[o] = hist.get(o, 0) + 1
    return len(ops), sorted(hist.items(), key=lambda kv: -kv[1])[:top]


def graph_ms(fn, rep: int = 5) -> float:
    """Device ms a call of ``fn``: a CUDA graph of GRAPH_CALLS calls
    replayed between CUDA events, the median of ``rep`` replays."""
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
    del graph
    return statistics.median(times)
