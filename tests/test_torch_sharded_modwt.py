"""The signal-sharded MODWT forward (``parallel.modwt_sharded``): one ring
fetch of the whole halo, then the level cascade on this rank, against the
benchmark's plain float64 references, on the CPU.

How it runs: spawned gloo worlds of 2 and 4 ranks (a file store under a
``tmp_path_factory`` directory, as ``tests/test_torch_parallel.py``).
Every rank runs every case of :data:`CASES` on the global signal (each
rank keeps its own shard) and saves its own shard's coefficients, the
collectives it posted and their bytes, and the peak bytes its call
allocated (the profiler's memory events) to ``rank<r>.npz``.  The parent
holds each rank's shard to ``wavebench/reference/modwt_segment.py`` (the
shard and the samples before it) and the ranks' shards together to the
whole signal's ``wavebench/reference/modwt.py``.  The worker side imports
no JAX.

Cases: Daubechies 4 and Symlet 8 (16 taps) at levels 1–5 on three rows
(an odd count), a halo longer than a shard (several hops), a 1D signal
and a float32 signal.  Tolerances: float64 1e-12 relative to max|ref|
(the same sums in another order); float32 1e-6 (the plain path's float32
cascade against float64, ~10 ulps of the largest coefficient).

In this process: the context variant's plain model against the circular
forward on [context | shard] from column ``halo`` on.
"""
import json
import math
import multiprocessing
import os
import tempfile
import traceback
import zlib

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch.kernels import _launch as kl
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc
from jwave_pro_tpu_torch.ops.modwt import modwt_base_filters
from wavebench.reference import modwt as whole
from wavebench.reference import modwt_segment as segment

SEED = 20261018
JOIN_TIMEOUT = 180
WORLDS = (2, 4)
DB4, SYM8 = "Daubechies 4", "Symlet 8"

#: name -> (wavelet, level, shape of the global signal, dtype)
CASES = {
    **{f"db4_l{lv}": (DB4, lv, (3, 1024), "float64") for lv in range(1, 6)},
    **{f"sym8_l{lv}": (SYM8, lv, (3, 1024), "float64")
       for lv in range(1, 6)},
    # halos of 217 and 225 samples over shards of 64 or 128: 2-4 hops
    "db4_multihop": (DB4, 5, (2, 256), "float64"),
    "sym8_multihop_1d": (SYM8, 4, (256,), "float64"),
    "db4_f32": (DB4, 5, (5, 8192), "float32"),
}


def _x(name):
    wavelet, level, shape, dtype = CASES[name]
    rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
    return rng.standard_normal(shape).astype(dtype)


def _filters(name):
    return modwt_base_filters(jt.wavelet(name))


def _halo(name):
    wavelet, level, _, _ = CASES[name]
    return (jt.wavelet(wavelet).length - 1) * ((1 << level) - 1)


# ---------------------------------------------------------------------------
# The worker side
# ---------------------------------------------------------------------------

def _peak_bytes(fn):
    """(fn's result, the most bytes it had allocated at once beyond what
    was allocated when it started), from the profiler's memory events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, profile_memory=True) as p:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("name") == "[memory]"]
    if not events:
        return out, 0
    first = events[0]["args"]
    base = first["Total Allocated"] - first["Bytes"]
    return out, max(e["args"]["Total Allocated"] for e in events) - base


def _world(rank: int, size: int, path: str) -> None:
    import torch.distributed as dist

    from jwave_pro_tpu_torch import parallel as par
    from jwave_pro_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    par.init_distributed(f"file://{path}/store", size, rank,
                         device_type="cpu", timeout=60)
    mesh = par.make_mesh({"signal": size}, device_type="cpu")
    out = {}
    for name, (wavelet, level, _, _) in CASES.items():
        x = torch.from_numpy(_x(name))
        w = jt.wavelet(wavelet)
        sharded.reset_collectives()
        try:
            c, peak = _peak_bytes(
                lambda: par.modwt_sharded(x, w, level, mesh))
            out[f"{name}/c"] = c.to_local().numpy()
            out[f"{name}/hops"] = np.array(sharded.COLLECTIVES["hop"])
            out[f"{name}/bytes"] = np.array(sharded.COLLECTIVE_BYTES["hop"])
            out[f"{name}/peak"] = np.array(peak)
        except Exception:  # recorded, and reported by that case's test
            out[f"{name}/error"] = np.array(traceback.format_exc())
    np.savez(f"{path}/rank{rank}.npz", **out)
    dist.destroy_process_group()


def _run_world(path, size: int) -> list:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_world, args=(r, size, str(path)))
             for r in range(size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    assert not alive and codes == [0] * size, \
        f"world of {size}: exit codes {codes} (None: killed at the timeout)"
    ranks = []
    for r in range(size):
        with np.load(path / f"rank{r}.npz") as saved:
            ranks.append(dict(saved))
    return ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {size: _run_world(tmp_path_factory.mktemp(f"w{size}"), size)
            for size in WORLDS}


def _shards(ranks, name):
    for r in ranks:
        assert f"{name}/error" not in r, str(r.get(f"{name}/error"))
    return [r[f"{name}/c"] for r in ranks]


def _rel(got, want, tol):
    err = np.abs(np.asarray(got, np.float64) - want).max() \
        / np.abs(want).max()
    assert err <= tol, f"relative error {err:.3e} > {tol:.0e}"


def _tol(name):
    return 1e-6 if CASES[name][3] == "float32" else 1e-12


PAIRS = [(size, name) for size in WORLDS for name in CASES]
IDS = [f"w{size}-{name}" for size, name in PAIRS]


@pytest.mark.parametrize("size,name", PAIRS, ids=IDS)
def test_shards_together_are_the_whole_signals_modwt(worlds, size, name):
    got = np.concatenate(_shards(worlds[size], name), axis=-1)
    x = torch.from_numpy(_x(name)).double()
    want = whole.modwt(x, _filters(CASES[name][0]), CASES[name][1])
    _rel(got, want.numpy(), _tol(name))


@pytest.mark.parametrize("size,name", PAIRS, ids=IDS)
def test_each_shard_is_its_segment(worlds, size, name):
    """Each rank's coefficients from its own shard and the ``halo``
    samples before it (the left neighbours' last ones, round the ring)."""
    x = torch.from_numpy(_x(name)).double()
    n = x.shape[-1] // size
    h = _halo(name)
    for r, got in enumerate(_shards(worlds[size], name)):
        before = torch.roll(x, h - r * n, dims=-1)[..., :h]
        want = segment.modwt_segment(x[..., r * n:(r + 1) * n], before,
                                     _filters(CASES[name][0]),
                                     CASES[name][1], block=100)
        _rel(got, want.numpy(), _tol(name))


@pytest.mark.parametrize("size,name", PAIRS, ids=IDS)
def test_one_fetch_of_the_whole_halo(worlds, size, name):
    """The forward's only collectives: ⌈halo / shard⌉ hops, each sending
    only the samples the next rank keeps, the halo's rows × halo samples
    in all (one hop where the halo fits in a shard)."""
    x = _x(name)
    n = x.shape[-1] // size
    h = _halo(name)
    rows = math.prod(x.shape[:-1])
    for r in worlds[size]:
        assert int(r[f"{name}/hops"]) == -(-h // n)
        assert int(r[f"{name}/bytes"]) == rows * h * x.itemsize


@pytest.mark.parametrize("size", WORLDS)
def test_the_plain_path_writes_its_output_once(worlds, size):
    """The plain path holds the output, the shard extended by its halo and
    one level's V beside the input, and the halo it fetched: under the two
    copies of the output that a list of rows and their stack take."""
    name = "db4_f32"
    x = _x(name)
    rows, n, h = x.shape[0], x.shape[-1] // size, _halo(name)
    out_bytes = (CASES[name][1] + 1) * rows * n * x.itemsize
    held = out_bytes + (2 * (n + h) + 2 * h) * rows * x.itemsize
    for r in worlds[size]:
        peak = int(r[f"{name}/peak"])
        assert out_bytes <= peak <= held < 2 * out_bytes, (peak, held)


# ---------------------------------------------------------------------------
# The context variant's plain model, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [DB4, SYM8])
@pytest.mark.parametrize("level", range(1, 6))
def test_plain_model_with_context_is_the_circular_forward(name, level):
    """The forward of [context | shard], from column ``halo`` on: there no
    output reads past the context, so the wrap never enters."""
    w = jt.wavelet(name)
    h = kc.halo(w.length, level)
    gen = torch.Generator().manual_seed(level)
    x = torch.randn(3, 700, dtype=torch.float64, generator=gen)
    ctx = torch.randn(3, h, dtype=torch.float64, generator=gen)
    got = kc.modwt_fwd_ctx_plain(x, ctx, w, level)
    want = kc.modwt_fwd_plain(torch.cat([ctx, x], dim=-1), w, level)
    torch.testing.assert_close(got, want[..., h:], rtol=0, atol=1e-13)


def test_plain_model_keeps_dtypes_and_refuses_a_wrong_context():
    w = jt.wavelet(DB4)
    x, ctx = torch.randn(2, 300), torch.randn(2, kc.halo(8, 3))
    got = kc.modwt_fwd_ctx_plain(x.bfloat16(), ctx.bfloat16(), w, 3)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 2, 300)
    assert kc.modwt_fwd_ctx_plain(x, ctx, w, 3).dtype == torch.float32
    with pytest.raises(ValueError, match="context"):
        kc.modwt_fwd_ctx_plain(x, ctx[:, 1:], w, 3)
    with pytest.raises(ValueError, match="context"):
        kc.modwt_fwd_ctx_plain(x, ctx, w, 4)


def test_the_cpu_shard_takes_the_plain_path():
    """``modwt_shard`` of a CPU shard launches nothing and is the plain
    model; with a gradient wanted, the gradient flows to both operands."""
    w = jt.wavelet(DB4)
    before = kl.LAUNCHES["modwt_fwd_ctx"]
    x = torch.randn(2, 256, requires_grad=True)
    ctx = torch.randn(2, kc.halo(8, 4), requires_grad=True)
    got = kc.modwt_shard(x, ctx, w, 4)
    torch.testing.assert_close(got, kc.modwt_fwd_ctx_plain(x, ctx, w, 4),
                               rtol=0, atol=0)
    got.sum().backward()
    assert x.grad is not None and ctx.grad is not None
    assert kl.LAUNCHES["modwt_fwd_ctx"] == before
