"""The port's MODWT against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 transforms, 1e-12 absolute: both run the same float64 arithmetic
  (rolls and multiply-adds, or the same host-built spectra through an FFT);
  only FFT library rounding differs, ~1e-15 at these sizes.
* the kernels' plain versions against the JAX Pallas kernels in interpret
  mode, f32, 2e-5 absolute: the bound ``tests/test_pallas_kernels.py``
  holds the Pallas kernels to; both compute in f32 in a different order.
* bf16 I/O, one bf16 ulp (relative 2⁻⁷): both compute in f32 and round
  once; the f32 results may straddle a bf16 rounding boundary.
"""
import functools
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.modwt_pallas import (
    imodwt_fused as jax_imodwt_fused, modwt_fused as jax_modwt_fused,
)
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc

port_modwt_module = importlib.import_module("jwave_pro_tpu_torch.ops.modwt")

REPO = Path(__file__).resolve().parent.parent
GOLDEN = np.load(REPO / "tests" / "golden" / "golden.npz")
GOLDEN_MODWT = sorted(k for k in GOLDEN.files if k.startswith("modwt_"))
WAVELETS = ["Daubechies 4", "Symlet 8", "Haar", "BiOrthogonal 3/5",
            "Discrete Meyer"]
# (shape, level): power of 2, odd and 100-sample signals; 1D and batched;
# every level 1..5.  Discrete Meyer's 62 taps make each JAX level a large
# graph to compile, so it runs the shallow cases only.
CASES = [((64,), 5), ((2, 101), 3), ((3, 100), 1), ((2, 64), 4),
         ((101,), 2)]
SHALLOW_CASES = [((64,), 2), ((2, 101), 1), ((100,), 1)]
ORTHOGONAL = ("Daubechies 4", "Symlet 8", "Haar")
DB4 = "Daubechies 4"


@functools.lru_cache(maxsize=None)
def _jax(fn, *static):
    """JIT the JAX function once per static arguments (eager JAX compiles
    every roll separately and is far slower)."""
    if fn == "modwt":
        return jax.jit(lambda x: jw.modwt(x, *static))
    if fn == "imodwt":
        return jax.jit(lambda c: jw.imodwt(c, *static))
    return jax.jit(lambda x: jw.modwt_mra(x, *static))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("method", ["direct", "fft", "auto_reference"])
@pytest.mark.parametrize("name", WAVELETS)
def test_modwt_imodwt_match_jax_f64(name, method):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(WAVELETS.index(name))
    for shape, level in (SHALLOW_CASES if name == "Discrete Meyer"
                         else CASES):
        x = rng.standard_normal(shape)
        want = np.asarray(_jax("modwt", wj, level, method)(x))
        got = jt.modwt(_t(x), wt, level, method=method)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12,
                                   err_msg=f"{name} {shape} L{level}")
        back_want = np.asarray(_jax("imodwt", wj, method)(want))
        back = jt.imodwt(_t(want), wt, method=method)
        np.testing.assert_allclose(back.numpy(), back_want, rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("name", WAVELETS)
def test_auto_and_mra_match_jax_f64(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 100))
    for level in (1,) if name == "Discrete Meyer" else (1, 3):
        want = np.asarray(_jax("modwt", wj, level, "auto")(x))
        np.testing.assert_allclose(jt.modwt(_t(x), wt, level).numpy(), want,
                                   rtol=0, atol=1e-12)
        mra = np.asarray(_jax("mra", wj, level, "direct")(x))
        got = jt.modwt_mra(_t(x), wt, level, method="direct").numpy()
        np.testing.assert_allclose(got, mra, rtol=0, atol=1e-12)
        # additive decomposition x = Σ D_j + S_J (orthogonal wavelets)
        if name in ORTHOGONAL:
            np.testing.assert_allclose(got.sum(0), x, atol=1e-10)


@pytest.mark.parametrize("key", GOLDEN_MODWT)
def test_golden_modwt_l4(key):
    """tests/golden/golden.npz's float64 oracle vectors (as test_golden)."""
    w = jt.wavelet(key[6:-3].replace("_", " ").replace("-", "/"))
    got = jt.modwt(_t(GOLDEN["input_100"]), w, 4, method="direct")
    np.testing.assert_allclose(got.numpy(), GOLDEN[key], atol=1e-10,
                               err_msg=key)


def test_circular_convolve_pair_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 37))
    f = rng.standard_normal(5)
    for jf, tf in ((jw.circular_convolve, jt.circular_convolve),
                   (jw.circular_convolve_adjoint,
                    jt.circular_convolve_adjoint)):
        np.testing.assert_allclose(tf(_t(x), f).numpy(),
                                   np.asarray(jf(x, f)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,level", [(64, 0), (64, 14), (64, 7), (100, 7),
                                     (1, 1)])
def test_check_level_errors_identical(n, level):
    x = np.zeros(n)
    with pytest.raises(ValueError) as jax_err:
        jw.modwt(x, jw.wavelet(DB4), level, method="direct")
    with pytest.raises(ValueError) as port_err:
        jt.modwt(_t(x), jt.wavelet(DB4), level, method="direct")
    assert str(port_err.value) == str(jax_err.value)


def test_integer_input_is_cast_to_float32():
    x = np.arange(64) % 7
    got = jt.modwt(torch.from_numpy(x), jt.wavelet(DB4), 2)
    want = np.asarray(_jax("modwt", jw.wavelet(DB4), 2, "auto")(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_composite_multipliers_are_cached_host_constants():
    w = jt.wavelet(DB4)
    a = port_modwt_module._composite_fft_multipliers(w, 3, 100)
    assert a is port_modwt_module._composite_fft_multipliers(w, 3, 100)
    assert a.dtype == np.complex128 and a.shape == (4, 51)


def test_cpu_dispatch_never_takes_the_kernel_route():
    x = torch.zeros(8, 2048)
    w = jt.wavelet(DB4)
    assert port_modwt_module._try_kernel(x, w, 3) is None
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.modwt(x, w, 3, method="pallas")
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.imodwt(torch.zeros(4, 8, 2048), w, method="pallas")


# -- the kernels' plain versions against the JAX Pallas kernels --------------

@pytest.mark.parametrize("batch,n,level", [
    (8, 2048, 3),      # the JAX kernel tests' base shape
    (16, 2048, 2),
    (8, 2000, 3),      # arbitrary N (padded plan in the JAX kernel)
])
def test_fused_plain_matches_jax_interpret(batch, n, level):
    rng = np.random.default_rng(batch * n + level)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt_fused(jnp.asarray(x), wj, level,
                                      interpret=True))
    got = kc.modwt_fused(_t(x), wt, level)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    back_want = np.asarray(jax_imodwt_fused(jnp.asarray(want), wj,
                                            interpret=True))
    back = kc.imodwt_fused(_t(want), wt)
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=2e-5)


def test_fused_plain_1d_contract_matches_jax_interpret():
    """(N,) → (L+1, N): the JAX package's flat kernel (L ≥ 4)."""
    x = np.random.default_rng(11).standard_normal(1 << 14).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt_fused(jnp.asarray(x), wj, 4, interpret=True))
    got = kc.modwt_fused(_t(x), wt, 4)
    assert got.shape == (5, 1 << 14)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    back = kc.imodwt_fused(got, wt)
    assert back.shape == (1 << 14,)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=2e-5)


def test_fused_plain_bf16_matches_jax_interpret():
    x = np.random.default_rng(5).standard_normal((8, 2048)).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwt_fused(jnp.asarray(x, jnp.bfloat16), wj, 3,
                                      interpret=True).astype(jnp.float32))
    got = kc.modwt_fused(_t(x).bfloat16(), wt, 3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    back_want = np.asarray(jax_imodwt_fused(
        jnp.asarray(want, jnp.bfloat16), wj, interpret=True
    ).astype(jnp.float32))
    back = kc.imodwt_fused(_t(want).bfloat16(), wt)
    assert back.dtype == torch.bfloat16
    np.testing.assert_allclose(back.float().numpy(), back_want,
                               rtol=2 ** -7, atol=1e-6)


def test_plain_versions_compute_in_f32_for_bf16():
    """bf16 in, bf16 out, f32 arithmetic in between (not bf16 arithmetic)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 512)).astype(np.float32)).bfloat16()
    w = jt.wavelet(DB4)
    got = kc.modwt_fwd_plain(x, w, 3)
    want = kc.modwt_fwd_plain(x.float(), w, 3).bfloat16()
    assert torch.equal(got, want)
    assert torch.equal(kc.modwt_inv_plain(got, w),
                       kc.modwt_inv_plain(got.float(), w).bfloat16())


def test_kernel_supported_budget():
    # Db4 L5: exact halo 7·31 = 217, every kernel fits
    assert kc.halo(8, 5) == 217
    for kind in ("fwd", "inv", "denoise"):
        assert kc.kernel_supported(1 << 20, 5, 8, kind)
        assert kc.kernel_supported(100003, 5, 8, kind)   # any N
        assert kc.smem_bytes(5, 8, kind) <= kc.SMEM_LIMIT
    # Db4 L13: 57,337-sample halo does not fit a block's shared memory
    assert kc.halo(8, 13) == 57337
    assert not any(kc.kernel_supported(1 << 20, 13, 8, k)
                   for k in ("fwd", "inv", "denoise"))
    assert kc.smem_bytes(5, 8, "denoise") > 48 * 1024   # needs the attribute
    assert not kc.kernel_supported(1 << 20, 2, 65, "fwd")  # > MAX_TAPS


def test_fused_wrappers_raise_on_unsupported_shapes():
    w = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="unsupported shape"):
        kc.modwt_fused(torch.zeros(1 << 13), w, 13)
    with pytest.raises(ValueError):
        kc.modwt_fused(torch.zeros(2, 2, 64), w, 2)
    with pytest.raises(ValueError):
        kc.modwt_fwd_cuda(torch.zeros(2, 64), w, 2)   # not a CUDA tensor


@pytest.mark.parametrize("shape", [(2, 64), (96,)])
def test_gradcheck_autograd_pair_f64(shape):
    """Backward of each direction is the other kernel (Aᵀ = A⁻¹); on the
    CPU both run their plain versions, so gradcheck sees the exact pair."""
    w = jt.wavelet(DB4)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: kc.modwt_fused(v, w, 2), (x,))
    c = torch.randn((3,) + shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: kc.imodwt_fused(v, w), (c,))


def test_import_leaves_jax_out():
    code = ("import sys, jwave_pro_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'jwave_pro_tpu' or m.startswith('jwave_pro_tpu.')]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# -- where a public entry point puts its input --------------------------------

_W = jt.wavelet("Daubechies 4")


def _stack(arrays):
    """Stack a band list in the arrays' own kind (tensor or NumPy)."""
    return (torch.stack(arrays) if isinstance(arrays[0], torch.Tensor)
            else np.stack(arrays))


ENTRY_POINTS = {
    "modwt": lambda a: jt.modwt(a, _W, 2),
    "imodwt": lambda a: jt.imodwt(_stack([a, a, a]), _W),
    "modwt_denoise": lambda a: jt.modwt_denoise(a, _W, 2),
    "modwt_variance": lambda a: jt.modwt_variance(a, _W, 2),
    "modwpt": lambda a: jt.modwpt(a, _W, 2),
    "modwt2": lambda a: jt.modwt2(a.reshape(8, 16), _W, 1),
    "imodwt3": lambda a: jt.imodwt3(_stack([a.reshape(2, 4, 16)] * 8), _W),
    "cwt": lambda a: jt.cwt(a, [1.0, 2.0], jt.MorletWavelet()).coefficients,
    "soft_threshold": lambda a: jt.soft_threshold(a, 0.5),
}


def _as_numpy_or_tensor(tensor: bool):
    x = np.random.default_rng(31).standard_normal(128)
    return torch.from_numpy(x) if tensor else x


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_tensor_input_stays_on_its_device(entry):
    out = ENTRY_POINTS[entry](_as_numpy_or_tensor(True))
    assert out.device.type == "cpu"


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_non_tensor_input_goes_to_the_card(entry):
    """A NumPy input is put on the card, as the JAX package puts it on its
    default device; without a card torch raises and nothing runs on the
    CPU."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[entry](_as_numpy_or_tensor(False)).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ENTRY_POINTS[entry](_as_numpy_or_tensor(False))


# -- the inverse and denoise kernels' register chains and plans (the CUDA
# kernels run on the card only; their geometry is plain Python, pinned
# here) ------------------------------------------------------------------

def _adjoint_outputs(lo, end, s, r):
    """Window index of every output of one synthesis level, as
    ``jw_level_adjoint`` (csrc/common.cuh) maps chains c to outputs:
    [chain][r] (-1 past end)."""
    d = 1 << s
    chains = -(-(end - lo) // (r * d)) * d
    c = np.arange(chains)[:, None]
    i = lo + (c >> s) * r * d + (c & (d - 1)) + np.arange(r)[None] * d
    return np.where(i < end, i, -1)


@pytest.mark.parametrize("kind", ["inv", "denoise"])
@pytest.mark.parametrize("s", range(0, 7))
def test_adjoint_chains_cover_each_output_once_on_distinct_banks(kind, s):
    r = kc.CHAIN[kind]
    assert r % 2 == 1
    d = 1 << s
    # (lo, end): the inverse's levels start at 0, the denoise's at its halo
    for lo, end in ((0, 4201), (0, 1), (217, 4313), (0, 100), (49, 86)):
        idx = _adjoint_outputs(lo, end, s, r)
        got = np.sort(idx[idx >= 0])
        np.testing.assert_array_equal(got, np.arange(lo, end))
        c = np.arange(idx.shape[0])
        first = lo + (c >> s) * r * d + (c & (d - 1))
        full = first + (r - 1) * d < end
        for m in (2, 8, 16):
            # a full chain reads i0 + u d, u < R + M - 1: inside the rows'
            # valid part [lo, end + (M - 1) d), so it needs no guard
            last = first[full] + (r + m - 2) * d
            assert (last < end + (m - 1) * d).all()
            # every warp's 32 lanes read 32 distinct banks at every step
            warps = -(-len(c) // 32) * 32
            lanes = np.arange(warps)
            start = lo + (lanes >> s) * r * d + (lanes & (d - 1))
            for u in range(r + m - 1):
                banks = (start + u * d) % 32
                assert all(len(set(banks[w:w + 32])) == 32
                           for w in range(0, warps, 32))


def _forward_turns(lo, end, s):
    """The forward's level as ``jw_modwt_fwd_kernel`` (csrc/modwt.cu) runs
    it: ``jw_level_pair``'s chains, warp by warp.  Yields, for each warp's
    turn, the window index of its first output (lo + c0 R) and each lane's
    outputs [lane][r] (-1 for none: past the last chain or past end)."""
    r, threads, d = kc.CHAIN["fwd"], kc.FWD_THREADS, 1 << s
    chains = -(-(end - lo) // (r * d)) << s
    for warp in range(threads // 32):
        for c0 in range(warp * 32, chains, threads):
            c = c0 + np.arange(32)[:, None]
            i = lo + (c >> s) * r * d + (c & (d - 1)) + np.arange(r) * d
            yield lo + c0 * r, np.where((c < chains) & (i < end), i, -1)


def _forward_levels(n, level, m):
    """(lo, end, s) of every level of the tiles of an (n,) row: the first
    tile and, if it differs, the ragged last one."""
    h, tile = kc.halo(m, level), kc.tile_of("fwd", level, m)
    ends = {h + min(tile, n), h + n - (n - 1) // tile * tile}
    return [((m - 1) * ((2 << s) - 1), end, s) for end in sorted(ends)
            for s in range(level)]


# the smoke's and the card test's forward edge shapes, and the main path
FWD_MAP_CASES = [(37, 3, 8), (100003, 5, 8), (1 << 13, 13, 2),
                 (1 << 10, 10, 16), (3000, 3, 6), (1 << 15, 13, 4),
                 (1 << 20, 5, 8)]


@pytest.mark.parametrize("n,level,m", FWD_MAP_CASES)
def test_forward_stores_each_output_once_and_coalesced(n, level, m):
    """Every W_j (and at the last level V_L) output of a tile in [H, end)
    is stored exactly once.  At d < 32 a warp's turn emits exactly the
    window indices [first, first + 32 R) below end, each lane's R outputs
    on distinct slice banks, and the warp stores its slice as consecutive
    addresses; at d >= 32 the lanes' outputs of one chain step are 32
    consecutive indices, stored straight."""
    r, h = kc.CHAIN["fwd"], kc.halo(m, level)
    for lo, end, s in _forward_levels(n, level, m):
        stored = []
        for first, idx in _forward_turns(lo, end, s):
            got = idx[idx >= 0]
            if s < 5:
                want = np.arange(first, min(first + 32 * r, end))
                np.testing.assert_array_equal(np.sort(got), want)
                for step in idx.T:   # slice writes of one chain step
                    live = step[step >= 0] - first
                    assert len(set(live % 32)) == len(live)
                k_lane = first + np.arange(r)[:, None] * 32 + np.arange(32)
                stored += [k_lane[(k_lane >= h) & (k_lane < end)]]
            else:
                for step in idx.T:
                    live = step[step >= 0]
                    np.testing.assert_array_equal(
                        live, live[:1] + np.arange(len(live)))
                stored += [got[got >= h]]
        stored = np.sort(np.concatenate(stored))
        np.testing.assert_array_equal(stored, np.arange(h, end))


@pytest.mark.parametrize("n,level,m", FWD_MAP_CASES[:6])
def test_forward_edge_shapes_cross_a_level_end(n, level, m):
    """Each forward edge shape leaves a register chain that crosses some
    level's end (its outputs below end computed one at a time)."""
    r = kc.CHAIN["fwd"]
    crossing = False
    for lo, end, s in _forward_levels(n, level, m):
        d = 1 << s
        chains = -(-(end - lo) // (r * d)) << s
        c = np.arange(chains)
        i0 = lo + (c >> s) * r * d + (c & (d - 1))
        crossing |= bool(((i0 < end) & (i0 + (r - 1) * d >= end)).any())
    assert crossing


@pytest.mark.parametrize("kind,m,top", [
    ("inv", 2, 13), ("inv", 8, 11), ("inv", 16, 9),
    ("denoise", 2, 10), ("denoise", 8, 8), ("denoise", 16, 7),
    ("fwd", 2, 14), ("fwd", 8, 11), ("fwd", 16, 10), ("fwd", 6, 12)])
def test_inverse_and_denoise_gates_keep_their_levels(kind, m, top):
    """At N = 2^20 each kernel admits every level up to ``top`` (Haar,
    Db4, Symlet 8) and none above."""
    admitted = [lv for lv in range(1, 21)
                if kc.kernel_supported(1 << 20, lv, m, kind)]
    assert admitted == list(range(1, top + 1))


@pytest.mark.parametrize("m", sorted({
    jt.wavelet(name).length for name in jt.wavelet_names()}))
def test_forward_gate_admits_what_it_admitted_before_the_w_slices(m):
    """The forward's W slices are paid for out of its tile, never its halo:
    for every filter length of the catalog and every level up to the
    public maximum, the forward admits exactly the shapes whose halo fits
    beside a full tile in two rows without the slices, the layout before
    them, and runs each within the budget."""
    for level in range(1, jt.MAX_DECOMPOSITION_LEVEL + 1):
        h = kc.halo(m, level)
        before = 4 * (2 * kc.MAX_TAPS + 2 * (kc.TILES["fwd"] + h)) \
            <= kc.SMEM_LIMIT
        assert kc.kernel_supported(1 << 20, level, m, "fwd") == before
        if before:
            assert kc.smem_bytes(level, m, "fwd") <= kc.SMEM_LIMIT
    # Daubechies 2 at L13, the gate's edge: the tile is cut to what the
    # slices leave
    assert kc.tile_of("fwd", 13, 4) == 3267
    assert kc.smem_bytes(13, 4, "fwd") == kc.SMEM_LIMIT


_ENTRY_POINTS = {"fwd": ("modwt.cu", "jw_modwt_fwd"),
                 "fwd_ctx": ("modwt.cu", "jw_modwt_fwd_ctx"),
                 "var": ("variance.cu", "jw_modwt_var"),
                 "select": ("modwpt.cu", "jw_modwpt_select"),
                 "inv": ("modwt.cu", "jw_modwt_inv"),
                 "inv_shrink": ("modwt_shrink.cu", "jw_modwt_inv_shrink"),
                 "denoise": ("denoise.cu", "jw_modwt_denoise"),
                 "pfwd": ("modwpt.cu", "jw_modwpt_fwd"),
                 "pinv": ("modwpt.cu", "jw_modwpt_inv")}


@pytest.mark.parametrize("kind", sorted(_ENTRY_POINTS))
def test_smem_bytes_is_the_layout_the_entry_point_accepts(kind):
    """The C entry point rejects any shared-memory size but its layout's;
    its check, read from the source and evaluated here, equals
    :func:`smem_bytes` for every level the gate admits (the forward's
    context variant takes the forward's plan, the shrinking inverse the
    inverse's)."""
    import re
    fname, fn = _ENTRY_POINTS[kind]
    kind = kind.removesuffix("_ctx").removesuffix("_shrink")
    src = (REPO / "jwave_pro_tpu_torch" / "csrc" / fname).read_text()
    body = src[src.index(f"int {fn}("):]
    expr = re.search(r"smem != \(int\)sizeof\(float\) \*\s*(\(.*?\))\)\s*"
                     r"return \(int\)cudaErrorInvalidValue", body,
                     re.S).group(1)
    for m in (2, 6, 8, 16):
        for lv in range(1, 14):
            if not kc.kernel_supported(1 << 20, lv, m, kind):
                continue
            names = {"JW_MAX_TAPS": kc.MAX_TAPS, "JW_WARPS": kc.WARPS,
                     "JW_FWD_SLICE": kc.FWD_SLICE,
                     "JW_PFWD_SLICE": kc.PFWD_SLICE,
                     "level": lv, "tile": kc.tile_of(kind, lv, m),
                     "halo": kc.halo(m, lv)}
            assert 4 * eval(expr, {}, names) == kc.smem_bytes(lv, m, kind)
