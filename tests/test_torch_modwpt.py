"""The port's 1D MODWPT against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances:

* f64 transforms, tree, MRA and best-basis reconstruction, 1e-12 absolute:
  both run the same float64 arithmetic (rolls and multiply-adds, or the
  same host-built spectra through an FFT); only FFT library rounding
  differs.  Best-basis masks are compared exactly, total costs to 1e-9
  relative (sums of N·2^L logarithms).
* the packet kernels' plain versions against the JAX Pallas kernels in
  interpret mode, f32, 2e-5 absolute: the bound
  ``tests/test_pallas_kernels.py`` holds the Pallas kernels to; both
  compute in f32 in a different order.  Select positions are compared
  exactly (the random inputs have no near-ties at f32 resolution), select
  values to 2e-5.  bf16: one bf16 ulp (relative 2⁻⁷), both round the same
  f32 results once.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.kernels.modwpt_pallas import (
    imodwpt_fused as jax_imodwpt_fused, modwpt_fused as jax_modwpt_fused,
    modwpt_select_fused as jax_select_fused,
)
from jwave_pro_tpu_torch.kernels import modwpt_cuda as kp
from jwave_pro_tpu_torch.kernels import modwt_cuda as kc

port_modwpt = importlib.import_module("jwave_pro_tpu_torch.ops.modwpt")

DB4 = "Daubechies 4"
WAVELETS = [DB4, "Haar", "Symlet 8"]
# (shape, level): power of 2, odd and 100-sample signals, 1D and batched,
# every level 1..4
CASES = [((64,), 4), ((2, 101), 2), ((3, 100), 1), ((2, 64), 3)]
COSTS = ["shannon", "logenergy", "threshold", "sure"]


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax(fn, *static):
    """JIT the JAX function once per static arguments."""
    f = getattr(jw, fn)
    return jax.jit(lambda a: f(a, *static))


@pytest.mark.parametrize("method", ["direct", "fft", "auto_reference"])
@pytest.mark.parametrize("name", WAVELETS)
def test_modwpt_imodwpt_match_jax_f64(name, method):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    rng = np.random.default_rng(WAVELETS.index(name))
    for shape, level in CASES:
        x = rng.standard_normal(shape)
        want = np.asarray(_jax("modwpt", wj, level, method)(x))
        got = jt.modwpt(_t(x), wt, level, method=method)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12,
                                   err_msg=f"{name} {shape} L{level}")
        back_want = np.asarray(_jax("imodwpt", wj, method)(want))
        back = jt.imodwpt(_t(want), wt, method=method)
        np.testing.assert_allclose(back.numpy(), back_want, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-10)


def test_auto_and_integer_input_match_jax():
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    x = np.random.default_rng(7).standard_normal((2, 100))
    want = np.asarray(_jax("modwpt", wj, 3, "auto")(x))
    np.testing.assert_allclose(jt.modwpt(_t(x), wt, 3).numpy(), want,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(jt.imodwpt(_t(want), wt).numpy(),
                               np.asarray(_jax("imodwpt", wj, "auto")(want)),
                               rtol=0, atol=1e-12)
    xi = np.arange(64) % 5
    got = jt.modwpt(torch.from_numpy(xi), wt, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.modwpt(xi, wj, 2)),
                               atol=1e-5)


@pytest.mark.parametrize("name", [DB4, "Haar"])
def test_tree_and_mra_match_jax_f64(name):
    wj, wt = jw.wavelet(name), jt.wavelet(name)
    x = np.random.default_rng(3).standard_normal((2, 64))
    want = _jax("modwpt_tree", wj, 3, "direct")(x)
    got = jt.modwpt_tree(_t(x), wt, 3)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    mra = jt.modwpt_mra(_t(x), wt, 3)
    np.testing.assert_allclose(
        mra.numpy(), np.asarray(_jax("modwpt_mra", wj, 3, "direct")(x)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(mra.sum(0).numpy(), x, atol=1e-10)


def test_node_path_matches_jax():
    for level in range(1, 5):
        for node in range(1 << level):
            assert (jt.modwpt_node_path(level, node)
                    == jw.modwpt_node_path(level, node))
    for args in ((2, 4), (2, -1)):
        with pytest.raises(ValueError, match="out of range"):
            jt.modwpt_node_path(*args)


@pytest.mark.parametrize("cost", COSTS)
def test_best_basis_and_reconstruct_match_jax_f64(cost):
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    rng = np.random.default_rng(COSTS.index(cost))
    t = np.arange(128)
    x = (np.sin(2 * np.pi * 0.3 * t)[None] * np.ones((2, 1))
         + 0.3 * rng.standard_normal((2, 128)))
    masks_w, cost_w, tree_w = _jax("modwpt_best_basis", wj, 3, cost)(x)
    masks, total, tree = jt.modwpt_best_basis(_t(x), wt, 3, cost)
    for m, mw in zip(masks, masks_w):
        assert m.dtype == torch.bool
        np.testing.assert_array_equal(m.numpy(), np.asarray(mw))
    np.testing.assert_allclose(float(total), float(cost_w), rtol=1e-9)
    # every sample is covered by exactly one leaf of the basis
    covered = sum(m.repeat_interleave(1 << (3 - l)).long()
                  for l, m in enumerate(masks))
    assert bool(torch.all(covered == 1))
    rec = jt.modwpt_basis_reconstruct(tree, masks, wt)
    rec_w = jw.modwpt_basis_reconstruct(
        [jnp.asarray(r) for r in tree_w], masks_w, wj)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_w), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10)


def test_cost_functions_match_jax():
    jax_wpt = importlib.import_module("jwave_pro_tpu.ops.wpt")
    port_wpt = importlib.import_module("jwave_pro_tpu_torch.ops.wpt")
    c = np.random.default_rng(8).standard_normal((4, 33))
    c[0, :5] = 0.0                             # 0·ln 0 and ln 0 terms
    assert set(port_wpt._COSTS) == set(jax_wpt._COSTS)
    for name, fn in port_wpt._COSTS.items():
        np.testing.assert_allclose(fn(_t(c), axis=-1).numpy(),
                                   np.asarray(jax_wpt._COSTS[name](c)),
                                   rtol=1e-13, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(
        port_wpt.sure_cost(_t(c), axis=0, threshold=0.5).numpy(),
        np.asarray(jax_wpt.sure_cost(c, axis=0, threshold=0.5)), atol=1e-12)


def test_validation_and_cpu_dispatch():
    wt = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="2\\^level"):
        jt.imodwpt(torch.zeros(3, 64), wt)
    with pytest.raises(ValueError, match="exceeds"):
        jt.modwpt(torch.zeros(8), wt, 4)
    x = torch.zeros(8, 2048)
    assert port_modwpt._try_kernel(x, wt, 3) is None
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.modwpt(x, wt, 3, method="pallas")
    with pytest.raises(ValueError, match="fused kernel unavailable"):
        jt.imodwpt(torch.zeros(8, 4, 2048), wt, method="pallas")


# -- the kernels' plain versions against the JAX Pallas kernels --------------

@pytest.mark.parametrize("batch,n,level", [
    (8, 2048, 3),      # the JAX kernel tests' base shape
    (2, 4096, 4),      # small batch, 16 nodes (folded in the JAX kernel)
    (8, 5000, 2),      # arbitrary N (padded plan in the JAX kernel)
])
def test_packet_plain_versions_match_jax_interpret(batch, n, level):
    rng = np.random.default_rng(batch * n + level)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwpt_fused(jnp.asarray(x), wj, level,
                                       interpret=True))
    got = kp.modwpt_fused(_t(x), wt, level)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    back_want = np.asarray(jax_imodwpt_fused(jnp.asarray(want), wj,
                                             interpret=True))
    back = kp.imodwpt_fused(_t(want), wt)
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=2e-5)
    val, shift, sval = (np.asarray(a) for a in jax_select_fused(
        jnp.asarray(x), wj, level, interpret=True))
    got_a, got_t, got_v = kp.modwpt_select_fused(_t(x), wt, level)
    assert got_t.dtype == torch.int32 and got_t.shape == shift.shape
    np.testing.assert_array_equal(got_t.numpy(), shift)
    np.testing.assert_allclose(got_v.numpy(), sval, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_a.numpy(), val, rtol=0, atol=2e-5)


def test_select_plain_is_the_first_argmax_of_the_forward():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 300)).astype(np.float32))
    w = jt.wavelet(DB4)
    x[1, 40] = x[1, 41] = 50.0                  # an exact tie in the nodes
    c = kp.modwpt_fwd_plain(x, w, 2)
    a, t, v = kp.modwpt_select_plain(x, w, 2)
    assert torch.equal(t.long(), torch.argmax(c.abs(), dim=-1))
    assert torch.equal(v, torch.gather(c, -1, t.long()[..., None])[..., 0])
    assert torch.equal(a, v.abs())


def test_packet_plain_bf16_matches_jax_interpret():
    x = np.random.default_rng(5).standard_normal((8, 2048)).astype(np.float32)
    wj, wt = jw.wavelet(DB4), jt.wavelet(DB4)
    want = np.asarray(jax_modwpt_fused(jnp.asarray(x, jnp.bfloat16), wj, 2,
                                       interpret=True).astype(jnp.float32))
    got = kp.modwpt_fused(_t(x).bfloat16(), wt, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    back_want = np.asarray(jax_imodwpt_fused(
        jnp.asarray(want, jnp.bfloat16), wj, interpret=True
    ).astype(jnp.float32))
    back = kp.imodwpt_fused(_t(want).bfloat16(), wt)
    assert back.dtype == torch.bfloat16
    np.testing.assert_allclose(back.float().numpy(), back_want, rtol=2 ** -7,
                               atol=1e-6)
    # bf16 in, f32 arithmetic, bf16 out
    xt = _t(x[:2, :512]).bfloat16()
    assert torch.equal(kp.modwpt_fwd_plain(xt, wt, 2),
                       kp.modwpt_fwd_plain(xt.float(), wt, 2).bfloat16())


def test_packet_kernel_supported_budget():
    # Db4 L3: halo 7·7 = 49, every packet kernel takes any N
    for kind in ("pfwd", "select", "pinv"):
        assert kc.kernel_supported(1 << 18, 3, 8, kind)
        assert kc.kernel_supported(100003, 3, 8, kind)
        assert kc.kernel_supported(16, 4, 8, kind)        # halo > N
        assert kc.smem_bytes(3, 8, kind) <= kc.SMEM_LIMIT
    # shared memory grows with L, not 2^L: Db4 L8 forward and select fit,
    # the inverse's 2L rows stop at L7
    assert kc.kernel_supported(1 << 20, 8, 8, "pfwd")
    assert kc.kernel_supported(1 << 20, 8, 8, "select")
    assert kc.kernel_supported(1 << 20, 7, 8, "pinv")
    assert not kc.kernel_supported(1 << 20, 8, 8, "pinv")
    assert kp.select_fused_supported(8, 65536, 3, 8)
    assert not kp.select_fused_supported(8, 65536, 9, 8)


def test_fused_wrappers_raise_on_unsupported_input():
    w = jt.wavelet(DB4)
    with pytest.raises(ValueError, match="unsupported shape"):
        kp.modwpt_fused(torch.zeros(1 << 10), w, 10)
    with pytest.raises(ValueError):
        kp.modwpt_fused(torch.zeros(2, 2, 64), w, 2)
    with pytest.raises(ValueError, match="2\\^level"):
        kp.imodwpt_fused(torch.zeros(3, 64), w)
    with pytest.raises(ValueError):
        kp.modwpt_select_fused(torch.zeros(64), w, 2)
    for launch in (lambda: kp.modwpt_fwd_cuda(torch.zeros(2, 64), w, 2),
                   lambda: kp.modwpt_inv_cuda(torch.zeros(4, 2, 64), w),
                   lambda: kp.modwpt_select_cuda(torch.zeros(2, 64), w, 2)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()


@pytest.mark.parametrize("shape", [(2, 64), (96,)])
def test_gradcheck_autograd_pair_f64(shape):
    """Backward of each direction is the other kernel (Aᵀ = A⁻¹); on the
    CPU both run their plain versions, so gradcheck sees the exact pair."""
    w = jt.wavelet(DB4)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: kp.modwpt_fused(v, w, 2), (x,))
    c = torch.randn((4,) + shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: kp.imodwpt_fused(v, w), (c,))


# -- the select kernel's launch plan and register chains (the CUDA kernel
# runs on the card only; its geometry is plain Python, pinned here) --------

CHAIN_WAVELETS = ["Haar", "Daubechies 4", "Symlet 8"]


def _chain_starts(lo, end, s, r):
    """Window index of every output of one level, as ``jw_level_pair``
    (csrc/common.cuh) maps chains c to outputs: [chain][r] (-1 past end)."""
    d = 1 << s
    chains = -(-(end - lo) // (r * d)) * d
    c = np.arange(chains)[:, None]
    i = lo + (c >> s) * r * d + (c & (d - 1)) + np.arange(r)[None] * d
    return np.where(i < end, i, -1)


@pytest.mark.parametrize("kind", ["var", "select", "pfwd", "pinv"])
@pytest.mark.parametrize("s", range(0, 8))
def test_register_chains_cover_each_output_once_on_distinct_banks(kind, s):
    r = kc.CHAIN[kind]
    assert r % 2 == 1
    for lo, end in ((7, 2560), (0, 1), (217, 4313), (49, 100)):
        idx = _chain_starts(lo, end, s, r)
        got = np.sort(idx[idx >= 0])
        np.testing.assert_array_equal(got, np.arange(lo, end))
        # every warp's 32 lanes read 32 distinct banks at every load step
        full = -(-idx.shape[0] // 32) * 32
        first = lo + (np.arange(full)[:, None] >> s) * r * (1 << s) \
            + (np.arange(full)[:, None] & ((1 << s) - 1))
        for u in range(-7, r):
            banks = (first[:, 0] + u * (1 << s)) % 32
            assert all(len(set(banks[w:w + 32])) == 32
                       for w in range(0, full, 32))


@pytest.mark.parametrize("name", CHAIN_WAVELETS)
def test_select_plan_fits_every_admitted_level(name):
    m = jt.wavelet(name).length
    levels = [lv for lv in range(1, 16)
              if kp.select_fused_supported(1, 1 << 16, lv, m)]
    assert levels == list(range(1, levels[-1] + 1))
    for lv in levels:
        h = kc.halo(m, lv)
        for n in (1, 16, 2072, 2073, 4096, 4097, 65536, 100003):
            plan = kp.select_plan(3, n, lv, m)
            assert plan.smem <= kc.SMEM_LIMIT
            # the C entry point's shared-memory layout
            assert plan.smem == 4 * (128 + 8 * 16
                                     + (2 * lv - 1) * (plan.tile + h))
            # the tiles cover N exactly once
            assert plan.ntiles * plan.tile >= n > (plan.ntiles - 1) * plan.tile
            assert plan.grid == 3 * plan.ntiles and plan.chain == 5
    with pytest.raises(ValueError, match="unsupported shape"):
        kp.select_plan(1, 1 << 16, levels[-1] + 1, m)


def test_select_plan_edges_and_main_shape():
    # Db4: L8 the last level that fits (the gate must not narrow)
    assert kp.select_fused_supported(8, 65536, 8, 8)
    assert not kp.select_fused_supported(8, 65536, 9, 8)
    # a 4096 tile: (8, 65536) Db4 L3 is 16 tiles, 128 blocks, one an SM;
    # each level takes at most two chains a thread
    plan = kp.select_plan(8, 65536, 3, 8)
    assert plan == (4096, 16, 128, 83924, 5)
    lo = 0
    for j in range(1, 4):
        lo += 7 << (j - 1)
        assert _chain_starts(lo, 4096 + 49, j - 1, 5).shape[0] <= 2 * 512
    # cut where the 2L − 1 rows would not fit (Db4 L8: 15 rows)
    assert kc.tile_of("select", 8, 8) == 2072
    assert kp.select_plan(1, 1 << 16, 8, 8).smem <= kc.SMEM_LIMIT \
        < 4 * (128 + 128 + 15 * (2073 + 1785))
    # the tile cut to fit reaches further than a fixed 2048 tile would
    assert kp.select_fused_supported(1, 1 << 16, 11, 2)
    assert kp.select_fused_supported(1, 1 << 16, 8, 16)


def test_var_and_select_kernels_declare_no_static_shared_memory():
    """The plans may give a block's dynamic shared memory nearly all of
    ``SMEM_LIMIT`` (Db4 L8's select plan takes 232,444 of 232,448 bytes);
    the card refuses that launch if the kernel also declares static shared
    memory, so both kernels keep every shared word in the dynamic array."""
    from pathlib import Path
    csrc = Path(kc.__file__).resolve().parent.parent / "csrc"
    assert kp.select_plan(1, 1 << 16, 8, 8).smem > kc.SMEM_LIMIT - 16
    for name in ("variance.cu", "modwpt.cu"):
        lines = [ln.strip() for ln in (csrc / name).read_text().splitlines()
                 if "__shared__" in ln and not ln.lstrip().startswith("//")]
        assert lines and all(ln == "extern __shared__ float smem[];"
                             for ln in lines), (name, lines)


# -- the packet forward's and inverse's plans and leaf stores (the kernels
# run on the card only; their geometry is plain Python, pinned here) -------

CATALOG_LENGTHS = sorted({jt.wavelet(name).length
                          for name in jt.wavelet_names()})


@pytest.mark.parametrize("kind", ["pfwd", "pinv"])
@pytest.mark.parametrize("m", CATALOG_LENGTHS)
def test_packet_gates_admit_what_they_admitted_before_the_redesign(kind, m):
    """The forward's leaf slices and the inverse's root row come out of the
    tile, never the gate: for every filter length of the catalog, every
    level 1-13 and N in {16, 100003, 2^20}, each kernel admits exactly the
    shapes whose 2L − 1 (forward) or 2L (inverse) rows fit at the full
    2048-sample tile beside the taps -- the rule before the redesign -- and
    runs each within the budget."""
    for level in range(1, 14):
        h = kc.halo(m, level)
        rows = 2 * level - 1 if kind == "pfwd" else 2 * level
        before = 4 * (2 * 64 + rows * (2048 + h)) <= 232_448
        for n in (16, 100003, 1 << 20):
            assert kc.kernel_supported(n, level, m, kind) == before
        if before:
            tile = kc.tile_of(kind, level, m)
            assert 1 <= tile <= 2048
            assert kc.smem_bytes(level, m, kind) <= kc.SMEM_LIMIT


def test_packet_plans_at_the_main_shape_and_the_gate_edges():
    # Db4 L3: full tiles; four blocks an SM fit (the forward with its slices)
    assert kc.tile_of("pfwd", 3, 8) == kc.tile_of("pinv", 3, 8) == 2048
    assert 4 * (kc.smem_bytes(3, 8, "pfwd") + 1024) <= 233_472
    assert 4 * (kc.smem_bytes(3, 8, "pinv") + 1024) <= 233_472
    # the gate edges at N = 2^20: forward to Db4 L8, inverse to Db4 L7
    for kind, top in (("pfwd", 8), ("pinv", 7)):
        assert [lv for lv in range(1, 14) if kc.kernel_supported(
            1 << 20, lv, 8, kind)] == list(range(1, top + 1))
    # Db4 L8: the forward's tile cut to what the slices leave of 15 rows
    assert kc.tile_of("pfwd", 8, 8) == 1909
    assert kc.smem_bytes(8, 8, "pfwd") <= kc.SMEM_LIMIT \
        < kc.smem_bytes(8, 8, "pfwd", tile=1910)
    # the inverse's root row at L = 1 is a third row; above, the g̃ leaf row
    assert kc.smem_bytes(1, 8, "pinv") == 4 * (128 + 3 * (2048 + 7))
    assert kc.smem_bytes(2, 8, "pinv") == 4 * (128 + 4 * (2048 + 21))


def _leaf_turns(lo, end, s):
    """The packet forward's leaf level as ``jw_modwpt_fwd_kernel``
    (csrc/modwpt.cu) runs it: ``jw_level_pair``'s chains, warp by warp.
    Yields, for each warp's turn, the window index of its first output
    (lo + c0 R) and each lane's outputs [lane][r] (-1 for none)."""
    r, threads, d = kc.CHAIN["pfwd"], kc.PFWD_THREADS, 1 << s
    chains = -(-(end - lo) // (r * d)) << s
    for warp in range(threads // 32):
        for c0 in range(warp * 32, chains, threads):
            c = c0 + np.arange(32)[:, None]
            i = lo + (c >> s) * r * d + (c & (d - 1)) + np.arange(r) * d
            yield lo + c0 * r, np.where((c < chains) & (i < end), i, -1)


@pytest.mark.parametrize("n,level,m", [
    (17, 3, 8), (100003, 3, 2), (5000, 2, 16), (100003, 3, 4), (3000, 6, 2),
    (2000, 1, 16), (1 << 20, 8, 8), (1 << 18, 3, 8)])
def test_packet_leaves_stored_once_and_coalesced(n, level, m):
    """Every leaf output of a tile in [H, end) is stored exactly once.  At
    d < 32 a warp's turn emits exactly the window indices [first, first +
    32 R) below end, each lane's R outputs on distinct slice banks, and the
    warp stores both slices as consecutive addresses; at d >= 32 the lanes'
    outputs of one chain step are 32 consecutive indices, stored straight
    (the smoke's packet edge shapes and the main path's)."""
    r, h, s = kc.CHAIN["pfwd"], kc.halo(m, level), level - 1
    tile = kc.tile_of("pfwd", level, m)
    for end in sorted({h + min(tile, n), h + n - (n - 1) // tile * tile}):
        stored = []
        for first, idx in _leaf_turns(h, end, s):
            got = idx[idx >= 0]
            if s < 5:
                want = np.arange(first, min(first + 32 * r, end))
                np.testing.assert_array_equal(np.sort(got), want)
                for step in idx.T:   # slice writes of one chain step
                    live = step[step >= 0] - first
                    assert len(set(live % 32)) == len(live)
                k_lane = first + np.arange(r)[:, None] * 32 + np.arange(32)
                stored += [k_lane[k_lane < end]]
            else:
                for step in idx.T:
                    live = step[step >= 0]
                    np.testing.assert_array_equal(
                        live, live[:1] + np.arange(len(live)))
                stored += [got]
        stored = np.sort(np.concatenate(stored))
        np.testing.assert_array_equal(stored, np.arange(h, end))
