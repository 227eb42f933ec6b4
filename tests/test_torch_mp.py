"""The port's matching pursuit against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed handed to both packages.  Tolerances,
float64: picked nodes and shifts equal; amps and residuals 1e-10 absolute
(both run the same float64 transform; OMP's triangular solves and
contractions sum in another order, ~1e-15 relative at K ≤ 8).  Identities
the decomposition must satisfy on its own — reconstruction plus residual
equals the input, the greedy energy bookkeeping — hold to 1e-10.
"""
import functools

import numpy as np
import pytest
import torch

import jax

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu.ops.mp import _atom_tables as jax_atom_tables
from jwave_pro_tpu_torch.ops import mp as port_mp

DB4 = "Daubechies 4"
W_J, W_T = jw.wavelet(DB4), jt.wavelet(DB4)
LEVEL = 2


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_mp(level, k, method, orthogonalize):
    return jax.jit(lambda x: jw.matching_pursuit(
        x, W_J, level, k, method=method, orthogonalize=orthogonalize)[:4])


def _port_result(jax_fields, level):
    """The port's MPResult from the JAX one's arrays (a test helper: the
    package converts no results between frameworks)."""
    nodes, shifts, amps, residual = (_t(a) for a in jax_fields)
    return jt.MPResult(nodes, shifts, amps, residual, level, DB4)


def _assert_same(got, want, level=LEVEL):
    nodes, shifts, amps, residual = (np.asarray(a) for a in want)
    assert got.nodes.dtype == torch.int32 and got.shifts.dtype == torch.int32
    np.testing.assert_array_equal(got.nodes.numpy(), nodes)
    np.testing.assert_array_equal(got.shifts.numpy(), shifts)
    np.testing.assert_allclose(got.amps.numpy(), amps, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.residual.numpy(), residual, rtol=0,
                               atol=1e-10)
    assert got.level == level and got.wavelet_name == DB4


@pytest.mark.parametrize("orthogonalize", [False, True])
@pytest.mark.parametrize("shape,k,method", [
    ((64,), 6, "direct"),          # 1D
    ((3, 64), 4, "direct"),        # batched
    ((2, 100), 5, "auto"),         # arbitrary N, the default method
])
def test_matches_jax_f64(shape, k, method, orthogonalize):
    x = np.random.default_rng(sum(shape) + k).standard_normal(shape)
    want = _jax_mp(LEVEL, k, method, orthogonalize)(x)
    got = jt.matching_pursuit(_t(x), W_T, LEVEL, k, method=method,
                              orthogonalize=orthogonalize)
    assert got.amps.shape == shape[:-1] + (k,)
    _assert_same(got, want)


@pytest.mark.parametrize("n", [64, 32])
def test_omp_both_gram_branches_match_jax(n):
    """n ≥ 2S reads Gram rows from the lag table, n < 2S contracts the atom
    buffer (S = 22 at Db4 L2)."""
    s = (W_T.length - 1) * ((1 << LEVEL) - 1) + 1
    assert (n >= 2 * s) == (n == 64)
    x = np.random.default_rng(n).standard_normal((2, n))
    want = _jax_mp(LEVEL, 5, "direct", True)(x)
    got = jt.matching_pursuit(_t(x), W_T, LEVEL, 5, method="direct",
                              orthogonalize=True)
    _assert_same(got, want)
    # the residual is orthogonal to every selected atom
    rev, _ = port_mp._atom_tables(W_T, LEVEL, n)
    for b in range(2):
        for i in range(5):
            atom = np.roll(rev[int(got.nodes[b, i])], int(got.shifts[b, i]))
            assert abs(float(got.residual[b].numpy() @ atom)) < 1e-12


def _sparse_signal(rng):
    """(2, 256): three Db4 L2 atoms a row, amplitudes 4-8, plus 0.05 noise,
    so OMP's picks stay above its 50·eps·‖x‖ guard even in bf16."""
    picks = jt.MPResult(
        torch.tensor([[0, 3, 1], [2, 1, 3]], dtype=torch.int32),
        torch.tensor([[10, 140, 200], [60, 7, 181]], dtype=torch.int32),
        torch.tensor([[8.0, -6.0, 5.0], [-7.0, 6.5, 4.0]],
                     dtype=torch.float64),
        torch.zeros(2, 256, dtype=torch.float64), LEVEL, DB4)
    x = jt.mp_reconstruct(picks, W_T, 256).numpy()
    return x + 0.05 * rng.standard_normal(x.shape)


@pytest.mark.parametrize("signal", ["noise", "sparse"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_omp_low_precision_matches_jax(dtype, signal):
    """OMP of bf16/f16 input returns ``amps`` and ``residual`` in the input
    dtype, as JAX does; the port solves in float32 (torch's triangular
    solves take neither type), JAX in the input dtype, so the values agree
    within the bf16 bound, 5e-2.  The picks agree at every step: on white
    noise in bf16 the guard 50·eps·‖x‖ (≈ 6) lies above every correlation,
    so both packages park each pick (amps 0) and re-pick the same atom; on
    the sparse signal both find the three atoms and park the fourth pick
    (bf16, row 2: the third too)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 256)) if signal == "noise"
         else _sparse_signal(rng)).astype(np.float32)
    xj = jax.numpy.asarray(x).astype(dtype)
    k = 8 if signal == "noise" else 4
    want = _jax_mp(LEVEL, k, "auto", True)(xj)
    got = jt.matching_pursuit(_t(x).to(getattr(torch, dtype)), W_T, LEVEL,
                              k, orthogonalize=True)
    assert got.amps.dtype == got.residual.dtype == getattr(torch, dtype)
    assert str(want[2].dtype) == str(want[3].dtype) == dtype
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.shifts.numpy(), np.asarray(want[1]))
    for g, w in ((got.amps, want[2]), (got.residual, want[3])):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w.astype(np.float32)), rtol=0,
            atol=5e-2)


def test_reconstruct_and_energy_identities():
    x = np.random.default_rng(3).standard_normal((2, 64))
    xt = _t(x)
    r = jt.matching_pursuit(xt, W_T, LEVEL, 10, method="direct")
    # unit atoms: ‖x‖² − Σ α_k² = ‖r‖²
    e_in = (xt ** 2).sum(-1)
    e_res = (r.residual ** 2).sum(-1)
    torch.testing.assert_close(e_in - r.energies.sum(-1), e_res, rtol=0,
                               atol=1e-10)
    assert bool(torch.all(e_res < e_in))
    torch.testing.assert_close(jt.mp_reconstruct(r, W_T) + r.residual, xt,
                               rtol=0, atol=1e-10)
    # across packages: the port rebuilds the JAX result's atoms
    want = _jax_mp(LEVEL, 10, "direct", False)(x)
    port = _port_result(want, LEVEL)
    jax_rec = jw.mp_reconstruct(jw.MPResult(*want, LEVEL, DB4), W_J)
    np.testing.assert_allclose(jt.mp_reconstruct(port, W_T).numpy(),
                               np.asarray(jax_rec), rtol=0, atol=1e-12)


def test_atom_tables_match_jax():
    for n in (64, 100):
        rev, norms = port_mp._atom_tables(W_T, 3, n)
        rev_j, norms_j = jax_atom_tables(W_J, 3, n)
        np.testing.assert_array_equal(rev, rev_j)
        np.testing.assert_array_equal(norms, norms_j)
    # the subtraction touches only the atom's S-sample support
    win, s = port_mp._support_window_table(W_T, LEVEL, 64)
    r = torch.zeros(2, 64, dtype=torch.float64)
    out = port_mp._subtract_atom_windowed(
        r, torch.from_numpy(win), s, torch.tensor([1, 3]),
        torch.tensor([5, 40]), torch.tensor([1.0, -2.0], dtype=torch.float64))
    rev2 = torch.from_numpy(port_mp._atom_tables(W_T, LEVEL, 64)[0])
    atoms = port_mp._gather_atoms(rev2, torch.tensor([1, 3]),
                                  torch.tensor([5, 40]), 64)
    torch.testing.assert_close(out, -torch.tensor([[1.0], [-2.0]]) * atoms,
                               rtol=0, atol=1e-15)


def test_degenerate_picks_stay_finite():
    """More atoms than the signal's sparsity: the re-picked atoms are parked
    (zero atom, identity Gram row), nothing turns NaN."""
    rev, _ = port_mp._atom_tables(W_T, LEVEL, 64)
    x = 3.0 * np.roll(rev[2], 11)                       # one pure atom
    r = jt.matching_pursuit(_t(x), W_T, LEVEL, 6, method="direct",
                            orthogonalize=True)
    assert bool(torch.all(torch.isfinite(r.amps)))
    assert bool(torch.all(torch.isfinite(r.residual)))
    assert int(r.nodes[0]) == 2 and int(r.shifts[0]) == 11
    torch.testing.assert_close(jt.mp_reconstruct(r, W_T) + r.residual,
                               _t(x), rtol=0, atol=1e-8)
    assert float(r.residual.abs().max()) < 1e-6
    _assert_same(r, _jax_mp(LEVEL, 6, "direct", True)(x))


def test_exact_recovery_of_two_atoms():
    rev, _ = port_mp._atom_tables(W_T, LEVEL, 64)
    mix = 2.0 * np.roll(rev[1], 5) - 1.5 * np.roll(rev[3], 40)
    r = jt.matching_pursuit(_t(mix), W_T, LEVEL, 2, method="direct",
                            orthogonalize=True)
    assert set(r.nodes.tolist()) == {1, 3}
    assert set(r.shifts.tolist()) == {5, 40}
    assert sorted(r.amps.tolist()) == pytest.approx([-1.5, 2.0], abs=1e-9)


def test_validation_and_cpu_select_path():
    with pytest.raises(ValueError, match="n_atoms"):
        jt.matching_pursuit(torch.zeros(64), W_T, LEVEL, 0)
    # on the CPU even a (B, N) float32 input correlates through the
    # transform; the fused select is for CUDA tensors
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 256)).astype(np.float32))
    r = jt.matching_pursuit(x, W_T, 3, 4)
    assert r.amps.dtype == torch.float32 and r.residual.dtype == torch.float32
    torch.testing.assert_close(jt.mp_reconstruct(r, W_T) + r.residual, x,
                               rtol=0, atol=1e-5)
