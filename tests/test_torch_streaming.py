"""The port's streaming transforms against the JAX package's, on the CPU.

Streams are configured with ``device="cpu"``; chunks are numpy arrays from
a seed handed to both packages.  Tolerances: at float64 the incremental,
full-recompute and chunked MODWT, the windowed transforms and the variance
trackers 1e-12 relative to max|ref| (the same cascade on the same
windows; the JAX package's direct path against the port's); at float32,
1e-6 relative (f32 sums in another order).  Buffer contents, heads and
counts exact.  The ``trace_counts`` pins of ``tests/test_streaming.py``
hold as there: one first call per chunk shape.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jwave_pro_tpu as jw
import jwave_pro_tpu_torch as jt
from jwave_pro_tpu import streaming as jst
from jwave_pro_tpu_torch import streaming as tst

DB4_J, DB4_T = jw.wavelet("Daubechies 4"), jt.wavelet("Daubechies 4")
HAAR_J, HAAR_T = jw.wavelet("Haar"), jt.wavelet("Haar")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _cfgs(dtype="float64", **kw):
    return (jst.StreamingConfig(dtype=getattr(jnp, dtype), **kw),
            tst.StreamingConfig(dtype=getattr(torch, dtype), device="cpu",
                                **kw))


def test_port_has_the_same_public_names():
    assert tst.__all__ == jst.__all__
    assert len(tst.__all__) == 15


def test_circular_buffer_matches_jax():
    bj = jst.CircularBuffer.create(8, jnp.float64)
    bt = tst.CircularBuffer.create(8, torch.float64, "cpu")
    for chunk in (np.array([1.0, 2, 3]), np.array([4.0, 5, 6, 7, 8, 9]),
                  np.arange(5.0), np.arange(11.0), np.array([-1.0])):
        bj, bt = bj.append(chunk), bt.append(chunk)
        np.testing.assert_array_equal(bt.data.numpy(), np.asarray(bj.data))
        assert (bt.head, bt.count) == (int(bj.head), int(bj.count))
        np.testing.assert_array_equal(bt.to_array().numpy(),
                                      np.asarray(bj.to_array()))
        for size in (3, 8):
            np.testing.assert_array_equal(bt.window(size).numpy(),
                                          np.asarray(bj.window(size)))
    b0 = tst.CircularBuffer.create(4, device="cpu")
    b1 = b0.append(np.arange(3.0))
    assert float(b0.data.abs().sum()) == 0.0       # append returns a new one
    assert b1.capacity == 4 and b1.data.dtype == torch.float32


def test_circular_buffer_oversize_append():
    b = tst.CircularBuffer.create(4, device="cpu").append(np.arange(10.0))
    np.testing.assert_allclose(b.to_array().numpy(), [6, 7, 8, 9])


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
def test_incremental_modwt_matches_jax(dtype, tol):
    cj, ct = _cfgs(dtype, buffer_size=256, max_level=3)
    sj, stt = jst.StreamingMODWT(DB4_J, cj), tst.StreamingMODWT(DB4_T, ct)
    sig = np.random.default_rng(0).standard_normal(1024)
    for i in range(0, 1024, 64):
        want = np.asarray(sj.update(sig[i:i + 64]))
        got = stt.update(sig[i:i + 64])
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got.numpy(), want) <= tol
    full = np.asarray(jw.modwt(sig, DB4_J, 3, method="direct"))
    np.testing.assert_allclose(got.numpy()[:, -64:], full[:, -64:],
                               atol=1e-5)


def test_full_recompute_matches_jax():
    cj = jst.StreamingConfig(
        buffer_size=128, max_level=2, dtype=jnp.float64,
        update_strategy=jst.UpdateStrategy.FULL_RECOMPUTE)
    ct = tst.StreamingConfig(
        buffer_size=128, max_level=2, dtype=torch.float64, device="cpu",
        update_strategy=tst.UpdateStrategy.FULL_RECOMPUTE)
    sj, stt = jst.StreamingMODWT(DB4_J, cj), tst.StreamingMODWT(DB4_T, ct)
    sig = np.random.default_rng(1).standard_normal(320)
    for chunk in (sig[:128], sig[128:160], sig[160:]):
        assert _rel(stt.update(chunk).numpy(),
                    np.asarray(sj.update(chunk))) <= 1e-12


@pytest.mark.parametrize("batch", [(), (3,)])
def test_modwt_chunked_matches_jax(batch):
    sig = np.random.default_rng(2).standard_normal(batch + (512,))
    level = 3
    chunks = [sig[..., i:i + 128] for i in range(0, 512, 128)]
    want = np.concatenate([np.asarray(c) for c in jst.modwt_chunked(
        chunks, DB4_J, level)], axis=-1)
    got = torch.cat(list(tst.modwt_chunked(
        [torch.from_numpy(c) for c in chunks], DB4_T, level)), dim=-1)
    assert tuple(got.shape) == want.shape == (level + 1,) + batch + (512,)
    assert _rel(got.numpy(), want) <= 1e-12
    halo = (DB4_T.length - 1) * ((1 << level) - 1)
    full = jt.modwt(torch.from_numpy(sig), DB4_T, level, method="direct")
    assert _rel(got.numpy()[..., halo:], full.numpy()[..., halo:]) <= 1e-12


def test_factory_and_windowed_transforms_match_jax():
    assert isinstance(tst.streaming_transform("modwt", DB4_T,
                                              tst.StreamingConfig(
                                                  256, device="cpu")),
                      tst.StreamingMODWT)
    with pytest.raises(ValueError, match="unknown streaming"):
        tst.streaming_transform("nope")
    rng = np.random.default_rng(3)
    for kind in ("fwt", "wpt", "fft"):
        cj, ct = _cfgs(buffer_size=64, max_level=3)
        sj = jst.streaming_transform(kind, DB4_J, cj)
        stt = tst.streaming_transform(kind, DB4_T, ct)
        for _ in range(3):
            chunk = rng.standard_normal(24)
            want, got = sj.update(chunk), stt.update(chunk)
            assert tuple(got.shape) == np.shape(want)
            assert _rel(got.numpy(), want) <= 1e-12, kind
    s = tst.streaming_transform("fft", None, tst.StreamingConfig(
        buffer_size=16, device="cpu"))
    assert abs(complex(s.update(np.ones(16))[0]) - 16.0) < 1e-6


def test_recommended_buffer_size_matches_jax():
    for args in (("fwt", 100, 4), ("modwt", 10, 4), ("cwt", 3, 2),
                 ("fft", 1000, 3)):
        assert tst.recommended_buffer_size(*args) == \
            jst.recommended_buffer_size(*args)


def test_jax_saved_state_continues_in_the_port(tmp_path):
    """A state saved by the JAX package loads into the port, and the
    updates after it equal the JAX stream's own continuing updates; the
    port's state loads into the JAX package the same way."""
    rng = np.random.default_rng(4)
    sig = rng.standard_normal(512)
    cj, ct = _cfgs(buffer_size=128, max_level=3)
    sj = jst.StreamingMODWT(DB4_J, cj)
    for i in range(0, 192, 64):
        sj.update(sig[i:i + 64])
    path = str(tmp_path / "jax_state.npz")
    jst.save_state(sj, path)
    stt = tst.StreamingMODWT(DB4_T, ct)
    tst.load_state(stt, path)
    assert (stt.buffer.head, stt.buffer.count) == (int(sj.buffer.head),
                                                   int(sj.buffer.count))
    for i in range(192, 512, 64):
        assert _rel(stt.update(sig[i:i + 64]).numpy(),
                    np.asarray(sj.update(sig[i:i + 64]))) <= 1e-12
    back = str(tmp_path / "port_state")
    tst.save_state(stt, back)
    keys = sorted(np.load(back + ".npz").files)
    assert keys == sorted(np.load(path).files)
    sj2 = jst.StreamingMODWT(DB4_J, cj)
    jst.load_state(sj2, back)
    chunk = rng.standard_normal(64)
    assert _rel(np.asarray(sj2.update(chunk)),
                stt.update(chunk).numpy()) <= 1e-12


def test_variance_state_round_trips_with_jax(tmp_path):
    rng = np.random.default_rng(5)
    cj, ct = _cfgs(buffer_size=256, max_level=2)
    vj = jst.StreamingVariance(HAAR_J, cj)
    for _ in range(5):
        vj.update(rng.standard_normal(64))
    p = str(tmp_path / "sv_state")
    jst.save_state(vj, p)
    vt = tst.StreamingVariance(HAAR_T, ct)
    tst.load_state(vt, p)
    np.testing.assert_array_equal(vt.variance.numpy(),
                                  np.asarray(vj.variance))
    chunk = rng.standard_normal(64)
    assert _rel(vt.update(chunk).numpy(),
                np.asarray(vj.update(chunk))) <= 1e-12


@pytest.mark.parametrize("halflife", [None, 64.0])
def test_streaming_variance_matches_jax(halflife):
    rng = np.random.default_rng(6)
    cj, ct = _cfgs(buffer_size=512, max_level=3)
    vj = jst.StreamingVariance(DB4_J, cj, halflife=halflife)
    vt = tst.StreamingVariance(DB4_T, ct, halflife=halflife)
    seen = []
    vt.add_listener(lambda v: seen.append(v))
    for _ in range(12):
        chunk = rng.standard_normal(128)
        want, got = np.asarray(vj.update(chunk)), vt.update(chunk)
        assert _rel(got.numpy(), want) <= 1e-12
    assert len(seen) == 12 and tuple(seen[-1].shape) == (3,)
    vt.reset()
    assert float(vt.variance.abs().max()) == 0.0
    with pytest.raises(ValueError, match="incremental window"):
        vt.update(rng.standard_normal(500))


def test_streaming_cwt_matches_jax():
    rng = np.random.default_rng(7)
    scales = jt.generate_log_scales(1.0, 8.0, 4)
    cj, ct = _cfgs(buffer_size=64)
    sj = jst.StreamingCWT(jw.MorletWavelet(), cj, scales=scales)
    stt = tst.StreamingCWT(jt.MorletWavelet(), ct, scales=scales)
    for _ in range(2):
        chunk = rng.standard_normal(40)
        assert _rel(stt.update(chunk).numpy(),
                    np.asarray(sj.update(chunk))) <= 1e-12
    res = stt.result()
    assert tuple(res.magnitude.shape) == (4, 64)
    ref = jt.cwt(stt.get_current_buffer(), scales,
                 jt.MorletWavelet()).coefficients
    assert _rel(res.coefficients.numpy(), ref.numpy()) <= 1e-12


def test_listeners_fire_and_detach():
    cfg = tst.StreamingConfig(buffer_size=128, max_level=2, device="cpu")
    s = tst.StreamingMODWT(DB4_T, cfg)
    seen = []
    s.add_listener(lambda c: seen.append(c.clone()))
    out1 = s.update(np.random.default_rng(8).standard_normal(64))
    assert len(seen) == 1 and torch.equal(seen[0], out1)
    s.remove_listener(s._listeners[0])
    s.update(np.ones(64))
    assert len(seen) == 1


def test_updates_count_one_first_call_per_chunk_shape():
    """``tests/test_streaming.py``'s trace pins, ported."""
    rng = np.random.default_rng(9)
    cfg = tst.StreamingConfig(buffer_size=256, max_level=3, device="cpu")
    s = tst.StreamingMODWT(DB4_T, cfg)
    sig = rng.standard_normal(1024)
    s.update(sig[0:64])
    after_first = tst.trace_counts["modwt_incremental"]
    for i in range(64, 1024, 64):
        s.update(sig[i:i + 64])
    assert tst.trace_counts["modwt_incremental"] == after_first
    s.update(rng.standard_normal(32))
    assert tst.trace_counts["modwt_incremental"] <= after_first + 1

    sw = tst.StreamingWPT(DB4_T, tst.StreamingConfig(buffer_size=64,
                                                     max_level=3,
                                                     device="cpu"))
    sw.update(rng.standard_normal(64))
    base = tst.trace_counts["wpt"]
    for _ in range(5):
        sw.update(rng.standard_normal(64))
    assert tst.trace_counts["wpt"] == base


def test_variance_steps_count_once():
    tst.trace_counts.clear()
    # a configuration no other test streams: its first calls are new
    cfg = tst.StreamingConfig(buffer_size=320, max_level=2, device="cpu")
    sv = tst.StreamingVariance(HAAR_T, cfg)
    for _ in range(10):
        sv.update(np.random.default_rng(10).standard_normal(48))
    assert tst.trace_counts["variance_cum"] == 1
    assert tst.trace_counts["modwt_incremental"] == 1


def test_config_device_holds_the_stream():
    cfg = tst.StreamingConfig(buffer_size=64, max_level=2, device="cpu")
    s = tst.StreamingMODWT(DB4_T, cfg)
    out = s.update(torch.ones(16, dtype=torch.float64))
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert s.get_current_buffer().dtype == torch.float32
    assert tst.StreamingConfig(buffer_size=8).device == "cuda"
