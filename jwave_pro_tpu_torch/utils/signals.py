"""Test-signal generators (``jwave/tools/MathToolKit.java:239-307`` analogs,
plus the chirp/ECG-like signals used by the reference's examples/tests).

The port's own copy of ``jwave_pro_tpu/utils/signals.py``: numpy only, and
numpy arrays out, as there, so both packages draw the same signals."""
from __future__ import annotations

import numpy as np

__all__ = ["sine_oscillation", "cosine_oscillation", "chirp", "ecg_like",
           "noisy_sine"]


def sine_oscillation(n: int, oscillations: int = 1, amplitude: float = 1.0):
    """MathToolKit.createSineOscillation (:239-271)."""
    t = np.arange(n) / n
    return amplitude * np.sin(2.0 * np.pi * oscillations * t)


def cosine_oscillation(n: int, oscillations: int = 1, amplitude: float = 1.0):
    """MathToolKit.createCosineOscillation (:273-307)."""
    t = np.arange(n) / n
    return amplitude * np.cos(2.0 * np.pi * oscillations * t)


def chirp(n: int, f0: float = 1.0, f1: float = 50.0, fs: float = 1000.0):
    """Linear chirp (CWTExample.java's test signal shape)."""
    t = np.arange(n) / fs
    t_total = n / fs
    k = (f1 - f0) / t_total
    return np.sin(2.0 * np.pi * (f0 * t + 0.5 * k * t * t))


def ecg_like(n: int, fs: float = 360.0, hr_bpm: float = 72.0, seed: int = 0):
    """Synthetic ECG-ish signal (QRS spikes + P/T bumps + baseline wander)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    beat = 60.0 / hr_bpm
    sig = np.zeros(n)
    for center in np.arange(0.3, t[-1], beat):
        sig += 1.2 * np.exp(-((t - center) / 0.012) ** 2)          # R
        sig -= 0.3 * np.exp(-((t - center - 0.025) / 0.02) ** 2)   # S
        sig += 0.25 * np.exp(-((t - center + 0.18) / 0.05) ** 2)   # P
        sig += 0.35 * np.exp(-((t - center - 0.3) / 0.07) ** 2)    # T
    sig += 0.1 * np.sin(2 * np.pi * 0.33 * t)                      # baseline
    sig += 0.02 * rng.standard_normal(n)
    return sig


def noisy_sine(n: int, oscillations: int = 5, snr: float = 3.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    clean = sine_oscillation(n, oscillations)
    noise = rng.standard_normal(n) * (np.std(clean) / snr)
    return clean + noise, clean
