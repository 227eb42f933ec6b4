"""Input validation and small integer helpers (the port's own copy of
``jwave_pro_tpu/utils/validation.py``).

Replaces the reference's ``MathToolKit.isBinary/getExponent``
(``jwave/tools/MathToolKit.java:185-230``) and ``MathUtils.nextPowerOfTwo/
isPowerOfTwo`` (``jwave/utils/MathUtils.java:46-66``).  All of these take
Python ints (shapes), never tensors.
"""
from __future__ import annotations

from ..exceptions import NotValid

__all__ = [
    "is_power_of_two", "next_power_of_two", "exponent", "check_power_of_two",
    "max_level", "ancient_egyptian_decomposition",
]


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """The smallest power of two ≥ ``n`` (1 for n ≤ 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def exponent(n: int) -> int:
    """floor(log2(n)) for n ≥ 1."""
    if n < 1:
        raise ValueError(f"exponent undefined for {n}")
    return n.bit_length() - 1


def check_power_of_two(n: int) -> None:
    if not is_power_of_two(n):
        raise NotValid(
            f"signal length {n} is not a power of 2 — use the MODWT, the "
            "Ancient Egyptian Decomposition wrapper, or the Shifting Wavelet "
            "Transform for arbitrary lengths "
            "[parity: WaveletTransform.java:77-112 throws here]"
        )


def max_level(n: int, transform_wavelength: int = 2) -> int:
    """Maximum pyramid depth for signal length ``n``.

    The reference iterates while the current width ≥ the wavelet's
    ``_transformWavelength`` (``FastWaveletTransform.java:90-97``).
    """
    if not is_power_of_two(n):
        raise NotValid(f"length {n} not a power of two")
    lvl = 0
    h = n
    while h >= max(transform_wavelength, 2) and h >= 2:
        lvl += 1
        h //= 2
    return lvl


def ancient_egyptian_decomposition(n: int) -> list[int]:
    """Split ``n`` into decreasing powers of two (42 → [32, 8, 2]).

    Mirrors ``MathToolKit.decompose`` (``jwave/tools/MathToolKit.java:57-101``).
    """
    out = []
    while n > 0:
        p = 1 << (n.bit_length() - 1)
        out.append(p)
        n -= p
    return out
