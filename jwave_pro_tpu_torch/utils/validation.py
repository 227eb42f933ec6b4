"""Integer helpers (the port's own copy of what it needs from
``jwave_pro_tpu/utils/validation.py``)."""
from __future__ import annotations

__all__ = ["next_power_of_two"]


def next_power_of_two(n: int) -> int:
    """The smallest power of two ≥ ``n`` (1 for n ≤ 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
