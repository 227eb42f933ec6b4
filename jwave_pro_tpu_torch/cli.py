"""Console demo (``jwave/JWave.java:40-124`` analog), on the card.

Usage::

    python -m jwave_pro_tpu_torch.cli "Fast Wavelet Transform" "Daubechies 4"

Builds the named transform, runs a forward/reverse round trip on a constant
length-16 float64 array and prints the three arrays — the reference's toy
demo, as ``jwave_pro_tpu.cli`` prints it.  Exit code 0 for a round trip
within 1e-6, 1 for an unknown transform or wavelet, 2 otherwise.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def main(argv=None, device="cuda") -> int:
    """The demo; ``device`` is where the round trip runs (the card unless
    a caller asks for another)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    t_name = argv[0] if argv else "Fast Wavelet Transform"
    w_name = argv[1] if len(argv) > 1 else "Haar"

    from .transforms import build_transform

    try:
        t = build_transform(t_name, w_name)
    except ValueError as e:
        print(f"error: {e}")
        return 1

    x = np.ones(16)
    print(f"transform: {t_name}  wavelet: {w_name}")
    print("time domain:     ", np.array2string(x, precision=4))
    y = t.forward(torch.as_tensor(x, device=device))
    print("hilbert domain:  ", np.array2string(_host(y), precision=4))
    xr = _host(t.reverse(y))
    print("reconstructed:   ", np.array2string(xr, precision=4))
    err = float(np.max(np.abs(xr - x)))
    print(f"max |x - rec| = {err:.3e}")
    return 0 if err < 1e-6 else 2


if __name__ == "__main__":
    raise SystemExit(main())
