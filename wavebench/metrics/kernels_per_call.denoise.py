"""``kernels_per_call`` of the denoise cell, split off so that it moves
``p95_ms.denoise``; read by ``kernels_per_call.py``."""
from wavebench.metrics.kernels_per_call import read  # noqa: F401
