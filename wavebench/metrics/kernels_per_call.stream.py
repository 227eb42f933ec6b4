"""``kernels_per_call`` of the stream cell, split off so that it moves
``p95_ms.stream``; read by ``kernels_per_call.py``."""
from wavebench.metrics.kernels_per_call import read  # noqa: F401
