"""``device_idle`` of the stream cell, split off so that it moves
``p95_ms.stream``; read by ``device_idle.py``."""
from wavebench.metrics.device_idle import read  # noqa: F401
