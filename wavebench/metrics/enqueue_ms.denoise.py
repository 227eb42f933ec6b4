"""``enqueue_ms`` of the denoise cell, split off so that it moves
``p95_ms.denoise``; read by ``enqueue_ms.py``."""
from wavebench.metrics.enqueue_ms import read  # noqa: F401
