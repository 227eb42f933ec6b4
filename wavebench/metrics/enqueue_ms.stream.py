"""``enqueue_ms`` of the stream cell, split off so that it moves
``p95_ms.stream``; read by ``enqueue_ms.py``."""
from wavebench.metrics.enqueue_ms import read  # noqa: F401
