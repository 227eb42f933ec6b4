"""``launch_host_us`` of the stream cell, split off so that it moves
``p95_ms.stream``; read by ``launch_host_us.py``."""
from wavebench.metrics.launch_host_us import read  # noqa: F401
