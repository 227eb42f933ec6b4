"""``launch_host_us`` of the denoise cell, split off so that it moves
``p95_ms.denoise``; read by ``launch_host_us.py``."""
from wavebench.metrics.launch_host_us import read  # noqa: F401
