"""``device_idle`` of the denoise cell, split off so that it moves
``samples_per_s.denoise``; read by ``device_idle.py``."""
from wavebench.metrics.device_idle import read  # noqa: F401
