"""``device_idle`` of the CWT cell, split off so that it moves
``samples_per_s.cwt``; read by ``device_idle.py``."""
from wavebench.metrics.device_idle import read  # noqa: F401
