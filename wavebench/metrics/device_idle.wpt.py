"""``device_idle`` of the packet denoise cell, split off so that it moves
that cell's rate; read by ``device_idle.py``."""
from wavebench.metrics.device_idle import read  # noqa: F401
