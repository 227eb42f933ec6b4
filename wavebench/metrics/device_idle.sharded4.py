"""``device_idle`` of the sharded cell, rank 0's card, split off so that it
moves the cell's rate, reported as ``samples_per_s.denoise`` (the
manifest's 15% part of ``samples_per_s``); read by ``device_idle.py``."""
from wavebench.metrics.device_idle import read  # noqa: F401
