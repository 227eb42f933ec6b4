from .device import as_input
from .profiling import time_chain
from .validation import next_power_of_two

__all__ = ["as_input", "time_chain", "next_power_of_two"]
