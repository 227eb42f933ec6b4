from .device import as_input, as_signal, tensor_cache, tracing
from .profiling import time_chain
from .validation import (
    ancient_egyptian_decomposition, check_power_of_two, exponent,
    is_power_of_two, max_level, next_power_of_two,
)

__all__ = [
    "as_input", "as_signal", "tensor_cache", "tracing", "time_chain", "ancient_egyptian_decomposition",
    "check_power_of_two", "exponent", "is_power_of_two", "max_level",
    "next_power_of_two",
]
