from .profiling import time_chain

__all__ = ["time_chain"]
