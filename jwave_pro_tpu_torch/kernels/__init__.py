"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), with their plain
PyTorch versions.  The kernel modules are imported lazily by the ops'
dispatchers; the shared library is built by ``_build`` on first launch."""
