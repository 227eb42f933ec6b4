"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), with their plain
PyTorch versions.  Each kernel's launch is a ``torch.library`` operator in
the ``jwave`` namespace (``torch.ops.jwave.modwt_fwd`` and the others),
registered when this package is imported — as importing
``jwave_pro_tpu_torch`` does — so an exported graph that records them
loads and runs.  The shared library is built by ``_build`` on first
launch."""
from . import (  # noqa: F401  (registers the operators)
    cwt_cuda, denoise_cuda, median_cuda, modwpt_cuda, modwt2_cuda,
    modwt3_cuda, modwt_cuda, variance_cuda,
)
