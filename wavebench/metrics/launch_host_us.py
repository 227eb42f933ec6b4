"""A kernel launch's host time: the median duration, in microseconds, of
the program's ``jwave.launch.<op>`` spans in the traced window (the
launch as ``kernels/modwt_cuda.py:kernel_op`` runs it: the operands'
checks, the output's allocation, the ctypes call with its
``cudaLaunchKernel``).  None where the program opens no such span."""
import statistics

from wavebench import spans


def read(r):
    launches = spans.prefixed(r.trace, "jwave.launch.")
    if not launches:
        return None
    return statistics.median(e - s for s, e in launches)
