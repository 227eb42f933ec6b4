"""The CWT's host-to-device copies of its scales and time axis: the host
time a call spends inside the program's ``jwave.cwt.axes`` spans (each a
pageable copy and the wait for the card it forces), in milliseconds, the
median over the traced calls.  None where the program opens no such
span."""
import statistics

from wavebench import spans


def read(r):
    axes = spans.named(r.trace, "jwave.cwt.axes")
    if not axes:
        return None
    per_call = spans.per_call(r.trace, axes)
    return statistics.median(per_call) / 1e3 if per_call else None
