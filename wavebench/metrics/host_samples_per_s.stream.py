"""The stream cell's rate, per layer: every input sample that the measured
(untraced) window's updates took in, over the window's wall time, taken
as ``samples_per_s`` is in the other cells.  In this cell the host's
speed sets it, and it swings too widely from process to process to hold
an end-to-end bound, so it stands beside ``p95_ms.stream``, which it
moves with."""


def read(r):
    if not r.window.calls or r.window.seconds <= 0:
        return None
    return r.window.samples / r.window.seconds
