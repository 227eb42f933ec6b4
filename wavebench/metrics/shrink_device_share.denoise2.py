"""The 2D denoise's shrink in plain torch: the device time of the
operations enqueued inside the program's ``jwave.denoise.shrink`` spans
(the elementwise passes of the soft shrink and the ``cat`` that puts LL
back) over that of every operation the traced calls enqueued, kernels,
copies and fills alike.  Operations are matched to the host calls that
enqueued them by position on the one stream (``spans.matched``); None
where they do not match, or where the program opens no such span (a
shrink inside a kernel, or a program without the span)."""
from wavebench import spans, tracing

SHRINK = "jwave.denoise.shrink"


def read(r):
    windows = tracing.merge(spans.named(r.trace, SHRINK))
    if not windows:
        return None
    pairs = spans.matched(r.trace)
    if not pairs:
        return None
    total = inside = 0.0
    for at, (_, _, s, e) in pairs:
        total += e - s
        if spans.inside(at, windows):
            inside += e - s
    return 100.0 * inside / total if total else None
