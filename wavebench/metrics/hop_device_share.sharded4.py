"""The ring hops' share of the device time of a sharded call, on rank 0:
the device time of the operations enqueued inside the program's
``jwave.sharded.hop`` spans (the copy of the halo it sends and the NCCL
send/receive kernel) over that of every operation the traced calls
enqueued.  Operations are matched to the host calls that enqueued them by
position and kind (``spans.matched``); NCCL runs its kernel on a stream of
its own, so where that match fails the hop's operations are the NCCL
kernels, the only ones the cell's collectives launch.  None where the
program opens no hop span."""
from wavebench import spans, tracing

HOP = "jwave.sharded.hop"


def read(r):
    windows = tracing.merge(spans.named(r.trace, HOP))
    if not windows:
        return None
    pairs = spans.matched(r.trace)
    if pairs:
        ops = [(spans.inside(at, windows), op) for at, op in pairs]
    else:
        ops = [(op[0].startswith("nccl"), op) for op in r.trace.device]
    total = sum(e - s for _, (_, _, s, e) in ops)
    inside = sum(e - s for hop, (_, _, s, e) in ops if hop)
    return 100.0 * inside / total if total else None
