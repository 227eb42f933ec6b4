"""Ring hops a sharded call makes, on rank 0: the program's
``jwave.sharded.hop`` spans in the traced window over the traced calls
(one where the forward fetches its whole halo at once, a hop a level
where it fetches each level's).  None where the program opens no hop
span."""
from wavebench import spans

HOP = "jwave.sharded.hop"


def read(r):
    hops = spans.named(r.trace, HOP)
    if not hops or not r.trace.calls:
        return None
    return len(hops) / r.trace.calls
