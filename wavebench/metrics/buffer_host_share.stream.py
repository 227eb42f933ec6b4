"""The stream buffer's share of an update's host time: the host time
inside the program's ``jwave.stream.chunk`` (the host chunk to the
card), ``.append`` (the ring's copy), ``.window`` (the roll) and
``.splice`` (the coefficients' ``cat``) spans, over the host time inside
its ``jwave.stream.update`` spans, summed over the traced updates.  None
where the program opens no update span."""
from wavebench import spans

STAGES = ("jwave.stream.chunk", "jwave.stream.append",
          "jwave.stream.window", "jwave.stream.splice")


def read(r):
    updates = spans.named(r.trace, "jwave.stream.update")
    whole = spans.covered(updates)
    if not whole:
        return None
    stages = [iv for name in STAGES for iv in spans.named(r.trace, name)]
    return 100.0 * spans.overlap(stages, updates) / whole
