"""The host's part of a closed-loop call: the median time from the call
until it returns, before the wait for the card, over every call of the
measured (untraced) window, from the harness's own span around the call."""
import statistics


def read(r):
    if not r.window.enqueue_s:
        return None
    return 1e3 * statistics.median(r.window.enqueue_s)
