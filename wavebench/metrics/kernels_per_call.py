"""Device kernels a closed-loop call launches: every kernel of the traced
window, the port's own and the library's, over the traced calls (copies
and fills are not kernels)."""


def read(r):
    kernels = r.trace.kernels()
    if r.cell.workload["loop"] != "closed" or not r.trace.calls \
            or not kernels:
        return None
    return len(kernels) / r.trace.calls
