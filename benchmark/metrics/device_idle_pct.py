"""The share of the traced window in which nothing ran on the card: 100
minus the union of its activity (kernels, copies, sets) over the window."""

from benchmark.devtrace import busy_intervals


def read(r):
    busy = busy_intervals(r.events, r.t0, r.t1)
    if not busy:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in busy) / (r.t1 - r.t0))
