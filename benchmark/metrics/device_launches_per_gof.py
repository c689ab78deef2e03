"""Kernels the card ran in the traced window (``torch.profiler``; copies
and sets not counted), per GOF written in the window."""


def read(r):
    kernels = [e for e in r.events if not e.copy and r.t0 <= e.start < r.t1]
    if not kernels or not r.gofs:
        return None
    return len(kernels) / len(r.gofs)
