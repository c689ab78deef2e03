"""The host's enqueue of the device work (``ops/rbv_tools.py``,
``ops/transcode.py``: the plain chains or the Hopper kernel), from the
program's ``submit`` spans: their self time (less their uploads), in ms
per GOF written in the window."""

from benchmark.program_spans import self_ms_per_gof


def read(r):
    return self_ms_per_gof(r, "submit")
