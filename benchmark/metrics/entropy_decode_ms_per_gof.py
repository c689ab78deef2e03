"""Host entropy decode (``video/rbv.py``: the side sections and the blob's
inflate or rANS decode, ``native/rans.cpp``), from the program's
``entropy_decode`` spans: their self time (less their uploads), in ms per
GOF written in the window."""

from benchmark.program_spans import self_ms_per_gof


def read(r):
    return self_ms_per_gof(r, "entropy_decode")
