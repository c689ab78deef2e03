"""Host entropy encode (``video/rbv.py``: the motion-vector and intra side
sections and the coefficient blob's backend race), from the program's
``entropy_encode`` spans: their self time, less their downloads and with
their ``race`` spans kept, in ms per GOF written in the window."""

from benchmark.program_spans import self_ms_per_gof


def read(r):
    return self_ms_per_gof(r, "entropy_encode", keep=("race",))
