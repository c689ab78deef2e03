"""Copies between host and card that block the host until the card's
stream drains: the program's ``upload`` and ``download`` spans, per GOF
written in the window."""

from benchmark.program_spans import COPIES, spans


def read(r):
    got = spans(r)
    if not got or not r.gofs:
        return None
    return sum(s.name in COPIES for s in got) / len(r.gofs)
