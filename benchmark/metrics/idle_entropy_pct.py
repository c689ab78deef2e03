"""Entropy-bound idle: the share of the window in which the card is idle,
no thread is inside the program's ``submit`` span and some thread is
inside ``entropy_decode`` or ``entropy_encode`` (their copies included),
in %."""

from benchmark.program_spans import ENTROPY, idle_share_pct


def read(r):
    return idle_share_pct(r, ENTROPY, outside=("submit",))
