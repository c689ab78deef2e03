"""Launch-bound idle: the share of the window in which the card is idle
(the complement of ``devtrace.busy_intervals``) while some thread is inside
the program's ``submit`` span, in %."""

from benchmark.program_spans import idle_share_pct


def read(r):
    return idle_share_pct(r, ("submit",))
