"""The 95th percentile (nearest rank) over the window's GOFs of the time
from a GOF's V3C read starting to its output bytes written, in ms."""

import math


def read(r):
    if not r.gofs:
        return None
    lat = sorted(g.end - g.start for g in r.gofs)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
