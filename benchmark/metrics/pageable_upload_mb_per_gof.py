"""Bytes uploaded from pageable host memory: the program's ``upload`` spans
not marked pinned, in MB (10^6 bytes) per GOF written in the window."""

from benchmark.program_spans import spans


def read(r):
    got = spans(r)
    if not got or not r.gofs:
        return None
    return sum(s.counts.get("bytes", 0) for s in got
               if s.name == "upload" and not s.counts.get("pinned")
               ) / 1e6 / len(r.gofs)
