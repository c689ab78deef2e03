"""Host time in the V3C layer (``bitstream/``): the benchmark's spans around
``V3CReader.read`` + ``decode`` and ``V3CWriter.encode`` + ``write``, in ms
per GOF written in the window."""


def read(r):
    if not r.gofs:
        return None
    io = sum(s.end - s.start for s in r.spans
             if s.name in ("v3c_read", "v3c_write"))
    return 1e3 * io / len(r.gofs)
