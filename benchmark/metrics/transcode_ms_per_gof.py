"""Time in the transcoder (``transcoder/``, ``parallel/multistream.py``):
the benchmark's spans around ``Transcoder.transcode`` or
``MultiStreamTranscoder.transcode_many`` (a round's span shared by its
streams), in ms per GOF written in the window."""


def read(r):
    if not r.gofs:
        return None
    busy = sum(s.end - s.start for s in r.spans if s.name == "transcode")
    return 1e3 * busy / len(r.gofs)
