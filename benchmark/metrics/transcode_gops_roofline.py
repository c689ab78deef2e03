"""The fused GOP-transcode kernel's share of its roofline: the least time
an H100 needs for the window's transcodes (``benchmark/roofline.py``, work
counted from the coefficient shapes and GOPs of the configuration) over
the kernel's device time in the trace.  Nothing to read where the kernel
did not run once per plane of every call into the transcoder (a span
``transcode``: one GOF, or one round of batched streams)."""

from benchmark.roofline import bound_ms


def _planes(cfg):
    """(frames, nby, nbx) of every lossy plane of one GOF."""
    f = cfg["atlas"]["frames"]
    w, h = cfg["atlas"]["width"], cfg["atlas"]["height"]
    out = []
    for video in (cfg["geometry"], cfg["attribute"]):
        out.append((f, h // 16, w // 16))
        if video["format"] == "YUV420":
            out += [(f, h // 32, w // 32)] * 2
    return out


def read(r):
    kernels = [e for e in r.events if "transcode_gops" in e.name
               and r.t0 <= e.start < r.t1]
    cfg = r.cell.config
    planes = _planes(cfg)
    calls = sum(1 for s in r.spans if s.name == "transcode")
    if not kernels or len(kernels) != len(planes) * calls:
        return None
    gop_out = cfg["transcode"]["gop_out"]
    least = len(r.gofs) * sum(bound_ms(p + (16, 16), gop_out)[0]
                              for p in planes)
    return 100.0 * least / (1e3 * sum(e.end - e.start for e in kernels))
