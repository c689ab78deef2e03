"""What a transcoded GOF has to be, and how far an output lies from it.

``expected`` works the transcode out from the input V3C bytes alone: the
parameter-set and atlas units pass through, the occupancy video is decoded
(lossless), and each lossy RBV video is decoded by the plain float32 chains
and coded again at the output QP and GOP, reusing the motion vectors and
re-deciding the intra modes.  ``compare`` reads an output (V3C bytes, or
planes computed by a stand-in for the program) and gives the numbers that
decide ``correct``; ``decoded`` samples come from the same plain chains.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import chains, stream

VIDEO_UNITS = (stream.OVD, stream.GVD, stream.AVD)


@dataclasses.dataclass
class Video:
    header: stream.Header
    planes: list[stream.Plane]


@dataclasses.dataclass
class Gof:
    """One GOF: its unit types in order, the bytes of every unit that is
    not video, and its videos by unit type."""

    types: list[int]
    other_units: list[bytes]
    videos: dict[int, Video]


def parse(data: bytes) -> Gof:
    units = stream.read_units(data)
    videos = {}
    for t, unit in units:
        if t in VIDEO_UNITS:
            if t in videos:
                raise ValueError(f"two video units of type {t} in one GOF")
            videos[t] = Video(*stream.read_payload(unit[4:]))
    return Gof([t for t, _ in units],
               [u for t, u in units if t not in VIDEO_UNITS], videos)


def _maxval(hd: stream.Header) -> float:
    return float((1 << hd.bitdepth) - 1)


def _t(x, device):
    return None if x is None else torch.from_numpy(np.array(x)).to(device)


def samples(hd: stream.Header, pl: stream.Plane, device) -> torch.Tensor:
    """The decoded samples (F, H, W) of one lossy plane, float32."""
    rec = chains.decode_chain(_t(pl.q, device), chains.qstep_of(hd.qp),
                              _maxval(hd), hd.gop, _t(pl.mode, device),
                              _t(pl.mv, device))
    return chains.deblockify(rec)[:, :pl.height, :pl.width]


def _transcode_plane(hd: stream.Header, pl: stream.Plane, qp_out: int,
                     gop_out: int, device) -> stream.Plane:
    mv = _t(pl.mv, device)
    pixels = chains.decode_chain(_t(pl.q, device), chains.qstep_of(hd.qp),
                                 _maxval(hd), hd.gop, _t(pl.mode, device),
                                 mv)
    q, mode = chains.encode_chain(pixels, chains.qstep_of(qp_out),
                                  _maxval(hd), gop_out,
                                  intra=bool(hd.flags & stream.INTRA), mv=mv)
    n_i = -(-hd.frames // gop_out)
    return stream.Plane(pl.height, pl.width, q=q.cpu().numpy(), mv=pl.mv,
                        mode=None if mode is None else
                        mode[:n_i].cpu().numpy())


def expected(data: bytes, qps: dict[int, int], gop_out: int,
             device) -> Gof:
    """The GOF a transcode of the input ``data`` to the output QPs
    ``{unit type: QP}`` of its lossy videos has to give.  Motion-compensated
    videos keep their GOP."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gof = parse(data)
    for t, video in gof.videos.items():
        hd = video.header
        if hd.flags & stream.LOSSLESS:
            continue
        if hd.flags & stream.DEBLOCK:
            raise ValueError("the reference codes no deblocking")
        g = hd.gop if hd.flags & stream.MC else gop_out
        out_hd = dataclasses.replace(hd, gop=g, qp=qps[t])
        gof.videos[t] = Video(out_hd, [
            _transcode_plane(hd, pl, qps[t], g, device)
            for pl in video.planes])
    return gof


def compare(want: Gof, got: Gof, device) -> dict[str, float]:
    """The numbers compared: counts that must be 0 where the configuration
    guarantees exactness (units, occupancy, headers, motion vectors), and the
    share and size of the departures in coefficients, intra modes and
    decoded samples."""
    n = dict(units=0, occupancy=0, headers=0, mvs=0, coeff_share=0.0,
             coeff_max=0, mode_share=0.0, sample_share=0.0, sample_max=0)
    n["units"] = int(want.types != got.types) + sum(
        a != b for a, b in zip(want.other_units, got.other_units)) + abs(
        len(want.other_units) - len(got.other_units))
    coeff_diff = coeff_nz = mode_diff = mode_all = 0
    samp_diff = samp_all = 0
    for t, w in want.videos.items():
        g = got.videos.get(t)
        if g is None or len(g.planes) != len(w.planes):
            n["headers"] += 1
            continue
        n["headers"] += sum(a != b for a, b in zip(w.header.fields(),
                                                   g.header.fields()))
        for wp, gp in zip(w.planes, g.planes):
            if wp.samples is not None:
                if gp.samples is None or gp.samples.shape != wp.samples.shape:
                    n["occupancy"] += wp.samples.size
                else:
                    n["occupancy"] += int(np.count_nonzero(
                        wp.samples != gp.samples))
                continue
            if gp.q is None or gp.q.shape != wp.q.shape:
                n["headers"] += 1
                continue
            if (wp.mv is None) != (gp.mv is None) or (
                    wp.mv is not None and wp.mv.shape != gp.mv.shape):
                n["mvs"] += 1
            elif wp.mv is not None:
                n["mvs"] += int(np.count_nonzero(wp.mv != gp.mv))
            d = np.abs(wp.q.astype(np.int32) - gp.q.astype(np.int32))
            coeff_diff += int(np.count_nonzero(d))
            coeff_nz += int(np.count_nonzero((wp.q != 0) | (gp.q != 0)))
            n["coeff_max"] = max(n["coeff_max"], int(d.max(initial=0)))
            if wp.mode is not None:
                mode_all += wp.mode.size
                mode_diff += (wp.mode.size if gp.mode is None
                              or gp.mode.shape != wp.mode.shape
                              else int(np.count_nonzero(wp.mode != gp.mode)))
            sw = samples(w.header, wp, device)
            sg = samples(g.header, gp, device)
            sd = torch.abs(sw - sg)
            samp_diff += int(torch.count_nonzero(sd))
            samp_all += sd.numel()
            n["sample_max"] = max(n["sample_max"], int(sd.max()))
    n["coeff_share"] = coeff_diff / max(1, coeff_nz)
    n["mode_share"] = mode_diff / max(1, mode_all)
    n["sample_share"] = samp_diff / max(1, samp_all)
    return n


def worst(numbers: list[dict[str, float]]) -> dict[str, float]:
    """The largest reading of each number over several outputs."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}
