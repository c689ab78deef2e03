"""Stand-in HEVC codec behind the HM command line, for the foreign route.

Port of the reference's test stand-in (``tests/mock_hevc.py``), importing
from the port: a tiny "video codec" whose bitstreams are genuine Annex-B —
a valid HEVC SPS NAL (parseable by ``video/hevc_probe.parse_sps``) followed
by one payload NAL carrying zlib-compressed quantised samples
(emulation-prevention-escaped).  Higher QP -> coarser quantisation ->
smaller stream, so rate reduction is measurable end to end.

Used two ways:
  * imported to synthesize foreign V3C input streams;
  * run as ``python -m rabbit_transcoding_tpu_torch.mock_hevc
    encode|decode ...`` under the HM TAppEncoder/TAppDecoder argument
    conventions, standing in for the external binaries the route shells out
    to (video/external.py HM_{ENCODER,DECODER}_TEMPLATE).
    ``testdata.write_codec_wrappers`` writes the two wrapper scripts.
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

from .bitstream.bitio import BitWriter
from .bitstream.video_bitstream import split_annexb
from .core.image import Video
from .utils.enums import ColorFormat

_FMT_TO_CHROMA = {
    ColorFormat.YUV400: 0,
    ColorFormat.YUV420: 1,
    ColorFormat.YUV444: 3,
}
_CHROMA_TO_FMT = {v: k for k, v in _FMT_TO_CHROMA.items()}


def _escape(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (H.265 §7.4.2)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _unescape(data: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def make_sps_nal(width: int, height: int, bitdepth: int, chroma_idc: int) -> bytes:
    """A minimal HEVC SPS NAL (header + escaped RBSP) with exactly the
    fields hevc_probe.parse_sps reads (H.265 §7.3.2.2 up to bit depths)."""
    bw = BitWriter()
    bw.u(4, 0)      # sps_video_parameter_set_id
    bw.u(3, 0)      # sps_max_sub_layers_minus1
    bw.u(1, 1)      # sps_temporal_id_nesting_flag
    # profile_tier_level, no sub-layers: 96 bits of profile/constraint/level
    bw.u(8, 0x01)   # profile_space/tier/profile_idc (Main)
    bw.u(32, 0x60000000)  # profile_compatibility_flags
    bw.u(32, 0)     # constraint flags (48 bits total)
    bw.u(16, 0)
    bw.u(8, 120)    # general_level_idc
    bw.ue(0)        # sps_seq_parameter_set_id
    bw.ue(chroma_idc)
    if chroma_idc == 3:
        bw.u(1, 0)  # separate_colour_plane_flag
    bw.ue(width)
    bw.ue(height)
    bw.u(1, 0)      # conformance_window_flag
    bw.ue(bitdepth - 8)   # bit_depth_luma_minus8
    bw.ue(bitdepth - 8)   # bit_depth_chroma_minus8
    bw.u(1, 1)      # rbsp stop bit
    bw.byte_align(0)
    # NAL header: type 33 (SPS), layer 0, tid 1
    return bytes([33 << 1, 1]) + _escape(bw.data())


def _qstep(qp: int) -> int:
    return max(1, int(round(2.0 ** ((qp - 4) / 6.0))))


def encode(video: Video, qp: int) -> tuple[bytes, Video]:
    """Video -> (Annex-B payload, closed-loop reconstruction)."""
    step = _qstep(qp)
    maxval = (1 << video.bitdepth) - 1
    body = bytearray(struct.pack("<HB", video.frame_count, qp))
    recon_planes = []
    for pl in video.planes:
        q = np.round(pl.astype(np.int32) / step).astype(np.uint16)
        z = zlib.compress(q.tobytes(), 6)
        body += struct.pack("<I", len(z)) + z
        recon_planes.append(
            np.clip(q.astype(np.int32) * step, 0, maxval).astype(pl.dtype)
        )
    sps = make_sps_nal(
        video.width, video.height, video.bitdepth,
        _FMT_TO_CHROMA[video.format],
    )
    payload_nal = bytes([1 << 1, 1]) + _escape(bytes(body))
    stream = b"\x00\x00\x00\x01" + sps + b"\x00\x00\x00\x01" + payload_nal
    recon = Video(video.width, video.height, video.bitdepth, video.format,
                  recon_planes)
    return stream, recon


def decode(data: bytes) -> Video:
    """Annex-B payload (from encode) -> Video."""
    from .video.hevc_probe import probe_hevc

    info = probe_hevc(data)
    if info is None:
        raise ValueError("mock decode: no SPS found")
    w, h, bd = info["width"], info["height"], info["bitdepth"]
    fmt = _CHROMA_TO_FMT[info["chroma_format_idc"]]
    body = None
    for nal in split_annexb(data):
        if len(nal) >= 2 and ((nal[0] >> 1) & 0x3F) == 1:
            body = _unescape(nal[2:])
            break
    if body is None:
        raise ValueError("mock decode: no payload NAL")
    frames, qp = struct.unpack_from("<HB", body, 0)
    step = _qstep(qp)
    maxval = (1 << bd) - 1
    dims = {
        ColorFormat.YUV400: [(h, w)],
        ColorFormat.YUV420: [(h, w), (h // 2, w // 2), (h // 2, w // 2)],
        ColorFormat.YUV444: [(h, w)] * 3,
    }[fmt]
    dtype = np.uint8 if bd <= 8 else np.uint16
    pos = 3
    planes = []
    for ph, pw in dims:
        (zlen,) = struct.unpack_from("<I", body, pos)
        pos += 4
        q = np.frombuffer(
            zlib.decompress(body[pos : pos + zlen]), np.uint16
        ).reshape(frames, ph, pw)
        pos += zlen
        planes.append(
            np.clip(q.astype(np.int32) * step, 0, maxval).astype(dtype)
        )
    return Video(w, h, bd, fmt, planes)


# ---------------------------------------------------------------------------
# CLI (HM TAppEncoder / TAppDecoder argument conventions)
# ---------------------------------------------------------------------------
def _cli_encode(argv: list[str]) -> int:
    opts: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
            i += 1
        elif a.startswith("-") and i + 1 < len(argv):
            opts[a] = argv[i + 1]
            i += 2
        else:
            i += 1
    w, h = int(opts["-wdt"]), int(opts["-hgt"])
    frames, qp = int(opts["-f"]), int(opts["-q"])
    bd = int(opts.get("InputBitDepth", "8"))
    fmt = {"400": ColorFormat.YUV400, "420": ColorFormat.YUV420,
           "444": ColorFormat.YUV444}[opts.get("InputChromaFormat", "420")]
    video = Video().read(opts["-i"], w, h, frames, bd, fmt)
    payload, recon = encode(video, qp)
    with open(opts["-b"], "wb") as f:
        f.write(payload)
    if "-o" in opts:
        recon.write(opts["-o"])
    return 0


def _cli_decode(argv: list[str]) -> int:
    opts: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and i + 1 < len(argv):
            opts[a] = argv[i + 1]
            i += 2
        else:
            i += 1
    with open(opts["-b"], "rb") as f:
        video = decode(f.read())
    video.write(opts["-o"])
    return 0


if __name__ == "__main__":
    mode = sys.argv[1]
    rest = sys.argv[2:]
    sys.exit(_cli_encode(rest) if mode == "encode" else _cli_decode(rest))
