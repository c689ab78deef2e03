"""RBV, the repo's block-DCT video codec.

Port of ``rabbit_transcoding_tpu/video/rbv.py``: every payload flag
(lossless, motion compensation, in-loop deblocking, intra prediction), the
encoder's coefficient threshold and MC search weights, ``encode``,
``decode``, ``requantize`` and every branch of ``transcode_payload``.  The
payload format is the reference's (container v2): both packages read each
other's streams (coefficient blob modes 0-3; the encoders write mode 3), and
on the CPU they write the same bytes.

* Host: entropy coding of the zigzag frequency slab through the port's
  copy of the ``native`` rANS library (the ``R``/``B``/``Z`` size race) and zlib, and
  the motion-vector ('M') and intra mode-map ('I') side sections.
* Device (``device`` argument, the card unless the caller asks for the
  CPU; no card raises): the slab layout ops and the chains of
  ``ops.transcode`` as torch ops.  The fused decode -> re-encode of a stream
  without MC, intra, deblocking or threshold is ``ops.transcode.
  transcode_coeffs``, on a CUDA tensor the hand-written Hopper kernel; every
  other branch runs the plain chains on the same device.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import os
import struct
import time
import zlib

import numpy as np
import torch

from .. import native
from ..core.image import Video
from ..device import resolve, to_device, to_host
from ..ops import rbv_tools as tools
from ..ops.dct import blockify, deblockify, pad_to_block
from ..ops.transcode import (
    decode_chain,
    encode_chain,
    mc_intra_applies,
    transcode_coeffs,
    transcode_coeffs_ref,
    transcode_mc_intra,
)
from ..utils import timing
from ..utils.enums import ColorFormat

_MAGIC = b"RBV2"
_HEADER = struct.Struct("<4sBBHHBBHBBBB")

# payload flag bits
_LOSSLESS, _MC, _DEBLOCK, _INTRA = 1, 2, 4, 8


def qstep_of(qp: int) -> float:
    """HEVC-style quantiser step: doubles every 6 QP."""
    return float(2.0 ** ((qp - 4.0) / 6.0))


def _f32(x: float) -> float:
    """A Python float holding the float32 value the device computes with."""
    return float(np.float32(x))


# ===========================================================================
# Frequency-slab layout (device) and host entropy coding
# ===========================================================================
@functools.lru_cache(maxsize=None)
def _zz_inv(n: int) -> np.ndarray:
    order = tools.zigzag(n)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return inv


def _to_freq_major(q: torch.Tensor) -> torch.Tensor:
    """(F, nby, nbx, B, B) -> (F, B*B zigzag-ordered, nby, nbx)."""
    f, nby, nbx, b, _ = q.shape
    zz = to_device(tools.zigzag(b), q.device)
    return q.reshape(f, nby, nbx, b * b)[..., zz].permute(0, 3, 1, 2)


def _freq_nnz(qf: torch.Tensor) -> torch.Tensor:
    """Nonzero count per zigzag frequency of a freq-major tensor."""
    return torch.count_nonzero(qf, dim=(0, 2, 3))


def _from_freq_slab(slab: torch.Tensor, b: int, kmax: int) -> torch.Tensor:
    """(F, kmax, nby, nbx) -> dense (F, nby, nbx, B, B)."""
    f, _, nby, nbx = slab.shape
    full = torch.zeros((f, b * b, nby, nbx), dtype=slab.dtype,
                       device=slab.device)
    full[:, :kmax] = slab
    inv = to_device(_zz_inv(b), slab.device)
    return full.permute(0, 2, 3, 1)[..., inv].reshape(f, nby, nbx, b, b)


_KMAX_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _bucket_kmax(k: int, b2: int) -> int:
    for v in _KMAX_BUCKETS:
        if v >= k and v <= b2:
            return v
    return b2


# frequency-band context boundaries (zigzag octaves): each band gets its own
# rANS tables in the 'B' backend
_BAND_STARTS = (0, 1, 4, 16, 64)


def _band_plan(kmax: int) -> list[int]:
    """Band start frequencies for a slab of kmax rows."""
    return [s for s in _BAND_STARTS if s < kmax]


def _band_segments(f: int, kmax: int, s_blocks: int, starts: list[int]):
    """Ordered (offset, length, band) covering the (F, kmax, S) slab."""
    bounds = list(starts) + [kmax]
    segs = []
    for fi in range(f):
        base = fi * kmax * s_blocks
        for bi in range(len(starts)):
            k0, k1 = bounds[bi], bounds[bi + 1]
            segs.append((base + k0 * s_blocks, (k1 - k0) * s_blocks, bi))
    return segs


def _encode_coeff_blob(q: torch.Tensor, level: int = 6) -> bytes:
    """Device coefficient tensor (F, nby, nbx, B, B) -> mode-3 entropy blob:
    only zigzag frequencies [0, kmax) leave the device.  The smallest of the
    candidate backends wins; decode reads the tag."""
    f, nby, nbx, b, _ = q.shape
    b2 = b * b
    qf = _to_freq_major(q)
    nz = np.nonzero(to_host(_freq_nnz(qf)))[0]
    if len(nz) == 0:
        return b"\x03" + struct.pack("<H", 0)
    kmax = _bucket_kmax(int(nz.max()) + 1, b2)
    # a fresh tensor (the gather in _to_freq_major copies), safe to edit
    slab = to_host(qf[:, :kmax].contiguous())
    # DC DPCM across the block raster within each frame
    dc = slab[:, 0].reshape(f, nby * nbx).astype(np.int32)
    slab[:, 0] = np.diff(dc, axis=1, prepend=0).astype(np.int16).reshape(
        f, nby, nbx)
    head = b"\x03" + struct.pack("<H", kmax)
    if not native.available():
        return head + b"Z" + zlib.compress(slab.tobytes(), level)
    candidates: list[tuple[bytes, object]] = []

    def race(tag: bytes, make) -> None:
        """One backend's candidate, a ``race`` span of its own."""
        with timing.span("race") as sp:
            sp.note("candidate", tag.decode())
            candidates.append((head + tag + make(), sp))

    starts = _band_plan(kmax)
    # 'B': per-frequency-band rANS contexts; its extra tables lose on small
    # slabs, so it races only above 64 KiB.  RBV_BANDS=0 takes it out of the
    # race, as in the reference.
    if (len(starts) > 1 and slab.nbytes > 64 << 10
            and os.environ.get("RBV_BANDS", "1") != "0"):
        segs = _band_segments(f, kmax, nby * nbx, starts)
        race(b"B", lambda: bytes([len(starts)]) + b"".join(
            struct.pack("<H", s) for s in starts
        ) + native.compress_i16_bands(slab, segs, len(starts)))
    race(b"R", lambda: native.compress_i16(slab))
    # zlib races only for slabs up to 1 MiB (rANS wins above)
    if slab.nbytes <= 1 << 20:
        race(b"Z", lambda: zlib.compress(slab.tobytes(), level))
    best = min(candidates, key=lambda c: len(c[0]))
    for c in candidates:
        c[1].note("won", c is best)
    return best[0]


def _densify(idx: np.ndarray, vals: np.ndarray, shape: tuple,
             device) -> torch.Tensor:
    """Scatter ``vals`` (int16) to the flat indices ``idx`` of a zero int16
    tensor of ``shape`` on ``device``.  Indices outside the tensor are
    dropped, as the reference's ``mode="drop"`` scatter drops them."""
    n = int(np.prod(shape))
    idx_t = to_device(idx.astype(np.int64), device)
    vals_t = to_device(np.array(vals, np.int16), device)
    keep = (idx_t >= 0) & (idx_t < n)
    flat = torch.zeros(n, dtype=torch.int16, device=device)
    flat[idx_t[keep]] = vals_t[keep]
    return flat.reshape(shape)


# --- int8 slab upload (the env RBV_SLAB8, else a measured slow link) --------
# Quantised AC coefficients almost always fit int8, so the AC rows of the
# slab can cross the host -> device link as int8 (half the bytes) with the DC
# row kept int16; the device widens.  The entropy bitstream is unchanged:
# int8 is only a wire format.  It pays only on slow links, so it turns on
# below a measured rate (an H100 over PCIe measures GB/s: off).
_LINK_RATE_MBPS: float | None = None
_SLAB8_LINK_THRESHOLD_MBPS = 100.0


def note_link_rate(mbps: float) -> None:
    """Record a measured host -> device link rate (MB/s) to steer the int8
    wire format.  Callers: the bench twin's setup, the stream app's
    start-up probe."""
    global _LINK_RATE_MBPS
    _LINK_RATE_MBPS = float(mbps)


def measure_link_rate(nbytes: int = 32 << 20,
                      device: torch.device | str = "cuda") -> float:
    """Time one host -> device push of ``nbytes`` (a pageable int16 buffer),
    closed by a synchronize of ``device``, and record the rate (MB/s)."""
    device = resolve(device)
    buf = torch.from_numpy(np.zeros(nbytes // 2, np.int16))
    dst = torch.empty_like(buf, device=device)
    t0 = time.perf_counter()
    dst.copy_(buf)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = max(1e-6, time.perf_counter() - t0)
    rate = nbytes / dt / 1e6
    note_link_rate(rate)
    return rate


def _slab8_enabled() -> bool:
    """The int8 AC wire format: ``RBV_SLAB8`` decides when it is set ("1"
    on, anything else off), else a recorded link rate below the
    threshold."""
    env = os.environ.get("RBV_SLAB8")
    if env is not None:
        return env == "1"
    return (_LINK_RATE_MBPS is not None
            and _LINK_RATE_MBPS < _SLAB8_LINK_THRESHOLD_MBPS)


def _from_freq_slab_split(dc: torch.Tensor, ac: torch.Tensor, b: int,
                          kmax: int) -> torch.Tensor:
    """The DC row (F, nby, nbx) int16 and the AC rows (F, kmax-1, nby, nbx)
    int8, both on the device, widened there -> dense (F, nby, nbx, B, B)
    int16."""
    slab = torch.cat([dc[:, None].to(torch.int16), ac.to(torch.int16)],
                     dim=1)
    return _from_freq_slab(slab, b, kmax)


def _decode_coeff_blob(blob: bytes, f: int, nby: int, nbx: int, b: int,
                       device) -> torch.Tensor:
    """Entropy blob -> int16 coefficients (F, nby, nbx, B, B) on ``device``.
    Mode 3 is the frequency slab the encoders write; modes 2 (per-frame
    sparse), 1 (global sparse) and 0 (dense zlib) are read as the reference
    reads them."""
    shape = (f, nby, nbx, b, b)
    mode = blob[0]
    if mode == 3:
        return _decode_slab_blob(blob, f, nby, nbx, b, device)
    if mode == 2:
        nf, zi_len, zv_len = struct.unpack_from("<III", blob, 1)
        off = 1 + 12
        counts = np.frombuffer(blob[off:off + 4 * nf], np.uint32)
        off += 4 * nf
        deltas = np.frombuffer(zlib.decompress(blob[off:off + zi_len]),
                               np.uint32)
        vals = np.frombuffer(
            zlib.decompress(blob[off + zi_len:off + zi_len + zv_len]),
            np.int16)
        # frame-local delta indices -> global flat indices, wrapped to
        # uint32 as the reference's index array is
        per_frame = nby * nbx * b * b
        idx = np.empty(len(deltas), np.int64)
        pos = 0
        for fi in range(nf):
            c = int(counts[fi])
            idx[pos:pos + c] = (np.cumsum(deltas[pos:pos + c].astype(np.int64))
                                + fi * per_frame)
            pos += c
        return _densify(idx.astype(np.uint32), vals, shape, device)
    if mode == 1:
        _, zi_len, zv_len = struct.unpack_from("<QII", blob, 1)
        off = 1 + 16
        deltas = np.frombuffer(zlib.decompress(blob[off:off + zi_len]),
                               np.uint32)
        vals = np.frombuffer(
            zlib.decompress(blob[off + zi_len:off + zi_len + zv_len]),
            np.int16)
        idx = np.cumsum(deltas.astype(np.uint64)).astype(np.uint32)
        return _densify(idx, vals, shape, device)
    if mode == 0:
        q16 = np.frombuffer(zlib.decompress(blob[1:]), np.int16).reshape(
            shape).copy()
        dcd = q16[:, :, :, 0, 0].reshape(f, nby * nbx).astype(np.int32)
        q16[:, :, :, 0, 0] = np.cumsum(dcd, axis=1).reshape(
            f, nby, nbx).astype(np.int16)
        return to_device(q16, device)
    raise ValueError(f"unknown RBV coefficient blob mode {mode}")


def _decode_slab_blob(blob: bytes, f: int, nby: int, nbx: int, b: int,
                      device) -> torch.Tensor:
    """A mode-3 blob: the zigzag slab [0, kmax) of every block, DC in DPCM
    over each frame's block raster, entropy-coded by the backend its tag
    names."""
    (kmax,) = struct.unpack_from("<H", blob, 1)
    if kmax == 0:
        return torch.zeros((f, nby, nbx, b, b), dtype=torch.int16,
                           device=device)
    backend = blob[3:4]
    n_el = f * kmax * nby * nbx
    if backend == b"B":
        n_bands = blob[4]
        starts = [struct.unpack_from("<H", blob, 5 + 2 * i)[0]
                  for i in range(n_bands)]
        segs = _band_segments(f, kmax, nby * nbx, starts)
        slab = native.decompress_i16_bands(
            blob[5 + 2 * n_bands:], n_el, segs, n_bands)
    elif backend == b"R":
        slab = native.decompress_i16(blob[4:], n_el)
    else:
        slab = np.frombuffer(zlib.decompress(blob[4:]), np.int16).copy()
    slab = slab.reshape(f, kmax, nby, nbx)
    dcd = slab[:, 0].reshape(f, nby * nbx).astype(np.int32)
    slab[:, 0] = np.cumsum(dcd, axis=1).reshape(f, nby, nbx).astype(np.int16)
    if kmax > 1 and _slab8_enabled():
        ac = slab[:, 1:]
        # coefficients are clipped to +-32767 upstream, so abs() is exact
        if np.abs(ac).max(initial=0) <= 127:
            return _from_freq_slab_split(
                to_device(slab[:, 0].copy(), device),
                to_device(ac.astype(np.int8), device), b, kmax)
    return _from_freq_slab(to_device(slab, device), b, kmax)


def _encode_mv_section(mv: np.ndarray, level: int) -> bytes:
    """Motion vectors (F, nby, nbx) -> 'M' section: uint8 candidate indices,
    zlib."""
    z = zlib.compress(mv.astype(np.uint8).tobytes(), level)
    return b"M" + struct.pack("<I", len(z)) + z


def _split_mv_section(blob: bytes, f: int, nby: int, nbx: int):
    """-> (mv (F, nby, nbx) int32 or None, coefficient blob)."""
    if blob[:1] != b"M":
        return None, blob
    (zlen,) = struct.unpack_from("<I", blob, 1)
    mv = np.frombuffer(
        zlib.decompress(blob[5:5 + zlen]), np.uint8
    ).reshape(f, nby, nbx).astype(np.int32)
    return mv, blob[5 + zlen:]


def _encode_intra_section(mode: np.ndarray, level: int) -> bytes:
    """Intra mode maps (n_i, nby, nbx) -> 'I' section: one bit per block
    (1 = planar), packbits + zlib.  The mosaic rides in the coefficients' DC
    slots."""
    mz = zlib.compress(np.packbits(mode.reshape(-1)).tobytes(), level)
    return b"I" + struct.pack("<I", len(mz)) + mz


def _split_intra_section(blob: bytes, n_i: int, nby: int, nbx: int):
    """-> (mode (n_i, nby, nbx) uint8, rest, raw section bytes) or
    (None, blob, b'')."""
    if blob[:1] != b"I":
        return None, blob, b""
    (mlen,) = struct.unpack_from("<I", blob, 1)
    off = 5 + mlen
    mode = np.unpackbits(
        np.frombuffer(zlib.decompress(blob[5:off]), np.uint8),
        count=n_i * nby * nbx,
    ).reshape(n_i, nby, nbx)
    return mode, blob[off:], blob[:off]


# ===========================================================================
# Codec API
# ===========================================================================
@dataclasses.dataclass
class RbvParams:
    """The reference's ``RbvParams``."""

    qp: int = 32
    block_size: int = 16
    gop_size: int = 2
    lossless: bool = False
    zlib_level: int = 6
    # motion-compensated P frames (block search on the device, flag bit 1)
    motion: bool = False
    # optional (F, H, W) weights masking the MC search's distortion
    # (occupancy-aware RDO); encoder-side only, sent as uint8
    mc_weight: object = None
    # in-loop deblocking (flag bit 2)
    deblock: bool = False
    # zero the quantised +/-1 at zigzag rank >= this (0 = off); encoder-side
    coeff_threshold: int = 0
    # mosaic intra prediction on I frames (flag bit 3)
    intra: bool = False


def _plane_dims(width: int, height: int,
                fmt: ColorFormat) -> list[tuple[int, int]]:
    if fmt == ColorFormat.YUV400:
        return [(height, width)]
    if fmt == ColorFormat.YUV420:
        return [(height, width), (height // 2, width // 2),
                (height // 2, width // 2)]
    return [(height, width)] * 3


def _to_device(p: np.ndarray, device) -> torch.Tensor:
    # integer samples are exact in float32; cast on the host because torch
    # has no uint16 arithmetic
    return to_device(p.astype(np.float32), device)


def encode(video: Video, params: RbvParams,
           device: torch.device | str = "cuda") -> tuple[bytes, Video]:
    """Encode a Video -> (payload bytes, closed-loop reconstruction)."""
    device = resolve(device)
    f = video.frame_count
    use_mc = params.motion and not params.lossless and params.gop_size > 1
    use_db = params.deblock and not params.lossless
    use_intra = params.intra and not params.lossless
    flags = ((_LOSSLESS if params.lossless else 0) | (_MC if use_mc else 0)
             | (_DEBLOCK if use_db else 0) | (_INTRA if use_intra else 0))
    header = _HEADER.pack(
        _MAGIC, 2, flags, video.width, video.height, video.bitdepth,
        int(video.format), f, params.block_size, params.gop_size, params.qp,
        0,
    )
    blobs: list[bytes] = []
    recon_planes: list[np.ndarray] = []
    maxval = float((1 << video.bitdepth) - 1)

    if params.lossless:
        # serialise in the dtype the header's bitdepth implies
        ldt = np.uint8 if video.bitdepth <= 8 else np.uint16
        for p in video.planes:
            p = np.ascontiguousarray(p.astype(ldt))
            # binary planes (occupancy) bit-pack 8:1 before DEFLATE
            if p.dtype == np.uint8 and p.max(initial=0) <= 1:
                packed = np.packbits(p.reshape(-1))
                blobs.append(
                    b"P" + zlib.compress(packed.tobytes(), params.zlib_level))
            else:
                blobs.append(
                    b"Z" + zlib.compress(p.tobytes(), params.zlib_level))
            recon_planes.append(p.copy())
    else:
        b = params.block_size
        qstep = _f32(qstep_of(params.qp))
        for p in video.planes:
            orig_h, orig_w = p.shape[-2:]
            x = blockify(_to_device(pad_to_block(p, b), device), b)
            weights = None
            wplane = params.mc_weight
            if use_mc and wplane is not None and wplane.shape[-2:] == (
                    orig_h, orig_w):
                # the reference sends the weights as uint8
                weights = _to_device(
                    pad_to_block(np.asarray(wplane, np.uint8), b), device)
            coded = encode_chain(
                x, qstep, maxval, params.gop_size, deblock=use_db,
                thr_k=params.coeff_threshold, intra=use_intra,
                search=use_mc, weights=weights)
            blob = b""
            if use_mc:
                blob += _encode_mv_section(to_host(coded["mv"]),
                                           params.zlib_level)
            if use_intra:
                blob += _encode_intra_section(to_host(coded["mode"]),
                                              params.zlib_level)
            blobs.append(blob + _encode_coeff_blob(coded["q"],
                                                   params.zlib_level))
            rec = to_host(deblockify(coded["rec"]).to(torch.int32))
            recon_planes.append(rec[:, :orig_h, :orig_w].astype(p.dtype))

    out = bytearray(header)
    for blob in blobs:
        out.extend(struct.pack("<I", len(blob)))
        out.extend(blob)
    recon = Video(video.width, video.height, video.bitdepth, video.format,
                  recon_planes)
    return bytes(out), recon


def _parse_header(payload: bytes):
    magic, ver, flags, width, height, bitdepth, chroma, f, block, gop, qp, _ = (
        _HEADER.unpack_from(payload, 0)
    )
    if magic != _MAGIC:
        raise ValueError("not an RBV bitstream")
    if ver != 2:
        raise ValueError(f"unsupported RBV version {ver}")
    return flags, width, height, bitdepth, chroma, f, block, gop, qp


def _iter_blobs(payload: bytes, n_planes: int):
    pos = _HEADER.size
    for _ in range(n_planes):
        (blob_len,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        yield payload[pos : pos + blob_len]
        pos += blob_len


class _Plane:
    """One lossy plane of a payload, its side sections split off: the
    motion vectors (F, nby, nbx), the intra mode maps (n_gops, nby, nbx)
    and the coefficients (F, nby, nbx, B, B) on ``device``, decoded from
    ``coeff_blob``."""

    def __init__(self, blob: bytes, flags: int, f: int, h: int, w: int,
                 block: int, gop: int, device):
        self.nby = (h + ((-h) % block)) // block
        self.nbx = (w + ((-w) % block)) // block
        mv, rest = None, blob
        if flags & _MC:
            mv, rest = _split_mv_section(blob, f, self.nby, self.nbx)
        self.mv = mv
        self.mode, rest, self.raw_mode = None, rest, b""
        if flags & _INTRA:
            n_i = (f + ((-f) % gop)) // gop
            self.mode, rest, self.raw_mode = _split_intra_section(
                rest, n_i, self.nby, self.nbx)
        self.coeff_blob = rest
        self.q = _decode_coeff_blob(rest, f, self.nby, self.nbx, block,
                                    device)

    def tensor(self, name: str):
        x = getattr(self, name)
        return None if x is None else to_device(x, self.q.device)


def decode(payload: bytes, device: torch.device | str = "cuda") -> Video:
    """Decode an RBV payload -> Video."""
    device = resolve(device)
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    fmt = ColorFormat(chroma)
    dims = _plane_dims(width, height, fmt)
    dtype = np.uint8 if bitdepth <= 8 else np.uint16
    maxval = float((1 << bitdepth) - 1)
    planes: list[np.ndarray] = []
    for (h, w), blob in zip(dims, _iter_blobs(payload, len(dims))):
        if flags & _LOSSLESS:
            raw = zlib.decompress(blob[1:])
            if blob[:1] == b"P":
                bits = np.unpackbits(np.frombuffer(raw, np.uint8),
                                     count=f * h * w)
                planes.append(bits.astype(dtype).reshape(f, h, w))
            else:
                planes.append(np.frombuffer(raw, dtype=dtype).reshape(f, h, w))
            continue
        pl = _Plane(blob, flags, f, h, w, block, gop, device)
        rec = deblockify(decode_chain(
            pl.q, _f32(qstep_of(qp)), maxval, gop, bool(flags & _DEBLOCK),
            pl.tensor("mode"), pl.tensor("mv")))
        planes.append(to_host(rec.to(torch.int32))[:, :h, :w]
                      .astype(dtype))
    return Video(width, height, bitdepth, fmt, planes)


def _reencode_lossless(payload: bytes, new_qp: int, new_gop: int | None,
                       zlib_level: int, device: torch.device) -> bytes:
    """Lossless input has no coefficient domain: transcoding it to a lossy
    rate point is a first quantisation (full decode -> encode)."""
    _, _, _, _, _, _, block, gop, _ = _parse_header(payload)
    video = decode(payload, device)
    out, _ = encode(video, RbvParams(
        qp=new_qp, block_size=block, gop_size=max(1, new_gop or gop),
        zlib_level=zlib_level,
    ), device)
    return out


def requantize(payload: bytes, new_qp: int, zlib_level: int = 6,
               device: torch.device | str = "cuda") -> bytes:
    """DCT-domain transcode: re-quantise the coefficients to a new QP
    without a pixel-domain round trip.  Non-MC streams with GOP > 1 fold
    each frame's requantisation error into the next frame (drift
    compensated); MC streams and GOP 1 rescale open-loop.  Motion vectors
    and intra mode maps pass through.  Lossless streams take the
    decode -> encode path."""
    device = resolve(device)
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    if flags & _LOSSLESS:
        return _reencode_lossless(payload, new_qp, None, zlib_level, device)
    if new_qp == qp:
        return payload
    header = _HEADER.pack(
        _MAGIC, 2, flags, width, height, bitdepth, chroma, f, block, gop,
        new_qp, 0,
    )
    dims = _plane_dims(width, height, ColorFormat(chroma))
    qs_old, qs_new = _f32(qstep_of(qp)), _f32(qstep_of(new_qp))
    out = bytearray(header)
    for (h, w), blob in zip(dims, _iter_blobs(payload, len(dims))):
        pl = _Plane(blob, flags, f, h, w, block, gop, device)
        side = b""
        if pl.mv is not None:
            side = _encode_mv_section(pl.mv, zlib_level)
        # the mode map passes through as it is (the decoder needs the
        # encoder's DC/planar choice); the mosaic rescales in the DC slots
        side += pl.raw_mode
        if not flags & _MC and gop > 1:
            q2 = tools.requant_compensated(pl.q, qs_old, qs_new, gop)
        else:
            q2 = tools.requant(pl.q, qs_old, qs_new)
        new_blob = side + _encode_coeff_blob(q2, zlib_level)
        out.extend(struct.pack("<I", len(new_blob)))
        out.extend(new_blob)
    return bytes(out)


def transcode_chains(q: torch.Tensor, mv, mode, qs_in, qs_out,
                     maxval: float, gop: int, gop_out: int, deblock: bool,
                     intra: bool, thr_k: int):
    """The plain-chain transcode of coefficients (F, nby, nbx, B, B) with
    their motion vectors (F, nby, nbx) and intra mode maps (n_gops, nby,
    nbx), each None when the stream has none -> (int16 coefficients, the
    re-coded mode maps or None).  The steps are floats, or per-frame
    tensors when streams are stacked on the frame axis.  On a card, MC +
    intra streams without deblocking or threshold run the chains in one
    hand-written kernel (``transcode_mc_intra``), equal to them bit for
    bit."""
    if mc_intra_applies(q.device, q.shape[-1], mv is not None, intra,
                        deblock, thr_k, gop, gop_out):
        return transcode_mc_intra(q, mv, mode, qs_in, qs_out, maxval, gop)
    if mv is None and not intra:
        return transcode_coeffs_ref(q, qs_in, qs_out, maxval, gop, gop_out,
                                    deblock, thr_k), None
    pixels = decode_chain(q, qs_in, maxval, gop, deblock, mode, mv)
    coded = encode_chain(pixels, qs_out, maxval, gop_out, recon=False,
                         deblock=deblock, thr_k=thr_k, intra=intra, mv=mv)
    return coded["q"], coded["mode"]


def _transcode_plane(pl: _Plane, qs_in: float, qs_out: float,
                     maxval: float, gop: int, gop_out: int, deblock: bool,
                     intra: bool, thr_k: int):
    """The device part of one plane's transcode -> (int16 coefficients
    (F, nby, nbx, B, B), intra mode maps or None).  The reference pads the
    frames to whole GOPs first; every chain is causal, so the first F output
    frames (and the mode maps of their GOPs) do not depend on the padding.
    """
    if pl.mv is None and not intra and not deblock and not thr_k:
        # the branch of the fused kernel
        return transcode_coeffs(pl.q, qs_in, qs_out, maxval, gop,
                                gop_out), None
    return transcode_chains(pl.q, pl.tensor("mv"), pl.tensor("mode"), qs_in,
                            qs_out, maxval, gop, gop_out, deblock, intra,
                            thr_k)


def transcode_payload(
    payload: bytes,
    new_qp: int,
    new_gop: int | None = None,
    zlib_level: int = 6,
    coeff_threshold: int = 0,
    device: torch.device | str = "cuda",
) -> bytes:
    """Drift-free transcode: entropy decode on the host, the fused
    decode -> re-encode on ``device`` (pixels never leave it), entropy
    encode on the host.  MC streams keep their GOP (the motion vectors are
    bound to it) and reuse their motion vectors; intra streams re-code
    their I frames through the mosaic predictors."""
    device = resolve(device)
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    if flags & _LOSSLESS:
        return _reencode_lossless(payload, new_qp, new_gop, zlib_level,
                                  device)
    use_mc = bool(flags & _MC)
    use_db = bool(flags & _DEBLOCK)
    use_intra = bool(flags & _INTRA)
    gop_out = gop if use_mc else (new_gop or gop)
    header = _HEADER.pack(
        _MAGIC, 2, flags, width, height, bitdepth, chroma, f, block, gop_out,
        new_qp, 0,
    )
    dims = _plane_dims(width, height, ColorFormat(chroma))
    qs_in = _f32(qstep_of(qp))
    qs_out = _f32(qstep_of(new_qp))
    maxval = float((1 << bitdepth) - 1)

    parent = timing.current()

    def one_plane(args) -> bytes:
        pi, ((h, w), blob) = args
        with timing.span("entropy_decode", parent, plane=pi, cpu=True):
            pl = _Plane(blob, flags, f, h, w, block, gop, device)
        with timing.span("submit", parent, plane=pi):
            q2, mode2 = _transcode_plane(pl, qs_in, qs_out, maxval, gop,
                                         gop_out, use_db, use_intra,
                                         coeff_threshold)
        with timing.span("entropy_encode", parent, plane=pi, cpu=True):
            side = b"" if pl.mv is None else _encode_mv_section(pl.mv,
                                                                 zlib_level)
            if mode2 is not None:
                n_i_out = (f + ((-f) % gop_out)) // gop_out
                side += _encode_intra_section(to_host(mode2)[:n_i_out],
                                              zlib_level)
            return side + _encode_coeff_blob(q2, zlib_level)

    # one thread per plane: host entropy (rANS, inflate/deflate release the
    # interpreter lock) overlaps across planes while the device queue runs
    # the chains in order; ex.map keeps the plane order
    with cf.ThreadPoolExecutor(max_workers=max(1, len(dims))) as ex:
        blobs = list(ex.map(one_plane, enumerate(zip(
            dims, _iter_blobs(payload, len(dims))))))
    out = bytearray(header)
    for blob in blobs:
        out.extend(struct.pack("<I", len(blob)))
        out.extend(blob)
    return bytes(out)


def probe(payload: bytes) -> dict:
    """Read stream parameters without decoding."""
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    return {
        "width": width, "height": height, "bitdepth": bitdepth,
        "format": ColorFormat(chroma), "frame_count": f,
        "block_size": block, "gop_size": gop, "qp": qp,
        "lossless": bool(flags & 1),
        "motion": bool(flags & 2),
        "deblock": bool(flags & 4),
        "intra": bool(flags & 8),
    }
