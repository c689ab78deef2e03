"""Plain reader of the V3C streams the benchmark feeds and receives.

Written from the formats, not from the program: the V3C sample-stream
framing (ISO/IEC 23090-5 Annex C), the RBV video payload (header, per-plane
blobs, the 'M' motion-vector and 'I' intra mode-map sections, the mode-3
zigzag frequency slab with DC DPCM) and its three entropy back ends: zlib
('Z'), order-0 rANS over an RLE0 tokenisation ('R') and the same per
frequency band ('B').  numpy and the standard library only; the rANS state
machine is a Python loop (about 0.3 us a symbol).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

# V3C unit types (vuh_unit_type)
VPS, AD, OVD, GVD, AVD = 0, 1, 2, 3, 4

# RBV payload header: magic, version, flags, width, height, bit depth,
# colour format, frames, block size, GOP, QP, reserved
RBV_HEADER = struct.Struct("<4sBBHHBBHBBBB")
LOSSLESS, MC, DEBLOCK, INTRA = 1, 2, 4, 8
YUV400, YUV420 = 0, 1

_PROB_BITS = 12
_RANS_L = 1 << 23


def read_units(data: bytes) -> list[tuple[int, bytes]]:
    """A V3C sample stream -> [(unit type, whole unit bytes)] in order."""
    precision = (data[0] >> 5) + 1
    units, pos = [], 1
    while pos + precision <= len(data):
        size = int.from_bytes(data[pos:pos + precision], "big")
        pos += precision
        unit = data[pos:pos + size]
        if len(unit) != size:
            raise ValueError("truncated V3C unit")
        units.append((unit[0] >> 3, unit))
        pos += size
    if pos != len(data):
        raise ValueError("trailing bytes after the last V3C unit")
    return units


@dataclasses.dataclass
class Header:
    flags: int
    width: int
    height: int
    bitdepth: int
    chroma: int
    frames: int
    block: int
    gop: int
    qp: int

    def fields(self) -> tuple:
        return dataclasses.astuple(self)


@dataclasses.dataclass
class Plane:
    """One plane of an RBV payload: samples (lossless) or int16
    coefficients (F, nby, nbx, B, B), motion vectors (F, nby, nbx) and intra
    mode maps (n_gops, nby, nbx), each None where the payload has none."""

    height: int
    width: int
    samples: np.ndarray | None = None
    q: np.ndarray | None = None
    mv: np.ndarray | None = None
    mode: np.ndarray | None = None


def parse_header(payload: bytes) -> Header:
    magic, ver, flags, w, h, bd, chroma, f, b, gop, qp, _ = (
        RBV_HEADER.unpack_from(payload, 0))
    if magic != b"RBV2" or ver != 2:
        raise ValueError("not an RBV version-2 payload")
    return Header(flags, w, h, bd, chroma, f, b, gop, qp)


def plane_dims(hd: Header) -> list[tuple[int, int]]:
    if hd.chroma == YUV400:
        return [(hd.height, hd.width)]
    if hd.chroma == YUV420:
        half = (hd.height // 2, hd.width // 2)
        return [(hd.height, hd.width), half, half]
    return [(hd.height, hd.width)] * 3


def zigzag(n: int) -> np.ndarray:
    """Flat indices of an n x n block in zigzag order: anti-diagonals,
    odd ones walked downwards, even ones upwards."""
    cells = sorted(((i, j) for i in range(n) for j in range(n)),
                   key=lambda p: (p[0] + p[1],
                                  p[0] if (p[0] + p[1]) % 2 else -p[0]))
    return np.array([i * n + j for i, j in cells], np.int64)


def _rans_stream(buf: bytes, pos: int) -> tuple[np.ndarray, int]:
    """One rANS-coded byte stream at ``pos``: u32 symbol count, 256 u16
    frequencies (summing to 4096), u32 body length, body (32-bit state, byte
    renormalisation below 2^23) -> (uint8 symbols, position after it)."""
    (n,) = struct.unpack_from("<I", buf, pos)
    freq = np.frombuffer(buf, "<u2", 256, pos + 4).astype(np.int64)
    (blen,) = struct.unpack_from("<I", buf, pos + 516)
    end = pos + 520 + blen
    body = buf[pos + 520:end]
    if freq.sum() != 1 << _PROB_BITS or len(body) != blen or blen < 4:
        raise ValueError("malformed rANS stream")
    cum = np.concatenate([[0], np.cumsum(freq)])
    sym = np.repeat(np.arange(256), freq)
    lut = list(zip(sym.tolist(), freq[sym].tolist(),
                   (np.arange(1 << _PROB_BITS) - cum[sym]).tolist()))
    out = bytearray(n)
    x = int.from_bytes(body[:4], "big")
    p = 4
    for i in range(n):
        s, f, d = lut[x & 4095]
        out[i] = s
        x = f * (x >> 12) + d
        while x < _RANS_L and p < blen:
            x = (x << 8) | body[p]
            p += 1
    return np.frombuffer(bytes(out), np.uint8), end


def _varints(b: np.ndarray) -> np.ndarray:
    """LEB128 varints (7 bits a byte, high bit = more follows) -> uint64."""
    if len(b) == 0 or b[-1] & 0x80:
        raise ValueError("malformed run-length varints")
    ends = np.flatnonzero((b & 0x80) == 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    group = np.repeat(np.arange(len(ends)), ends - starts + 1)
    shift = (np.arange(len(b)) - starts[group]) * 7
    vals = (b & 0x7F).astype(np.uint64) << shift.astype(np.uint64)
    return np.add.reduceat(vals, starts)


def _unrle(runs: np.ndarray, lo: np.ndarray, hi: np.ndarray,
           n: int) -> np.ndarray:
    """RLE0 tokens (zero runs as varints, then the literals' zigzag-mapped
    low and high bytes; a run before every literal and one after the last)
    -> int16 values of length n."""
    r = _varints(runs).astype(np.int64)
    if len(lo) != len(hi) or len(r) != len(lo) + 1 or r.sum() + len(lo) != n:
        raise ValueError("RLE0 tokens do not cover the slab")
    z = lo.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    vals = ((z >> 1) ^ (-(z & 1).astype(np.int32)).astype(np.uint16)).view(
        np.int16)
    out = np.zeros(n, np.int16)
    out[np.cumsum(r[:-1]) + np.arange(len(lo))] = vals
    return out


def _rans_tokens(buf: bytes, pos: int):
    runs, pos = _rans_stream(buf, pos)
    lo, pos = _rans_stream(buf, pos)
    hi, pos = _rans_stream(buf, pos)
    return runs, lo, hi, pos


def _band_segments(f: int, kmax: int, s: int, starts: list[int]):
    """(offset, length, band) of the (F, kmax, S) slab, frame-major."""
    bounds = list(starts) + [kmax]
    return [(fi * kmax * s + bounds[bi] * s,
             (bounds[bi + 1] - bounds[bi]) * s, bi)
            for fi in range(f) for bi in range(len(starts))]


def _slab(blob: bytes, f: int, nby: int, nbx: int) -> np.ndarray:
    """A mode-3 coefficient blob -> int16 slab (F, kmax, nby, nbx), DC
    DPCM undone (kmax = 0: an empty slab)."""
    if blob[0] != 3:
        raise ValueError(f"coefficient blob mode {blob[0]} is not mode 3")
    (kmax,) = struct.unpack_from("<H", blob, 1)
    if kmax == 0:
        return np.zeros((f, 0, nby, nbx), np.int16)
    n = f * kmax * nby * nbx
    tag = blob[3:4]
    if tag == b"Z":
        slab = np.frombuffer(zlib.decompress(blob[4:]), np.int16).copy()
    elif tag == b"R":
        body = blob[4:]
        if body[:2] != b"R0" or struct.unpack_from("<Q", body, 2)[0] != n:
            raise ValueError("malformed 'R' slab")
        runs, lo, hi, _ = _rans_tokens(body, 10)
        slab = _unrle(runs, lo, hi, n)
    elif tag == b"B":
        n_bands = blob[4]
        starts = list(struct.unpack_from(f"<{n_bands}H", blob, 5))
        body = blob[5 + 2 * n_bands:]
        if (body[:2] != b"RB" or struct.unpack_from("<Q", body, 2)[0] != n
                or body[10] != n_bands):
            raise ValueError("malformed 'B' slab")
        segs = _band_segments(f, kmax, nby * nbx, starts)
        slab = np.zeros(n, np.int16)
        pos = 11
        for band in range(n_bands):
            runs, lo, hi, pos = _rans_tokens(body, pos)
            mine = [(o, ln) for o, ln, b in segs if b == band]
            vals = _unrle(runs, lo, hi, sum(ln for _, ln in mine))
            at = 0
            for o, ln in mine:
                slab[o:o + ln] = vals[at:at + ln]
                at += ln
    else:
        raise ValueError(f"unknown slab back end {tag!r}")
    if slab.size != n:
        raise ValueError("slab size does not match the header")
    slab = slab.reshape(f, kmax, nby, nbx)
    dc = slab[:, 0].reshape(f, -1).astype(np.int32)
    slab[:, 0] = np.cumsum(dc, axis=1).astype(np.int16).reshape(f, nby, nbx)
    return slab


def _dense(slab: np.ndarray, b: int) -> np.ndarray:
    """(F, kmax, nby, nbx) zigzag slab -> (F, nby, nbx, B, B)."""
    f, kmax, nby, nbx = slab.shape
    full = np.zeros((f, nby, nbx, b * b), np.int16)
    full[..., zigzag(b)[:kmax]] = slab.transpose(0, 2, 3, 1)
    return full.reshape(f, nby, nbx, b, b)


def _section(blob: bytes, tag: bytes) -> tuple[bytes | None, bytes]:
    """Split a side section ``tag`` + u32 length + zlib body off ``blob``."""
    if blob[:1] != tag:
        return None, blob
    (ln,) = struct.unpack_from("<I", blob, 1)
    return zlib.decompress(blob[5:5 + ln]), blob[5 + ln:]


def read_payload(payload: bytes) -> tuple[Header, list[Plane]]:
    """An RBV payload -> (header, planes)."""
    hd = parse_header(payload)
    pos = RBV_HEADER.size
    planes = []
    for h, w in plane_dims(hd):
        (ln,) = struct.unpack_from("<I", payload, pos)
        blob = payload[pos + 4:pos + 4 + ln]
        pos += 4 + ln
        pl = Plane(h, w)
        f = hd.frames
        if hd.flags & LOSSLESS:
            raw = zlib.decompress(blob[1:])
            if blob[:1] == b"P":
                pl.samples = np.unpackbits(np.frombuffer(raw, np.uint8),
                                           count=f * h * w).reshape(f, h, w)
            else:
                dt = np.uint8 if hd.bitdepth <= 8 else np.uint16
                pl.samples = np.frombuffer(raw, dt).reshape(f, h, w)
            planes.append(pl)
            continue
        b = hd.block
        nby, nbx = -(-h // b), -(-w // b)
        if hd.flags & MC:
            raw, blob = _section(blob, b"M")
            if raw is not None:
                pl.mv = np.frombuffer(raw, np.uint8).reshape(f, nby, nbx)
        if hd.flags & INTRA:
            raw, blob = _section(blob, b"I")
            if raw is not None:
                n_i = -(-f // hd.gop)
                pl.mode = np.unpackbits(np.frombuffer(raw, np.uint8),
                                        count=n_i * nby * nbx).reshape(
                    n_i, nby, nbx)
        pl.q = _dense(_slab(blob, f, nby, nbx), b)
        planes.append(pl)
    if pos != len(payload):
        raise ValueError("trailing bytes after the last plane")
    return hd, planes
