"""Bit-level reader/writer with Exp-Golomb coding.

Capability parity with PCCBitstream (source/lib/
PccLibBitstreamCommon/include/PCCBitstream.h:58-232): u(n) fixed-width
reads/writes up to 64 bits, ue(v)/se(v) Exp-Golomb, byte alignment,
raw byte-string embedding, MD5, and per-V3C-unit size accounting
(BitstreamStat).  MSB-first bit order as in all MPEG specs.
"""

from __future__ import annotations

import hashlib

from ..utils.enums import V3CUnitType


class BitWriter:
    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0      # bit accumulator (current partial byte)
        self._nbits = 0    # bits currently in accumulator

    # -- fixed width ----------------------------------------------------
    def u(self, nbits: int, value: int) -> None:
        if nbits == 0:
            return
        if value < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in u({nbits})")
        acc = (self._acc << nbits) | value
        total = self._nbits + nbits
        while total >= 8:
            total -= 8
            self._buf.append((acc >> total) & 0xFF)
        self._acc = acc & ((1 << total) - 1)
        self._nbits = total

    # -- exp-golomb -----------------------------------------------------
    def ue(self, value: int) -> None:
        if value < 0:
            raise ValueError("ue(v) needs non-negative value")
        code = value + 1
        nbits = code.bit_length()
        self.u(nbits - 1, 0)
        self.u(nbits, code)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    # -- alignment / raw bytes ------------------------------------------
    @property
    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def byte_align(self, alignment_bit: int = 1) -> None:
        """rbsp alignment: one '1' bit then zero bits to the byte boundary."""
        self.u(1, alignment_bit)
        if self._nbits:
            self.u(8 - self._nbits, 0)

    def zero_align(self) -> None:
        if self._nbits:
            self.u(8 - self._nbits, 0)

    def write_bytes(self, data: bytes) -> None:
        if not self.byte_aligned:
            raise ValueError("write_bytes requires byte alignment")
        self._buf.extend(data)

    def string(self, s: bytes, width: int) -> None:
        """Fixed-width byte string (e.g. md5 = 16 bytes in hash SEI)."""
        assert len(s) == width
        for b in s:
            self.u(8, b)

    def st(self, s: bytes) -> None:
        """st(v): byte-align, then NUL-terminated string
        (PCCBitstream.h:204-208 writeString)."""
        self.zero_align()
        for b in s:
            self.u(8, b)
        self.u(8, 0)

    # -- results --------------------------------------------------------
    @property
    def size_bytes(self) -> int:
        return len(self._buf) + (1 if self._nbits else 0)

    def data(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte aligned; call byte_align()")
        return bytes(self._buf)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0      # byte position
        self._bit = 0      # bit position within current byte (0..7, MSB first)

    # -- fixed width ----------------------------------------------------
    def u(self, nbits: int) -> int:
        v = 0
        remaining = nbits
        while remaining > 0:
            if self._pos >= len(self._data):
                raise EOFError("bitstream exhausted")
            avail = 8 - self._bit
            take = min(avail, remaining)
            byte = self._data[self._pos]
            chunk = (byte >> (avail - take)) & ((1 << take) - 1)
            v = (v << take) | chunk
            self._bit += take
            remaining -= take
            if self._bit == 8:
                self._bit = 0
                self._pos += 1
        return v

    # -- exp-golomb -----------------------------------------------------
    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("corrupt ue(v)")
        return ((1 << zeros) | self.u(zeros)) - 1 if zeros else 0

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 == 1 else -(k // 2)

    # -- alignment / raw bytes ------------------------------------------
    @property
    def byte_aligned(self) -> bool:
        return self._bit == 0

    def byte_align(self) -> None:
        """Skip to the next byte boundary (no-op when already aligned)."""
        if self._bit:
            one = self.u(1)
            del one
            while self._bit:
                self.u(1)

    def rbsp_trailing(self) -> None:
        """Consume rbsp_trailing_bits: the stop bit is ALWAYS present (the
        writer's byte_align emits '1' + zero pad even when already aligned),
        so an aligned reader must still eat one full byte — a landed-exactly-
        on-a-byte tile header once desynced the whole data unit here."""
        self.u(1)
        while self._bit:
            self.u(1)

    def read_bytes(self, n: int) -> bytes:
        if self._bit:
            raise ValueError("read_bytes requires byte alignment")
        if self._pos + n > len(self._data):
            raise EOFError("bitstream exhausted")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def string(self, width: int) -> bytes:
        return bytes(self.u(8) for _ in range(width))

    def st(self) -> bytes:
        """st(v): byte-align, then NUL-terminated string
        (PCCBitstream.h:193-202 readString)."""
        while not self.byte_aligned:
            self.u(1)
        out = bytearray()
        b = self.u(8)
        while b != 0:
            out.append(b)
            b = self.u(8)
        return bytes(out)

    # -- state ----------------------------------------------------------
    @property
    def position(self) -> int:
        return self._pos

    @property
    def more_data(self) -> bool:
        return self._pos < len(self._data)

    def remaining(self) -> int:
        return len(self._data) - self._pos


def md5_of(data: bytes) -> bytes:
    return hashlib.md5(data).digest()


class BitstreamStat:
    """Per-V3C-unit size accounting (PCCBitstreamStat analog,
    PCCBitstream.h:58-118): tracks bytes per unit type for the end-of-run
    bitrate report."""

    def __init__(self) -> None:
        self.sizes: dict[V3CUnitType, int] = {t: 0 for t in V3CUnitType}
        self.video_sizes: dict[str, int] = {}
        self.header_bytes = 0

    def add(self, unit_type: V3CUnitType, nbytes: int) -> None:
        self.sizes[unit_type] = self.sizes.get(unit_type, 0) + nbytes

    def add_video(self, name: str, nbytes: int) -> None:
        self.video_sizes[name] = self.video_sizes.get(name, 0) + nbytes

    def total(self) -> int:
        return self.header_bytes + sum(self.sizes.values())

    def report(self) -> str:
        lines = ["V3C unit sizes (bytes):"]
        for t, n in self.sizes.items():
            if n:
                lines.append(f"  {t.name:8s} {n}")
        for name, n in self.video_sizes.items():
            lines.append(f"  video {name}: {n}")
        lines.append(f"  total    {self.total()}")
        return "\n".join(lines)
