"""V3C units + sample-stream framing (23090-5 §8.1 / Annex C).

Parity with SampleStreamV3CUnit / V3CUnit and PCCBitstreamReader::read /
PCCBitstreamWriter::write (SURVEY.md §2.2): the outermost container of a
.v3c/.bin file — a sample-stream header followed by size-prefixed V3C units
(VPS / AD / OVD / GVD / AVD).
"""

from __future__ import annotations

import dataclasses

from ..utils.enums import V3CUnitType
from .bitio import BitReader, BitWriter


@dataclasses.dataclass
class V3CUnitHeader:
    unit_type: V3CUnitType = V3CUnitType.V3C_VPS
    vuh_v3c_parameter_set_id: int = 0
    vuh_atlas_id: int = 0
    vuh_attribute_index: int = 0
    vuh_attribute_partition_index: int = 0
    vuh_map_index: int = 0
    vuh_auxiliary_video_flag: bool = False

    def write(self, bw: BitWriter) -> None:
        bw.u(5, int(self.unit_type))
        t = self.unit_type
        if t in (V3CUnitType.V3C_AD, V3CUnitType.V3C_OVD):
            bw.u(4, self.vuh_v3c_parameter_set_id)
            bw.u(6, self.vuh_atlas_id)
            bw.u(17, 0)
        elif t == V3CUnitType.V3C_GVD:
            bw.u(4, self.vuh_v3c_parameter_set_id)
            bw.u(6, self.vuh_atlas_id)
            bw.u(4, self.vuh_map_index)
            bw.u(1, self.vuh_auxiliary_video_flag)
            bw.u(12, 0)
        elif t == V3CUnitType.V3C_AVD:
            bw.u(4, self.vuh_v3c_parameter_set_id)
            bw.u(6, self.vuh_atlas_id)
            bw.u(7, self.vuh_attribute_index)
            bw.u(5, self.vuh_attribute_partition_index)
            bw.u(4, self.vuh_map_index)
            bw.u(1, self.vuh_auxiliary_video_flag)
        else:  # V3C_VPS
            bw.u(27, 0)

    @classmethod
    def read(cls, br: BitReader) -> "V3CUnitHeader":
        s = cls()
        s.unit_type = V3CUnitType(br.u(5))
        t = s.unit_type
        if t in (V3CUnitType.V3C_AD, V3CUnitType.V3C_OVD):
            s.vuh_v3c_parameter_set_id = br.u(4)
            s.vuh_atlas_id = br.u(6)
            br.u(17)
        elif t == V3CUnitType.V3C_GVD:
            s.vuh_v3c_parameter_set_id = br.u(4)
            s.vuh_atlas_id = br.u(6)
            s.vuh_map_index = br.u(4)
            s.vuh_auxiliary_video_flag = bool(br.u(1))
            br.u(12)
        elif t == V3CUnitType.V3C_AVD:
            s.vuh_v3c_parameter_set_id = br.u(4)
            s.vuh_atlas_id = br.u(6)
            s.vuh_attribute_index = br.u(7)
            s.vuh_attribute_partition_index = br.u(5)
            s.vuh_map_index = br.u(4)
            s.vuh_auxiliary_video_flag = bool(br.u(1))
        else:
            br.u(27)
        return s


@dataclasses.dataclass
class V3CUnit:
    header: V3CUnitHeader
    payload: bytes  # unit payload, excluding the 4-byte unit header

    def to_bytes(self) -> bytes:
        bw = BitWriter()
        self.header.write(bw)
        return bw.data() + self.payload

    @classmethod
    def from_bytes(cls, data: bytes) -> "V3CUnit":
        br = BitReader(data)
        header = V3CUnitHeader.read(br)
        return cls(header, data[4:])


def sample_stream_header(precision: int = 4) -> bytes:
    bw = BitWriter()
    bw.u(3, precision - 1)
    bw.u(5, 0)
    return bw.data()


def write_sample_stream_units(units: list[V3CUnit], precision: int = 4) -> bytes:
    """Size-prefixed units only (no header) — for appending GOFs to an open
    stream whose header was already written (fixed precision)."""
    out = bytearray()
    for u in units:
        b = u.to_bytes()
        out.extend(len(b).to_bytes(precision, "big"))
        out.extend(b)
    return bytes(out)


def write_sample_stream_v3c(
    units: list[V3CUnit], forced_precision: int = 0
) -> bytes:
    """sample_stream_v3c_header + size-prefixed V3C units -> whole file bytes.

    forced_precision pins the size-field width in bytes (reference
    forcedSsvhUnitSizePrecisionBytes, PCCBitstreamWriter::write precision
    arg); 0 derives the minimum width from the largest unit."""
    blobs = [u.to_bytes() for u in units]
    max_size = max((len(b) for b in blobs), default=1)
    precision = max(1, (max_size.bit_length() + 7) // 8)
    if forced_precision:
        if forced_precision < precision or forced_precision > 8:
            raise ValueError(
                f"forcedSsvhUnitSizePrecisionBytes={forced_precision} cannot "
                f"hold a {max_size}-byte V3C unit (needs {precision})"
            )
        precision = forced_precision
    out = bytearray(sample_stream_header(precision))
    for b in blobs:
        out.extend(len(b).to_bytes(precision, "big"))
        out.extend(b)
    return bytes(out)


def read_sample_stream_v3c(data: bytes) -> list[V3CUnit]:
    if not data:
        return []
    br = BitReader(data)
    precision = br.u(3) + 1
    br.u(5)
    units = []
    pos = 1
    while pos + precision <= len(data):
        size = int.from_bytes(data[pos : pos + precision], "big")
        pos += precision
        units.append(V3CUnit.from_bytes(data[pos : pos + size]))
        pos += size
    return units


def split_gofs(units: list[V3CUnit]) -> list[list[V3CUnit]]:
    """Group a unit list into GOFs: each V3C_VPS starts a new group (the
    reference's per-GOF while(bMoreData) loop, PccAppTranscoder.cpp:307)."""
    gofs: list[list[V3CUnit]] = []
    for u in units:
        if u.header.unit_type == V3CUnitType.V3C_VPS or not gofs:
            gofs.append([])
        gofs[-1].append(u)
    return gofs
