"""NAL unit + sample-stream framing (23090-5 §8.2 / Annex D).

Parity with the reference's NalUnit / SampleStreamNalUnit / SampleStreamV3CUnit
(PccLibBitstreamCommon, SURVEY.md §2.2).
"""

from __future__ import annotations

import dataclasses

from ..utils.enums import NalUnitType
from .bitio import BitReader, BitWriter


@dataclasses.dataclass
class NalUnit:
    nal_unit_type: NalUnitType = NalUnitType.NAL_TRAIL_R
    nal_layer_id: int = 0
    nal_temporal_id_plus1: int = 1
    payload: bytes = b""

    def to_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, 0)  # nal_forbidden_zero_bit
        bw.u(6, int(self.nal_unit_type))
        bw.u(6, self.nal_layer_id)
        bw.u(3, self.nal_temporal_id_plus1)
        return bw.data() + self.payload

    @classmethod
    def from_bytes(cls, data: bytes) -> "NalUnit":
        br = BitReader(data)
        zero = br.u(1)
        if zero != 0:
            raise ValueError("forbidden_zero_bit set in NAL header")
        t = NalUnitType(br.u(6))
        layer = br.u(6)
        tid = br.u(3)
        return cls(t, layer, tid, data[2:])

    @property
    def is_irap(self) -> bool:
        """IRAP range per the reference's no-output-flag gate
        (PCCBitstreamReader.cpp:783: NAL_BLA_W_LP..NAL_RSV_IRAP_ACL_29)."""
        return (
            NalUnitType.NAL_BLA_W_LP
            <= self.nal_unit_type
            <= NalUnitType.NAL_RSV_IRAP_ACL_29
        )

    @property
    def is_acl(self) -> bool:
        """Atlas coding layer (tile-layer-carrying) NAL."""
        return self.nal_unit_type < NalUnitType.NAL_ASPS


def write_sample_stream_nal(nals: list[NalUnit]) -> bytes:
    """sample_stream_nal_header + length-prefixed NAL units."""
    payloads = [n.to_bytes() for n in nals]
    max_size = max((len(p) for p in payloads), default=1)
    precision = max(1, (max_size.bit_length() + 7) // 8)
    bw = BitWriter()
    bw.u(3, precision - 1)
    bw.u(5, 0)
    out = bytearray(bw.data())
    for p in payloads:
        out.extend(len(p).to_bytes(precision, "big"))
        out.extend(p)
    return bytes(out)


def read_sample_stream_nal(data: bytes) -> list[NalUnit]:
    br = BitReader(data)
    precision = br.u(3) + 1
    br.u(5)
    nals = []
    pos = 1
    while pos + precision <= len(data):
        size = int.from_bytes(data[pos : pos + precision], "big")
        pos += precision
        nals.append(NalUnit.from_bytes(data[pos : pos + size]))
        pos += size
    return nals
