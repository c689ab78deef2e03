"""SEI messages (23090-5 Annex F + raw passthrough).

The reference implements 25 SEI classes (PCCSei.h:43-1762); all are typed
here, including the HRD trio (BufferingPeriod, AtlasFrameTiming — whose bit
widths resolve against the active buffering period — and
SeiPrefixIndication).  Unknown payload types still pass through byte-exactly
as RawSei, which is what the live transcoder needs (SEIs it does not rewrite
must survive the remux unmodified); AtlasFrameTiming also falls back to
RawSei when no buffering period precedes it in the same rbsp.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field

from ..utils.enums import SeiPayloadType
from .bitio import BitReader, BitWriter


@dataclasses.dataclass
class Sei:
    payload_type: int = 0
    prefix: bool = True

    def payload_bytes(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def from_payload(cls, payload: bytes) -> "Sei":
        raise NotImplementedError


@dataclasses.dataclass
class RawSei(Sei):
    """Opaque payload passthrough for SEI types we do not interpret."""

    payload: bytes = b""

    def payload_bytes(self) -> bytes:
        return self.payload


@dataclasses.dataclass
class SeiBufferingPeriod(Sei):
    """bp_* — buffering period (F.2.13, PCCSei.h:761,
    PCCBitstreamReader.cpp:1906).  Self-contained: every variable bit width
    derives from its own length fields."""

    payload_type: int = SeiPayloadType.BUFFERING_PERIOD
    bp_nal_hrd_params_present_flag: bool = False
    bp_acl_hrd_params_present_flag: bool = False
    bp_initial_cab_removal_delay_length_minus1: int = 23
    bp_au_cab_removal_delay_length_minus1: int = 23
    bp_dab_output_delay_length_minus1: int = 23
    bp_irap_cab_params_present_flag: bool = False
    bp_cab_delay_offset: int = 0
    bp_dab_delay_offset: int = 0
    bp_concatenation_flag: bool = False
    bp_atlas_cab_removal_delay_delta_minus1: int = 0
    bp_max_sub_layers_minus1: int = 0
    # per sub-layer: hrd_cab_cnt_minus1 and the 4 delay/offset tables
    # indexed [sub_layer][cab]; alt tables only when irap params present
    bp_hrd_cab_cnt_minus1: list = field(default_factory=list)
    bp_nal_initial_cab_removal_delay: list = field(default_factory=list)
    bp_nal_initial_cab_removal_offset: list = field(default_factory=list)
    bp_nal_initial_alt_cab_removal_delay: list = field(default_factory=list)
    bp_nal_initial_alt_cab_removal_offset: list = field(default_factory=list)
    bp_acl_initial_cab_removal_delay: list = field(default_factory=list)
    bp_acl_initial_cab_removal_offset: list = field(default_factory=list)
    bp_acl_initial_alt_cab_removal_delay: list = field(default_factory=list)
    bp_acl_initial_alt_cab_removal_offset: list = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.bp_nal_hrd_params_present_flag)
        bw.u(1, self.bp_acl_hrd_params_present_flag)
        bw.u(5, self.bp_initial_cab_removal_delay_length_minus1)
        bw.u(5, self.bp_au_cab_removal_delay_length_minus1)
        bw.u(5, self.bp_dab_output_delay_length_minus1)
        bw.u(1, self.bp_irap_cab_params_present_flag)
        if self.bp_irap_cab_params_present_flag:
            bw.u(self.bp_au_cab_removal_delay_length_minus1 + 1,
                 self.bp_cab_delay_offset)
            bw.u(self.bp_dab_output_delay_length_minus1 + 1,
                 self.bp_dab_delay_offset)
        bw.u(1, self.bp_concatenation_flag)
        bw.u(self.bp_au_cab_removal_delay_length_minus1 + 1,
             self.bp_atlas_cab_removal_delay_delta_minus1)
        bw.u(3, self.bp_max_sub_layers_minus1)
        nbits = self.bp_initial_cab_removal_delay_length_minus1 + 1
        for i in range(self.bp_max_sub_layers_minus1 + 1):
            bw.u(3, self.bp_hrd_cab_cnt_minus1[i])
            if self.bp_nal_hrd_params_present_flag:
                for j in range(self.bp_hrd_cab_cnt_minus1[i] + 1):
                    bw.u(nbits, self.bp_nal_initial_cab_removal_delay[i][j])
                    bw.u(nbits, self.bp_nal_initial_cab_removal_offset[i][j])
                    if self.bp_irap_cab_params_present_flag:
                        bw.u(nbits,
                             self.bp_nal_initial_alt_cab_removal_delay[i][j])
                        bw.u(nbits,
                             self.bp_nal_initial_alt_cab_removal_offset[i][j])
            if self.bp_acl_hrd_params_present_flag:
                for j in range(self.bp_hrd_cab_cnt_minus1[i] + 1):
                    bw.u(nbits, self.bp_acl_initial_cab_removal_delay[i][j])
                    bw.u(nbits, self.bp_acl_initial_cab_removal_offset[i][j])
                    if self.bp_irap_cab_params_present_flag:
                        bw.u(nbits,
                             self.bp_acl_initial_alt_cab_removal_delay[i][j])
                        bw.u(nbits,
                             self.bp_acl_initial_alt_cab_removal_offset[i][j])
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiBufferingPeriod":
        br = BitReader(payload)
        s = cls()
        s.bp_nal_hrd_params_present_flag = bool(br.u(1))
        s.bp_acl_hrd_params_present_flag = bool(br.u(1))
        s.bp_initial_cab_removal_delay_length_minus1 = br.u(5)
        s.bp_au_cab_removal_delay_length_minus1 = br.u(5)
        s.bp_dab_output_delay_length_minus1 = br.u(5)
        s.bp_irap_cab_params_present_flag = bool(br.u(1))
        if s.bp_irap_cab_params_present_flag:
            s.bp_cab_delay_offset = br.u(
                s.bp_au_cab_removal_delay_length_minus1 + 1
            )
            s.bp_dab_delay_offset = br.u(
                s.bp_dab_output_delay_length_minus1 + 1
            )
        s.bp_concatenation_flag = bool(br.u(1))
        s.bp_atlas_cab_removal_delay_delta_minus1 = br.u(
            s.bp_au_cab_removal_delay_length_minus1 + 1
        )
        s.bp_max_sub_layers_minus1 = br.u(3)
        nbits = s.bp_initial_cab_removal_delay_length_minus1 + 1
        for i in range(s.bp_max_sub_layers_minus1 + 1):
            s.bp_hrd_cab_cnt_minus1.append(br.u(3))
            nd, no, nad, nao = [], [], [], []
            ad, ao, aad, aao = [], [], [], []
            if s.bp_nal_hrd_params_present_flag:
                for _ in range(s.bp_hrd_cab_cnt_minus1[i] + 1):
                    nd.append(br.u(nbits))
                    no.append(br.u(nbits))
                    if s.bp_irap_cab_params_present_flag:
                        nad.append(br.u(nbits))
                        nao.append(br.u(nbits))
            if s.bp_acl_hrd_params_present_flag:
                for _ in range(s.bp_hrd_cab_cnt_minus1[i] + 1):
                    ad.append(br.u(nbits))
                    ao.append(br.u(nbits))
                    if s.bp_irap_cab_params_present_flag:
                        aad.append(br.u(nbits))
                        aao.append(br.u(nbits))
            s.bp_nal_initial_cab_removal_delay.append(nd)
            s.bp_nal_initial_cab_removal_offset.append(no)
            s.bp_nal_initial_alt_cab_removal_delay.append(nad)
            s.bp_nal_initial_alt_cab_removal_offset.append(nao)
            s.bp_acl_initial_cab_removal_delay.append(ad)
            s.bp_acl_initial_cab_removal_offset.append(ao)
            s.bp_acl_initial_alt_cab_removal_delay.append(aad)
            s.bp_acl_initial_alt_cab_removal_offset.append(aao)
        return s


@dataclasses.dataclass
class SeiAtlasFrameTiming(Sei):
    """aft_* — atlas frame timing (F.2.14, PCCSei.h:901).  Bit widths come
    from the active SEIBufferingPeriod (the reference resolves it from its
    persistent SEI store, PCCBitstreamReader.cpp:1456-1459); read_sei_rbsp
    passes the last buffering period seen in the same rbsp and falls back to
    RawSei when none is available."""

    payload_type: int = SeiPayloadType.ATLAS_FRAME_TIMING
    aft_cab_removal_delay_minus1: list = field(default_factory=list)
    aft_dab_output_delay: list = field(default_factory=list)
    # widths captured from the active buffering period at parse/emit time
    au_cab_len: int = 24
    dab_len: int = 24

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        for d, o in zip(self.aft_cab_removal_delay_minus1,
                        self.aft_dab_output_delay):
            bw.u(self.au_cab_len, d)
            bw.u(self.dab_len, o)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(
        cls, payload: bytes, bp: "SeiBufferingPeriod | None" = None
    ) -> "Sei":
        if bp is None:
            return RawSei(
                payload_type=int(SeiPayloadType.ATLAS_FRAME_TIMING),
                payload=payload,
            )
        s = cls(
            au_cab_len=bp.bp_au_cab_removal_delay_length_minus1 + 1,
            dab_len=bp.bp_dab_output_delay_length_minus1 + 1,
        )
        br = BitReader(payload)
        per_layer_bytes = (s.au_cab_len + s.dab_len + 7) // 8
        for _ in range(bp.bp_max_sub_layers_minus1 + 1):
            if br.remaining() < per_layer_bytes:
                break  # cabDabDelaysPresentFlag=false emits no delays
            s.aft_cab_removal_delay_minus1.append(br.u(s.au_cab_len))
            s.aft_dab_output_delay.append(br.u(s.dab_len))
        return s


@dataclasses.dataclass
class SeiPrefixIndication(Sei):
    """spi_* — SEI prefix indication (F.2.12, PCCSei.h:195,
    PCCBitstreamReader.cpp:1602): essential leading bits of another SEI."""

    payload_type: int = SeiPayloadType.SEI_PREFIX_INDICATION
    spi_prefix_sei_payload_type: int = 0
    # list of bit lists; each indication byte-aligns with 1-bits
    spi_prefix_data_bits: list = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        if not self.spi_prefix_data_bits or any(
            not bits for bits in self.spi_prefix_data_bits
        ):
            # the syntax codes counts as minus1: zero indications / zero
            # bits are unrepresentable and would mis-parse on read
            raise ValueError(
                "SeiPrefixIndication needs >=1 indication of >=1 bit"
            )
        bw = BitWriter()
        bw.u(16, self.spi_prefix_sei_payload_type)
        bw.u(8, len(self.spi_prefix_data_bits) - 1)
        for bits in self.spi_prefix_data_bits:
            bw.u(16, len(bits) - 1)
            for b in bits:
                bw.u(1, b)
            while not bw.byte_aligned:
                bw.u(1, 1)  # f(1) alignment bits equal to 1
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiPrefixIndication":
        br = BitReader(payload)
        s = cls()
        s.spi_prefix_sei_payload_type = br.u(16)
        n = br.u(8) + 1
        for _ in range(n):
            nbits = br.u(16) + 1
            s.spi_prefix_data_bits.append([br.u(1) for _ in range(nbits)])
            br.byte_align()
        return s


@dataclasses.dataclass
class SeiDecodedAtlasInformationHash(Sei):
    """daih_* — decoded atlas information hash (conformance self-check)."""

    payload_type: int = SeiPayloadType.DECODED_ATLAS_INFORMATION_HASH
    daih_cancel_flag: bool = False
    daih_persistence_flag: bool = True
    daih_hash_type: int = 0  # 0 = MD5, 1 = CRC, 2 = checksum
    daih_decoded_high_level_hash_present_flag: bool = True
    daih_decoded_atlas_hash_present_flag: bool = True
    daih_decoded_atlas_b2p_hash_present_flag: bool = False
    daih_decoded_atlas_tiles_hash_present_flag: bool = False
    daih_decoded_atlas_tiles_b2p_hash_present_flag: bool = False
    high_level_md5: bytes = b"\x00" * 16
    atlas_md5: bytes = b"\x00" * 16
    b2p_md5: bytes = b"\x00" * 16
    # hash_type 1/2 carriers (u16 crc / u32 checksum)
    high_level_crc: int = 0
    high_level_checksum: int = 0
    atlas_crc: int = 0
    atlas_checksum: int = 0
    b2p_crc: int = 0
    b2p_checksum: int = 0
    # per-tile section (PCCBitstreamReader.cpp:2036-2051):
    # tile ids u(len_minus1+1), f(1)-aligned, then per tile the tiles /
    # tiles-b2p hashes.  tiles: [(tile_id, tiles_hash, tiles_b2p_hash)]
    # where each hash is bytes (md5) or int (crc/checksum) or None.
    daih_tile_id_len_minus1: int = 0
    tiles: list[tuple] = field(default_factory=list)

    def _write_hash(self, bw: BitWriter, md5: bytes, crc: int, cks: int):
        if self.daih_hash_type == 0:
            bw.string(md5, 16)
        elif self.daih_hash_type == 1:
            bw.u(16, crc)
        elif self.daih_hash_type == 2:
            bw.u(32, cks)

    def _read_hash(self, br: BitReader):
        if self.daih_hash_type == 0:
            return br.string(16)
        if self.daih_hash_type == 1:
            return br.u(16)
        if self.daih_hash_type == 2:
            return br.u(32)
        return None

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.daih_cancel_flag)
        if not self.daih_cancel_flag:
            bw.u(1, self.daih_persistence_flag)
            bw.u(8, self.daih_hash_type)
            bw.u(1, self.daih_decoded_high_level_hash_present_flag)
            bw.u(1, self.daih_decoded_atlas_hash_present_flag)
            bw.u(1, self.daih_decoded_atlas_b2p_hash_present_flag)
            bw.u(1, self.daih_decoded_atlas_tiles_hash_present_flag)
            bw.u(1, self.daih_decoded_atlas_tiles_b2p_hash_present_flag)
            bw.u(1, 0)  # reserved
            if self.daih_decoded_high_level_hash_present_flag:
                self._write_hash(bw, self.high_level_md5,
                                 self.high_level_crc, self.high_level_checksum)
            if self.daih_decoded_atlas_hash_present_flag:
                self._write_hash(bw, self.atlas_md5, self.atlas_crc,
                                 self.atlas_checksum)
            if self.daih_decoded_atlas_b2p_hash_present_flag:
                self._write_hash(bw, self.b2p_md5, self.b2p_crc,
                                 self.b2p_checksum)
            if (self.daih_decoded_atlas_tiles_hash_present_flag
                    or self.daih_decoded_atlas_tiles_b2p_hash_present_flag):
                bw.ue(len(self.tiles) - 1)
                bw.ue(self.daih_tile_id_len_minus1)
                for tid, _, _ in self.tiles:
                    bw.u(self.daih_tile_id_len_minus1 + 1, tid)
                while not bw.byte_aligned:
                    bw.u(1, 1)  # f(1) pad, only when unaligned
                for _, th, tbh in self.tiles:
                    if self.daih_decoded_atlas_tiles_hash_present_flag:
                        if self.daih_hash_type == 0:
                            bw.string(th, 16)
                        elif self.daih_hash_type == 1:
                            bw.u(16, th)
                        elif self.daih_hash_type == 2:
                            bw.u(32, th)
                    if self.daih_decoded_atlas_tiles_b2p_hash_present_flag:
                        if self.daih_hash_type == 0:
                            bw.string(tbh, 16)
                        elif self.daih_hash_type == 1:
                            bw.u(16, tbh)
                        elif self.daih_hash_type == 2:
                            bw.u(32, tbh)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiDecodedAtlasInformationHash":
        br = BitReader(payload)
        s = cls()
        s.daih_cancel_flag = bool(br.u(1))
        if not s.daih_cancel_flag:
            s.daih_persistence_flag = bool(br.u(1))
            s.daih_hash_type = br.u(8)
            s.daih_decoded_high_level_hash_present_flag = bool(br.u(1))
            s.daih_decoded_atlas_hash_present_flag = bool(br.u(1))
            s.daih_decoded_atlas_b2p_hash_present_flag = bool(br.u(1))
            s.daih_decoded_atlas_tiles_hash_present_flag = bool(br.u(1))
            s.daih_decoded_atlas_tiles_b2p_hash_present_flag = bool(br.u(1))
            br.u(1)
            if s.daih_decoded_high_level_hash_present_flag:
                v = s._read_hash(br)
                if s.daih_hash_type == 0:
                    s.high_level_md5 = v
                elif s.daih_hash_type == 1:
                    s.high_level_crc = v
                elif s.daih_hash_type == 2:
                    s.high_level_checksum = v
            if s.daih_decoded_atlas_hash_present_flag:
                v = s._read_hash(br)
                if s.daih_hash_type == 0:
                    s.atlas_md5 = v
                elif s.daih_hash_type == 1:
                    s.atlas_crc = v
                elif s.daih_hash_type == 2:
                    s.atlas_checksum = v
            if s.daih_decoded_atlas_b2p_hash_present_flag:
                v = s._read_hash(br)
                if s.daih_hash_type == 0:
                    s.b2p_md5 = v
                elif s.daih_hash_type == 1:
                    s.b2p_crc = v
                elif s.daih_hash_type == 2:
                    s.b2p_checksum = v
            if (s.daih_decoded_atlas_tiles_hash_present_flag
                    or s.daih_decoded_atlas_tiles_b2p_hash_present_flag):
                num_tiles = br.ue() + 1
                s.daih_tile_id_len_minus1 = br.ue()
                tids = [
                    br.u(s.daih_tile_id_len_minus1 + 1)
                    for _ in range(num_tiles)
                ]
                br.byte_align()
                for tid in tids:
                    th = tbh = None
                    if s.daih_decoded_atlas_tiles_hash_present_flag:
                        th = s._read_hash(br)
                    if s.daih_decoded_atlas_tiles_b2p_hash_present_flag:
                        tbh = s._read_hash(br)
                    s.tiles.append((tid, th, tbh))
        return s


@dataclasses.dataclass
class SeiComponentCodecMapping(Sei):
    """ccm_* — maps codec indices used in the VPS to 4CC codes.  The
    transcoder rewrites this when it changes the video codec
    (PCCTranscoder.cpp:2110-2243 concept)."""

    payload_type: int = SeiPayloadType.COMPONENT_CODEC_MAPPING
    ccm_component_codec_cancel_flag: bool = False
    ccm_codec_mappings_count_minus1: int = 0
    ccm_codec_id: list[int] = field(default_factory=lambda: [0])
    ccm_codec_4cc: list[str] = field(default_factory=lambda: ["rbv1"])

    def payload_bytes(self) -> bytes:
        """Field layout per the reference parser: cancel u(1); then count
        u(8) + per-mapping codec id u(8) and 4CC as a NUL-terminated st(v)
        string (PCCBitstreamReader.cpp:1654-1666)."""
        bw = BitWriter()
        bw.u(1, self.ccm_component_codec_cancel_flag)
        if not self.ccm_component_codec_cancel_flag:
            bw.u(8, self.ccm_codec_mappings_count_minus1)
            for i in range(self.ccm_codec_mappings_count_minus1 + 1):
                bw.u(8, self.ccm_codec_id[i])
                bw.st(self.ccm_codec_4cc[i].encode("ascii")[:4])
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiComponentCodecMapping":
        br = BitReader(payload)
        s = cls(ccm_codec_id=[], ccm_codec_4cc=[])
        s.ccm_component_codec_cancel_flag = bool(br.u(1))
        if s.ccm_component_codec_cancel_flag:
            return s
        s.ccm_codec_mappings_count_minus1 = br.u(8)
        for _ in range(s.ccm_codec_mappings_count_minus1 + 1):
            s.ccm_codec_id.append(br.u(8))
            s.ccm_codec_4cc.append(br.st().decode("ascii"))
        return s


@dataclasses.dataclass
class SeiGeometrySmoothing(Sei):
    """gs_* — decoder-side geometry smoothing parameters (grid smoothing).

    Bit layout per PCCBitstreamReader.cpp:2206-2226: persistence u(1),
    reset u(1), instances_updated u(8); per instance: index u(8),
    cancel u(1), then (when not cancelled) method ue(v) and — for the grid
    method — filter_eom u(1), grid_size_minus2 u(7), threshold u(8).
    The scalar fields carry instance 0 (the only instance this framework
    emits); extra parsed instances round-trip via gs_extra_instances."""

    payload_type: int = SeiPayloadType.GEOMETRY_SMOOTHING
    gs_smoothing_persistence_flag: bool = True
    gs_smoothing_reset_flag: bool = False
    gs_smoothing_instances_updated: int = 1
    gs_smoothing_instance_index: int = 0
    gs_smoothing_instance_cancel_flag: bool = False
    gs_smoothing_method_type: int = 1  # 1 = grid smoothing
    gs_smoothing_filter_eom_points_flag: bool = False
    gs_smoothing_grid_size_minus2: int = 6
    gs_smoothing_threshold: int = 64
    # instances beyond the first: (index, cancel, method, filter_eom,
    # grid_size_minus2, threshold)
    gs_extra_instances: list[tuple] = field(default_factory=list)

    def _instances(self) -> list[tuple]:
        first = (
            self.gs_smoothing_instance_index,
            self.gs_smoothing_instance_cancel_flag,
            self.gs_smoothing_method_type,
            self.gs_smoothing_filter_eom_points_flag,
            self.gs_smoothing_grid_size_minus2,
            self.gs_smoothing_threshold,
        )
        return [first] + list(self.gs_extra_instances)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.gs_smoothing_persistence_flag)
        bw.u(1, self.gs_smoothing_reset_flag)
        insts = self._instances()[: max(1, self.gs_smoothing_instances_updated)]
        bw.u(8, len(insts))
        for idx, cancel, method, eom, grid, thr in insts:
            bw.u(8, idx)
            bw.u(1, cancel)
            if not cancel:
                bw.ue(method)
                if method == 1:
                    bw.u(1, eom)
                    bw.u(7, grid)
                    bw.u(8, thr)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiGeometrySmoothing":
        br = BitReader(payload)
        s = cls()
        s.gs_smoothing_persistence_flag = bool(br.u(1))
        s.gs_smoothing_reset_flag = bool(br.u(1))
        s.gs_smoothing_instances_updated = br.u(8)
        for i in range(s.gs_smoothing_instances_updated):
            idx = br.u(8)
            cancel = bool(br.u(1))
            method, eom, grid, thr = 0, False, 6, 64
            if not cancel:
                method = br.ue()
                if method == 1:
                    eom = bool(br.u(1))
                    grid = br.u(7)
                    thr = br.u(8)
            if i == 0:
                s.gs_smoothing_instance_index = idx
                s.gs_smoothing_instance_cancel_flag = cancel
                s.gs_smoothing_method_type = method
                s.gs_smoothing_filter_eom_points_flag = eom
                s.gs_smoothing_grid_size_minus2 = grid
                s.gs_smoothing_threshold = thr
            else:
                s.gs_extra_instances.append(
                    (idx, cancel, method, eom, grid, thr)
                )
        return s


@dataclasses.dataclass
class SeiAttributeSmoothing(Sei):
    """as_* — decoder-side attribute (color) smoothing parameters."""

    payload_type: int = SeiPayloadType.ATTRIBUTE_SMOOTHING
    as_smoothing_persistence_flag: bool = True
    as_smoothing_reset_flag: bool = False
    as_attribute_idx: int = 0
    as_attribute_smoothing_cancel_flag: bool = False
    as_instance_index: int = 0
    as_instance_cancel_flag: bool = False
    as_method_type: int = 1
    as_filter_eom_points_flag: bool = False
    as_smoothing_grid_size_minus2: int = 6
    as_smoothing_threshold: int = 64
    as_smoothing_threshold_variation: int = 255
    as_smoothing_threshold_difference: int = 255
    # attribute/instance updates beyond (attr 0, instance 0):
    # (attr_idx, attr_cancel, [(inst_idx, inst_cancel, method, eom, grid,
    #   threshold, variation, difference) ...])
    as_extra_attributes: list[tuple] = field(default_factory=list)
    # further instances of the FIRST attribute update (byte-exact re-emit)
    as_extra_instances0: list[tuple] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        """Layout per PCCBitstreamReader.cpp:2229-2259: persistence u(1),
        reset u(1), num_attributes ue(v); per attribute: idx u(7),
        cancel u(1), instances u(8); per instance: index u(8), cancel u(1),
        then method ue(v) and (when nonzero) filter_eom u(1), grid u(5),
        threshold u(8), variation u(8), difference u(8)."""
        bw = BitWriter()
        bw.u(1, self.as_smoothing_persistence_flag)
        bw.u(1, self.as_smoothing_reset_flag)
        first_insts = [(
            self.as_instance_index,
            self.as_instance_cancel_flag,
            self.as_method_type,
            self.as_filter_eom_points_flag,
            self.as_smoothing_grid_size_minus2,
            self.as_smoothing_threshold,
            self.as_smoothing_threshold_variation,
            self.as_smoothing_threshold_difference,
        )] + list(self.as_extra_instances0)
        attrs = [
            (self.as_attribute_idx, self.as_attribute_smoothing_cancel_flag,
             first_insts)
        ] + list(self.as_extra_attributes)
        bw.ue(len(attrs))
        for attr_idx, attr_cancel, insts in attrs:
            bw.u(7, attr_idx)
            bw.u(1, attr_cancel)
            bw.u(8, len(insts))
            for idx, cancel, method, eom, grid, thr, var, diff in insts:
                bw.u(8, idx)
                bw.u(1, cancel)
                if not cancel:
                    bw.ue(method)
                    if method:
                        bw.u(1, eom)
                        bw.u(5, grid)
                        bw.u(8, thr)
                        bw.u(8, var)
                        bw.u(8, diff)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiAttributeSmoothing":
        br = BitReader(payload)
        s = cls()
        s.as_smoothing_persistence_flag = bool(br.u(1))
        s.as_smoothing_reset_flag = bool(br.u(1))
        n_attr = br.ue()
        for j in range(n_attr):
            attr_idx = br.u(7)
            attr_cancel = bool(br.u(1))
            n_inst = br.u(8)
            insts = []
            for _ in range(n_inst):
                idx = br.u(8)
                cancel = bool(br.u(1))
                method, eom, grid, thr, var, diff = 0, False, 6, 64, 255, 255
                if not cancel:
                    method = br.ue()
                    if method:
                        eom = bool(br.u(1))
                        grid = br.u(5)
                        thr = br.u(8)
                        var = br.u(8)
                        diff = br.u(8)
                insts.append((idx, cancel, method, eom, grid, thr, var, diff))
            if j == 0 and insts:
                (s.as_instance_index, s.as_instance_cancel_flag,
                 s.as_method_type, s.as_filter_eom_points_flag,
                 s.as_smoothing_grid_size_minus2, s.as_smoothing_threshold,
                 s.as_smoothing_threshold_variation,
                 s.as_smoothing_threshold_difference) = insts[0]
                s.as_attribute_idx = attr_idx
                s.as_attribute_smoothing_cancel_flag = attr_cancel
                s.as_extra_instances0 = insts[1:]
            else:
                s.as_extra_attributes.append((attr_idx, attr_cancel, insts))
        return s


@dataclasses.dataclass
class SeiOccupancySynthesis(Sei):
    """os_* — occupancy synthesis (PBF) parameters."""

    payload_type: int = SeiPayloadType.OCCUPANCY_SYNTHESIS
    os_persistence_flag: bool = True
    os_reset_flag: bool = False
    os_instances_updated: int = 1
    os_instance_index: int = 0
    os_instance_cancel_flag: bool = False
    os_method_type: int = 1
    os_pbf_log2_threshold_minus1: int = 1
    os_pbf_passes_count_minus1: int = 1
    os_pbf_filter_size_minus1: int = 2
    # (index, cancel, method, log2_thr_m1, passes_m1, size_m1)
    os_extra_instances: list[tuple] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        """Layout per PCCBitstreamReader.cpp:2183-2203: persistence u(1),
        reset u(1), instances u(8); per instance: index u(8), cancel u(1),
        then method ue(v) and for PBF u(2)+u(2)+u(3)."""
        bw = BitWriter()
        bw.u(1, self.os_persistence_flag)
        bw.u(1, self.os_reset_flag)
        insts = [(
            self.os_instance_index, self.os_instance_cancel_flag,
            self.os_method_type, self.os_pbf_log2_threshold_minus1,
            self.os_pbf_passes_count_minus1, self.os_pbf_filter_size_minus1,
        )] + list(self.os_extra_instances)
        bw.u(8, len(insts))
        for idx, cancel, method, thr, passes, size in insts:
            bw.u(8, idx)
            bw.u(1, cancel)
            if not cancel:
                bw.ue(method)
                if method == 1:
                    bw.u(2, thr)
                    bw.u(2, passes)
                    bw.u(3, size)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiOccupancySynthesis":
        br = BitReader(payload)
        s = cls()
        s.os_persistence_flag = bool(br.u(1))
        s.os_reset_flag = bool(br.u(1))
        s.os_instances_updated = br.u(8)
        for i in range(s.os_instances_updated):
            idx = br.u(8)
            cancel = bool(br.u(1))
            method, thr, passes, size = 0, 1, 1, 2
            if not cancel:
                method = br.ue()
                if method == 1:
                    thr = br.u(2)
                    passes = br.u(2)
                    size = br.u(3)
            if i == 0:
                s.os_instance_index = idx
                s.os_instance_cancel_flag = cancel
                s.os_method_type = method
                s.os_pbf_log2_threshold_minus1 = thr
                s.os_pbf_passes_count_minus1 = passes
                s.os_pbf_filter_size_minus1 = size
            else:
                s.os_extra_instances.append(
                    (idx, cancel, method, thr, passes, size)
                )
        return s


@dataclasses.dataclass
class SeiUserDataUnregistered(Sei):
    payload_type: int = SeiPayloadType.USER_DATA_UNREGISTERED
    uuid: bytes = b"\x00" * 16
    user_data: bytes = b""

    def payload_bytes(self) -> bytes:
        return self.uuid + self.user_data

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiUserDataUnregistered":
        return cls(uuid=payload[:16], user_data=payload[16:])


@dataclasses.dataclass
class SeiFillerPayload(Sei):
    """filler_payload (23090-5 F.2.5): ff_byte run, discarded semantics."""
    payload_type: int = SeiPayloadType.FILLER_PAYLOAD
    size: int = 0

    def payload_bytes(self) -> bytes:
        return b"\xff" * self.size

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiFillerPayload":
        return cls(size=len(payload))


@dataclasses.dataclass
class SeiUserDataRegisteredItuTT35(Sei):
    """user_data_registered_itu_t_t35 (23090-5 F.2.6)."""
    payload_type: int = SeiPayloadType.USER_DATA_REGISTERED_ITUTT35
    country_code: int = 0xB5
    country_code_extension: int = 0      # only coded when country_code==0xFF
    user_data: bytes = b""

    def payload_bytes(self) -> bytes:
        head = bytes([self.country_code])
        if self.country_code == 0xFF:
            head += bytes([self.country_code_extension])
        return head + self.user_data

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiUserDataRegisteredItuTT35":
        cc = payload[0] if payload else 0
        if cc == 0xFF:
            return cls(country_code=cc, country_code_extension=payload[1],
                       user_data=payload[2:])
        return cls(country_code=cc, user_data=payload[1:])


@dataclasses.dataclass
class SeiAtlasObjectInformation(Sei):
    """atlas_object_information / aoi (23090-5 F.2.13): which tracked
    objects appear in which atlases."""
    payload_type: int = SeiPayloadType.ATLAS_OBJECT_INFORMATION
    aoi_persistence_flag: bool = False
    aoi_reset_flag: bool = False
    aoi_num_atlases_minus1: int = 0
    # coded in 5 bits as the bit-width used directly
    # (PCCBitstreamReader.cpp:1883-1903)
    aoi_log2_max_object_idx_tracked: int = 1
    aoi_atlas_id: list[int] = dataclasses.field(default_factory=list)
    # [(object_idx, [present_in_atlas_j ...])] — the reference codes
    # NumUpdates and then loops NumUpdates+1 times on BOTH sides, so the
    # coded count is len(updates)-1 and a single update is unrepresentable.
    updates: list = dataclasses.field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.aoi_persistence_flag)
        bw.u(1, self.aoi_reset_flag)
        bw.u(6, self.aoi_num_atlases_minus1)
        if len(self.updates) == 1:
            raise ValueError(
                "coded update count is len(updates)-1 with an inclusive "
                "loop; exactly one update is unrepresentable"
            )
        bw.ue(max(0, len(self.updates) - 1))
        if len(self.updates) - 1 > 0:
            bw.u(5, self.aoi_log2_max_object_idx_tracked)
            for j in range(self.aoi_num_atlases_minus1 + 1):
                aid = (
                    self.aoi_atlas_id[j]
                    if j < len(self.aoi_atlas_id)
                    else j
                )
                bw.u(5, aid)
            for obj_idx, present in self.updates:
                bw.u(self.aoi_log2_max_object_idx_tracked, obj_idx)
                for j in range(self.aoi_num_atlases_minus1 + 1):
                    bw.u(1, bool(present[j]))
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiAtlasObjectInformation":
        br = BitReader(payload)
        s = cls(
            aoi_persistence_flag=bool(br.u(1)),
            aoi_reset_flag=bool(br.u(1)),
            aoi_num_atlases_minus1=br.u(6),
        )
        n = br.ue()
        if n:
            s.aoi_log2_max_object_idx_tracked = br.u(5)
            for _ in range(s.aoi_num_atlases_minus1 + 1):
                s.aoi_atlas_id.append(br.u(5))
            for _ in range(n + 1):
                obj_idx = br.u(s.aoi_log2_max_object_idx_tracked)
                present = [
                    bool(br.u(1))
                    for _ in range(s.aoi_num_atlases_minus1 + 1)
                ]
                s.updates.append((obj_idx, present))
        return s


@dataclasses.dataclass
class SeiPatchInformation(Sei):
    """patch_information / pi (23090-5 F.2.15): per-tile patch->object
    associations.  tiles: [(tile_id, cancel_flag, [(patch_idx, cancel,
    [object_idx ...]) ...]) ...]."""
    payload_type: int = SeiPayloadType.PATCH_INFORMATION
    pi_persistence_flag: bool = False
    pi_reset_flag: bool = False
    # u(5)/u(4) values used DIRECTLY as bit counts
    # (PCCBitstreamReader.cpp:1821-1847 reads u(log2MaxPatchIdxUpdated))
    pi_log2_max_object_idx_tracked: int = 1
    pi_log2_max_patch_idx_updated: int = 1
    tiles: list = dataclasses.field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.pi_persistence_flag)
        bw.u(1, self.pi_reset_flag)
        bw.ue(len(self.tiles))
        if self.tiles:
            bw.u(5, self.pi_log2_max_object_idx_tracked)
            bw.u(4, self.pi_log2_max_patch_idx_updated)
            obits = self.pi_log2_max_object_idx_tracked
            pbits = self.pi_log2_max_patch_idx_updated
            for tile_id, tile_cancel, patches in self.tiles:
                bw.ue(tile_id)
                bw.u(1, bool(tile_cancel))
                bw.ue(len(patches))
                for patch_idx, cancel, objects in patches:
                    bw.u(pbits, patch_idx)
                    bw.u(1, bool(cancel))
                    if not cancel:
                        bw.ue(len(objects) - 1)
                        for o in objects:
                            bw.u(obits, o)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiPatchInformation":
        br = BitReader(payload)
        s = cls(
            pi_persistence_flag=bool(br.u(1)),
            pi_reset_flag=bool(br.u(1)),
        )
        n_tiles = br.ue()
        if n_tiles:
            s.pi_log2_max_object_idx_tracked = br.u(5)
            s.pi_log2_max_patch_idx_updated = br.u(4)
            obits = s.pi_log2_max_object_idx_tracked
            pbits = s.pi_log2_max_patch_idx_updated
            for _ in range(n_tiles):
                tile_id = br.ue()
                tile_cancel = bool(br.u(1))
                patches = []
                for _ in range(br.ue()):
                    patch_idx = br.u(pbits)
                    cancel = bool(br.u(1))
                    objects = []
                    if not cancel:
                        objects = [br.u(obits) for _ in range(br.ue() + 1)]
                    patches.append((patch_idx, cancel, objects))
                s.tiles.append((tile_id, tile_cancel, patches))
        return s


@dataclasses.dataclass
class SeiRecoveryPoint(Sei):
    payload_type: int = SeiPayloadType.RECOVERY_POINT
    rp_recovery_afoc_cnt: int = 0
    rp_exact_match_flag: bool = True
    rp_broken_link_flag: bool = False

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.se(self.rp_recovery_afoc_cnt)
        bw.u(1, self.rp_exact_match_flag)
        bw.u(1, self.rp_broken_link_flag)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiRecoveryPoint":
        br = BitReader(payload)
        return cls(
            rp_recovery_afoc_cnt=br.se(),
            rp_exact_match_flag=bool(br.u(1)),
            rp_broken_link_flag=bool(br.u(1)),
        )


@dataclasses.dataclass
class SeiNoReconstruction(Sei):
    payload_type: int = SeiPayloadType.NO_RECONSTRUCTION

    def payload_bytes(self) -> bytes:
        return b""

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiNoReconstruction":
        return cls()


@dataclasses.dataclass
class SeiTimeCode(Sei):
    """Layout per PCCBitstreamReader.cpp:2121-2152 (F.2.17)."""

    payload_type: int = SeiPayloadType.TIME_CODE
    tc_num_units_in_tick: int = 1
    tc_time_scale: int = 30
    tc_counting_type: int = 0
    tc_full_timestamp_flag: bool = True
    tc_discontinuity_flag: bool = False
    tc_cnt_dropped_flag: bool = False
    tc_n_frames: int = 0
    tc_seconds_flag: bool = False
    tc_minutes_flag: bool = False
    tc_hours_flag: bool = False
    tc_seconds: int = 0
    tc_minutes: int = 0
    tc_hours: int = 0
    tc_time_offset_length: int = 0
    tc_time_offset_value: int = 0

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(32, self.tc_num_units_in_tick)
        bw.u(32, self.tc_time_scale)
        bw.u(5, self.tc_counting_type)
        bw.u(1, self.tc_full_timestamp_flag)
        bw.u(1, self.tc_discontinuity_flag)
        bw.u(1, self.tc_cnt_dropped_flag)
        bw.u(9, self.tc_n_frames)
        if self.tc_full_timestamp_flag:
            bw.u(6, self.tc_seconds)
            bw.u(6, self.tc_minutes)
            bw.u(5, self.tc_hours)
        else:
            bw.u(1, self.tc_seconds_flag)
            if self.tc_seconds_flag:
                bw.u(6, self.tc_seconds)
                bw.u(1, self.tc_minutes_flag)
                if self.tc_minutes_flag:
                    bw.u(6, self.tc_minutes)
                    bw.u(1, self.tc_hours_flag)
                    if self.tc_hours_flag:
                        bw.u(5, self.tc_hours)
        bw.u(5, self.tc_time_offset_length)
        if self.tc_time_offset_length > 0:
            mask = (1 << self.tc_time_offset_length) - 1
            bw.u(self.tc_time_offset_length, self.tc_time_offset_value & mask)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiTimeCode":
        br = BitReader(payload)
        s = cls()
        s.tc_num_units_in_tick = br.u(32)
        s.tc_time_scale = br.u(32)
        s.tc_counting_type = br.u(5)
        s.tc_full_timestamp_flag = bool(br.u(1))
        s.tc_discontinuity_flag = bool(br.u(1))
        s.tc_cnt_dropped_flag = bool(br.u(1))
        s.tc_n_frames = br.u(9)
        if s.tc_full_timestamp_flag:
            s.tc_seconds = br.u(6)
            s.tc_minutes = br.u(6)
            s.tc_hours = br.u(5)
        else:
            s.tc_seconds_flag = bool(br.u(1))
            if s.tc_seconds_flag:
                s.tc_seconds = br.u(6)
                s.tc_minutes_flag = bool(br.u(1))
                if s.tc_minutes_flag:
                    s.tc_minutes = br.u(6)
                    s.tc_hours_flag = bool(br.u(1))
                    if s.tc_hours_flag:
                        s.tc_hours = br.u(5)
        s.tc_time_offset_length = br.u(5)
        if s.tc_time_offset_length > 0:
            v = br.u(s.tc_time_offset_length)
            sign_bit = 1 << (s.tc_time_offset_length - 1)
            s.tc_time_offset_value = (v ^ sign_bit) - sign_bit  # i(v)
        return s


@dataclasses.dataclass
class SeiActiveSubBitstreams(Sei):
    payload_type: int = SeiPayloadType.ACTIVE_SUB_BITSTREAMS
    asb_cancel_flag: bool = False
    asb_active_attributes_changes_flag: bool = False
    asb_active_maps_changes_flag: bool = False
    asb_auxiliary_substreams_active_flag: bool = False
    asb_all_attributes_active_flag: bool = True
    asb_all_maps_active_flag: bool = True
    asb_active_attribute_idx: list[int] = field(default_factory=list)
    asb_active_map_idx: list[int] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        """Layout per PCCBitstreamReader.cpp:1623-1651: cancel u(1); the
        changes flags; per-change an all-active flag, else count_minus1 +
        indices."""
        bw = BitWriter()
        bw.u(1, self.asb_cancel_flag)
        if not self.asb_cancel_flag:
            bw.u(1, self.asb_active_attributes_changes_flag)
            bw.u(1, self.asb_active_maps_changes_flag)
            bw.u(1, self.asb_auxiliary_substreams_active_flag)
            if self.asb_active_attributes_changes_flag:
                bw.u(1, self.asb_all_attributes_active_flag)
                if not self.asb_all_attributes_active_flag:
                    bw.u(7, len(self.asb_active_attribute_idx) - 1)
                    for i in self.asb_active_attribute_idx:
                        bw.u(7, i)
            if self.asb_active_maps_changes_flag:
                bw.u(1, self.asb_all_maps_active_flag)
                if not self.asb_all_maps_active_flag:
                    bw.u(4, len(self.asb_active_map_idx) - 1)
                    for i in self.asb_active_map_idx:
                        bw.u(4, i)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiActiveSubBitstreams":
        br = BitReader(payload)
        s = cls()
        s.asb_cancel_flag = bool(br.u(1))
        if s.asb_cancel_flag:
            return s
        s.asb_active_attributes_changes_flag = bool(br.u(1))
        s.asb_active_maps_changes_flag = bool(br.u(1))
        s.asb_auxiliary_substreams_active_flag = bool(br.u(1))
        if s.asb_active_attributes_changes_flag:
            s.asb_all_attributes_active_flag = bool(br.u(1))
            if not s.asb_all_attributes_active_flag:
                n = br.u(7) + 1
                s.asb_active_attribute_idx = [br.u(7) for _ in range(n)]
        if s.asb_active_maps_changes_flag:
            s.asb_all_maps_active_flag = bool(br.u(1))
            if not s.asb_all_maps_active_flag:
                n = br.u(4) + 1
                s.asb_active_map_idx = [br.u(4) for _ in range(n)]
        return s


@dataclasses.dataclass
class SeiObjectLabelInformation(Sei):
    """Layout per PCCBitstreamReader.cpp:1792-1818 (F.2.12.2): labels are
    st(v) NUL-terminated strings with f(1) alignment, each update carries a
    per-label cancel flag, and the persistence flag trails the updates."""

    payload_type: int = SeiPayloadType.OBJECT_LABEL_INFORMATION
    oli_cancel_flag: bool = False
    oli_label_language_present_flag: bool = False
    oli_label_language: str = ""
    oli_persistence_flag: bool = False
    # (label_idx, label_cancel, label)
    oli_labels: list[tuple[int, bool, str]] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.oli_cancel_flag)
        if not self.oli_cancel_flag:
            bw.u(1, self.oli_label_language_present_flag)
            if self.oli_label_language_present_flag:
                bw.st(self.oli_label_language.encode("utf-8"))
            bw.ue(len(self.oli_labels))
            for idx, cancel, label in self.oli_labels:
                bw.ue(idx)
                bw.u(1, cancel)
                if not cancel:
                    bw.st(label.encode("utf-8"))
            bw.u(1, self.oli_persistence_flag)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiObjectLabelInformation":
        br = BitReader(payload)
        s = cls()
        s.oli_cancel_flag = bool(br.u(1))
        if not s.oli_cancel_flag:
            s.oli_label_language_present_flag = bool(br.u(1))
            if s.oli_label_language_present_flag:
                s.oli_label_language = br.st().decode("utf-8")
            n = br.ue()
            for _ in range(n):
                idx = br.ue()
                cancel = bool(br.u(1))
                label = "" if cancel else br.st().decode("utf-8")
                s.oli_labels.append((idx, cancel, label))
            s.oli_persistence_flag = bool(br.u(1))
        return s


@dataclasses.dataclass
class SeiVolumetricRectangleInformation(Sei):
    """Layout per PCCBitstreamReader.cpp:1850-1880 (F.2.12.4)."""

    payload_type: int = SeiPayloadType.VOLUMETRIC_RECTANGLE_INFORMATION
    vri_persistence_flag: bool = False
    vri_reset_flag: bool = False
    vri_log2_max_object_idx_tracked: int = 1
    vri_log2_max_rectangle_idx_updated: int = 1
    # (rect_idx, cancel, bbox_update, (top, left, width, height) | None,
    #  [object_idx ...])
    rectangles: list[tuple] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.vri_persistence_flag)
        bw.u(1, self.vri_reset_flag)
        bw.ue(len(self.rectangles))
        if self.rectangles:
            bw.u(5, self.vri_log2_max_object_idx_tracked)
            bw.u(4, self.vri_log2_max_rectangle_idx_updated)
        for rid, cancel, bbox_update, bbox, objects in self.rectangles:
            bw.u(self.vri_log2_max_rectangle_idx_updated, rid)
            bw.u(1, cancel)
            if not cancel:
                bw.u(1, bbox_update)
                if bbox_update:
                    top, left, width, height = bbox
                    bw.ue(top)
                    bw.ue(left)
                    bw.ue(width)
                    bw.ue(height)
                bw.ue(len(objects) - 1)
                for o in objects:
                    bw.u(self.vri_log2_max_object_idx_tracked, o)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiVolumetricRectangleInformation":
        br = BitReader(payload)
        s = cls()
        s.vri_persistence_flag = bool(br.u(1))
        s.vri_reset_flag = bool(br.u(1))
        n = br.ue()
        if n:
            s.vri_log2_max_object_idx_tracked = br.u(5)
            s.vri_log2_max_rectangle_idx_updated = br.u(4)
        for _ in range(n):
            rid = br.u(s.vri_log2_max_rectangle_idx_updated)
            cancel = bool(br.u(1))
            bbox_update, bbox, objects = False, None, []
            if not cancel:
                bbox_update = bool(br.u(1))
                if bbox_update:
                    bbox = (br.ue(), br.ue(), br.ue(), br.ue())
                objects = [
                    br.u(s.vri_log2_max_object_idx_tracked)
                    for _ in range(br.ue() + 1)
                ]
            s.rectangles.append((rid, cancel, bbox_update, bbox, objects))
        return s


@dataclasses.dataclass
class SeiViewportCameraParameters(Sei):
    """Layout per PCCBitstreamReader.cpp:1967-1990 (F.2.15.1).  fl(32)
    values are carried as raw IEEE-754 bit patterns (u32)."""

    payload_type: int = SeiPayloadType.VIEWPORT_CAMERA_PARAMETERS
    vcp_camera_id: int = 1
    vcp_cancel_flag: bool = False
    vcp_persistence_flag: bool = True
    vcp_camera_type: int = 0       # 0 equirect, 1 perspective, 2 ortho
    vcp_erp_horizontal_fov: int = 0     # u(32)
    vcp_erp_vertical_fov: int = 0       # u(32)
    vcp_perspective_aspect_ratio: int = 0x3F800000   # fl(32) bits
    vcp_perspective_horizontal_fov: int = 0          # u(32)
    vcp_ortho_aspect_ratio: int = 0x3F800000         # fl(32) bits
    vcp_ortho_horizontal_size: int = 0x3F800000      # fl(32) bits
    vcp_clipping_near_plane: int = 0x3DCCCCCD        # fl(32) bits
    vcp_clipping_far_plane: int = 0x447A0000         # fl(32) bits

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(10, self.vcp_camera_id)
        bw.u(1, self.vcp_cancel_flag)
        if self.vcp_camera_id > 0 and not self.vcp_cancel_flag:
            bw.u(1, self.vcp_persistence_flag)
            bw.u(3, self.vcp_camera_type)
            if self.vcp_camera_type == 0:
                bw.u(32, self.vcp_erp_horizontal_fov)
                bw.u(32, self.vcp_erp_vertical_fov)
            elif self.vcp_camera_type == 1:
                bw.u(32, self.vcp_perspective_aspect_ratio)
                bw.u(32, self.vcp_perspective_horizontal_fov)
            elif self.vcp_camera_type == 2:
                bw.u(32, self.vcp_ortho_aspect_ratio)
                bw.u(32, self.vcp_ortho_horizontal_size)
            bw.u(32, self.vcp_clipping_near_plane)
            bw.u(32, self.vcp_clipping_far_plane)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiViewportCameraParameters":
        br = BitReader(payload)
        s = cls()
        s.vcp_camera_id = br.u(10)
        s.vcp_cancel_flag = bool(br.u(1))
        if s.vcp_camera_id > 0 and not s.vcp_cancel_flag:
            s.vcp_persistence_flag = bool(br.u(1))
            s.vcp_camera_type = br.u(3)
            if s.vcp_camera_type == 0:
                s.vcp_erp_horizontal_fov = br.u(32)
                s.vcp_erp_vertical_fov = br.u(32)
            elif s.vcp_camera_type == 1:
                s.vcp_perspective_aspect_ratio = br.u(32)
                s.vcp_perspective_horizontal_fov = br.u(32)
            elif s.vcp_camera_type == 2:
                s.vcp_ortho_aspect_ratio = br.u(32)
                s.vcp_ortho_horizontal_size = br.u(32)
            s.vcp_clipping_near_plane = br.u(32)
            s.vcp_clipping_far_plane = br.u(32)
        return s


@dataclasses.dataclass
class SeiViewportPosition(Sei):
    """Layout per PCCBitstreamReader.cpp:1993-2016 (F.2.15.2): position
    components are fl(32) bit patterns, rotation is i(16) quaternion parts."""

    payload_type: int = SeiPayloadType.VIEWPORT_POSITION
    vp_viewport_id: int = 0
    vp_camera_parameters_present_flag: bool = False
    vp_camera_id: int = 0
    vp_cancel_flag: bool = False
    vp_persistence_flag: bool = True
    vp_position: tuple[int, int, int] = (0, 0, 0)   # fl(32) bits each
    vp_rotation_qxyz: tuple[int, int, int] = (0, 0, 0)   # i(16) each
    vp_center_view_flag: bool = True
    vp_left_view_flag: bool = False

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.ue(self.vp_viewport_id)
        bw.u(1, self.vp_camera_parameters_present_flag)
        if self.vp_camera_parameters_present_flag:
            bw.u(10, self.vp_camera_id)
        bw.u(1, self.vp_cancel_flag)
        if not self.vp_cancel_flag:
            bw.u(1, self.vp_persistence_flag)
            for c in self.vp_position:
                bw.u(32, c & 0xFFFFFFFF)
            for c in self.vp_rotation_qxyz:
                bw.u(16, c & 0xFFFF)
            bw.u(1, self.vp_center_view_flag)
            if not self.vp_center_view_flag:
                bw.u(1, self.vp_left_view_flag)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiViewportPosition":
        br = BitReader(payload)
        s = cls()
        s.vp_viewport_id = br.ue()
        s.vp_camera_parameters_present_flag = bool(br.u(1))
        if s.vp_camera_parameters_present_flag:
            s.vp_camera_id = br.u(10)
        s.vp_cancel_flag = bool(br.u(1))
        if not s.vp_cancel_flag:
            s.vp_persistence_flag = bool(br.u(1))
            s.vp_position = (br.u(32), br.u(32), br.u(32))
            s.vp_rotation_qxyz = (br.u(16), br.u(16), br.u(16))
            s.vp_center_view_flag = bool(br.u(1))
            if not s.vp_center_view_flag:
                s.vp_left_view_flag = bool(br.u(1))
        return s


@dataclasses.dataclass
class SeiAttributeTransformationParams(Sei):
    """Layout per PCCBitstreamReader.cpp:2154-2181 (H.20.2.17).  Per
    attribute update: idx u(8), dimension_minus1 u(8), then one
    scale/offset pair per dimension index i < dimension_minus1 (the
    reference's loop bound), each gated by its own enable flags."""

    payload_type: int = SeiPayloadType.ATTRIBUTE_TRANSFORMATION_PARAMS
    atp_cancel_flag: bool = False
    atp_persistence_flag: bool = True
    # (attribute_idx, dimension_minus1,
    #  [(scale_enabled, offset_enabled, scale_u32, offset_i32) ...])
    atp_params: list[tuple] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.atp_cancel_flag)
        if not self.atp_cancel_flag:
            bw.ue(len(self.atp_params))
            for ai, dim_m1, dims in self.atp_params:
                bw.u(8, ai)
                bw.u(8, dim_m1)
                for se_f, oe_f, scale, off in dims[:dim_m1]:
                    bw.u(1, se_f)
                    bw.u(1, oe_f)
                    if se_f:
                        bw.u(32, scale)
                    if oe_f:
                        bw.u(32, off & 0xFFFFFFFF)
            bw.u(1, self.atp_persistence_flag)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiAttributeTransformationParams":
        br = BitReader(payload)
        s = cls()
        s.atp_cancel_flag = bool(br.u(1))
        if not s.atp_cancel_flag:
            n = br.ue()
            for _ in range(n):
                ai = br.u(8)
                dim_m1 = br.u(8)
                dims = []
                for _ in range(dim_m1):
                    se_f = bool(br.u(1))
                    oe_f = bool(br.u(1))
                    scale = br.u(32) if se_f else 0
                    off = 0
                    if oe_f:
                        v = br.u(32)
                        off = (v ^ 0x80000000) - 0x80000000  # i(32)
                    dims.append((se_f, oe_f, scale, off))
                s.atp_params.append((ai, dim_m1, dims))
            s.atp_persistence_flag = bool(br.u(1))
        return s


@dataclasses.dataclass
class SeiSceneObjectInformation(Sei):
    """F.2.12.1 — mirrors the reference parser EXACTLY, including its two
    quirks (PCCBitstreamReader.cpp:1668-1790): the object-update loop runs
    NumObjectUpdates+1 times (both reader and writer, so the coded count is
    len(objects)-1), and the per-object update fields are read when the
    cancel flag is SET.  Each object entry is a dict of the update fields
    keyed by: idx, cancel, label_update, label_idx, priority_update,
    priority, hidden, dep_update, deps, cones, bbox, collision_update,
    collision_id, point_style_update, point_shape, point_size,
    material_update, material_id."""

    payload_type: int = SeiPayloadType.SCENE_OBJECT_INFORMATION
    soi_persistence_flag: bool = True
    soi_reset_flag: bool = False
    soi_simple_objects_flag: bool = True
    soi_object_label_present_flag: bool = False
    soi_priority_present_flag: bool = False
    soi_object_hidden_present_flag: bool = False
    soi_object_dependency_present_flag: bool = False
    soi_visibility_cones_present_flag: bool = False
    soi_3d_bounding_box_present_flag: bool = False
    soi_collision_shape_present_flag: bool = False
    soi_point_style_present_flag: bool = False
    soi_material_id_present_flag: bool = False
    soi_extension_present_flag: bool = False
    soi_3d_bounding_box_scale_log2: int = 0
    soi_3d_bounding_box_precision_minus8: int = 0
    soi_log2_max_object_idx_updated: int = 1
    soi_log2_max_object_dependency_idx: int = 1
    objects: list[dict] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(1, self.soi_persistence_flag)
        bw.u(1, self.soi_reset_flag)
        if len(self.objects) == 1:
            raise ValueError(
                "the coded update count is len(objects)-1 with an "
                "inclusive loop; exactly one object is unrepresentable"
            )
        bw.ue(max(0, len(self.objects) - 1))
        if len(self.objects) - 1 > 0:
            bw.u(1, self.soi_simple_objects_flag)
            if not self.soi_simple_objects_flag:
                bw.u(1, self.soi_object_label_present_flag)
                bw.u(1, self.soi_priority_present_flag)
                bw.u(1, self.soi_object_hidden_present_flag)
                bw.u(1, self.soi_object_dependency_present_flag)
                bw.u(1, self.soi_visibility_cones_present_flag)
                bw.u(1, self.soi_3d_bounding_box_present_flag)
                bw.u(1, self.soi_collision_shape_present_flag)
                bw.u(1, self.soi_point_style_present_flag)
                bw.u(1, self.soi_material_id_present_flag)
                bw.u(1, self.soi_extension_present_flag)
            simple = self.soi_simple_objects_flag
            # the reference writer gates on the flags alone (callers keep
            # them False in simple mode, as the reader infers)
            bbox_p = self.soi_3d_bounding_box_present_flag
            if bbox_p:
                bw.u(5, self.soi_3d_bounding_box_scale_log2)
                bw.u(5, self.soi_3d_bounding_box_precision_minus8)
            bw.u(5, self.soi_log2_max_object_idx_updated)
            dep_p = self.soi_object_dependency_present_flag
            if dep_p:
                bw.u(5, self.soi_log2_max_object_dependency_idx)
            for o in self.objects:
                bw.u(self.soi_log2_max_object_idx_updated, o["idx"])
                bw.u(1, o.get("cancel", False))
                if o.get("cancel", False):
                    if self.soi_object_label_present_flag:
                        lu = o.get("label_update", False)
                        bw.u(1, lu)
                        if lu:
                            bw.ue(o.get("label_idx", 0))
                    if self.soi_priority_present_flag:
                        pu = o.get("priority_update", False)
                        bw.u(1, pu)
                        if pu:
                            bw.u(4, o.get("priority", 0))
                    if self.soi_object_hidden_present_flag:
                        bw.u(1, o.get("hidden", False))
                    if dep_p:
                        du = o.get("dep_update", False)
                        bw.u(1, du)
                        if du:
                            deps = o.get("deps", [])
                            bw.u(4, len(deps))
                            import math
                            bit_count = int(
                                math.ceil(math.log2(max(1, len(deps))) + 0.5)
                            )
                            for d in deps:
                                bw.u(bit_count, d)
                    if self.soi_visibility_cones_present_flag:
                        cu = o.get("cones") is not None
                        bw.u(1, cu)
                        if cu:
                            dx, dy, dz, ang = o["cones"]
                            bw.u(16, dx)
                            bw.u(16, dy)
                            bw.u(16, dz)
                            bw.u(16, ang)
                    if bbox_p:
                        bu = o.get("bbox") is not None
                        bw.u(1, bu)
                        if bu:
                            for c in o["bbox"]:
                                bw.ue(c)
                    if self.soi_collision_shape_present_flag:
                        csu = o.get("collision_update", False)
                        bw.u(1, csu)
                        if csu:
                            bw.u(16, o.get("collision_id", 0))
                    if self.soi_point_style_present_flag:
                        psu = o.get("point_style_update", False)
                        bw.u(1, psu)
                        if psu:
                            bw.u(8, o.get("point_shape", 0))
                            bw.u(16, o.get("point_size", 1))
                    if self.soi_material_id_present_flag:
                        mu = o.get("material_update", False)
                        bw.u(1, mu)
                        if mu:
                            bw.u(16, o.get("material_id", 0))
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiSceneObjectInformation":
        import math

        br = BitReader(payload)
        s = cls()
        s.soi_persistence_flag = bool(br.u(1))
        s.soi_reset_flag = bool(br.u(1))
        n = br.ue()
        if n > 0:
            s.soi_simple_objects_flag = bool(br.u(1))
            if not s.soi_simple_objects_flag:
                s.soi_object_label_present_flag = bool(br.u(1))
                s.soi_priority_present_flag = bool(br.u(1))
                s.soi_object_hidden_present_flag = bool(br.u(1))
                s.soi_object_dependency_present_flag = bool(br.u(1))
                s.soi_visibility_cones_present_flag = bool(br.u(1))
                s.soi_3d_bounding_box_present_flag = bool(br.u(1))
                s.soi_collision_shape_present_flag = bool(br.u(1))
                s.soi_point_style_present_flag = bool(br.u(1))
                s.soi_material_id_present_flag = bool(br.u(1))
                s.soi_extension_present_flag = bool(br.u(1))
            else:
                s.soi_object_label_present_flag = False
                s.soi_priority_present_flag = False
                s.soi_object_hidden_present_flag = False
                s.soi_object_dependency_present_flag = False
                s.soi_visibility_cones_present_flag = False
                s.soi_3d_bounding_box_present_flag = False
                s.soi_collision_shape_present_flag = False
                s.soi_point_style_present_flag = False
                s.soi_material_id_present_flag = False
                s.soi_extension_present_flag = False
            if s.soi_3d_bounding_box_present_flag:
                s.soi_3d_bounding_box_scale_log2 = br.u(5)
                s.soi_3d_bounding_box_precision_minus8 = br.u(5)
            s.soi_log2_max_object_idx_updated = br.u(5)
            if s.soi_object_dependency_present_flag:
                s.soi_log2_max_object_dependency_idx = br.u(5)
            for _ in range(n + 1):
                o: dict = {}
                o["idx"] = br.u(s.soi_log2_max_object_idx_updated)
                o["cancel"] = bool(br.u(1))
                if o["cancel"]:
                    if s.soi_object_label_present_flag:
                        o["label_update"] = bool(br.u(1))
                        if o["label_update"]:
                            o["label_idx"] = br.ue()
                    if s.soi_priority_present_flag:
                        o["priority_update"] = bool(br.u(1))
                        if o["priority_update"]:
                            o["priority"] = br.u(4)
                    if s.soi_object_hidden_present_flag:
                        o["hidden"] = bool(br.u(1))
                    if s.soi_object_dependency_present_flag:
                        o["dep_update"] = bool(br.u(1))
                        if o["dep_update"]:
                            ndeps = br.u(4)
                            bit_count = int(
                                math.ceil(math.log2(max(1, ndeps)) + 0.5)
                            )
                            o["deps"] = [br.u(bit_count) for _ in range(ndeps)]
                    if s.soi_visibility_cones_present_flag:
                        if br.u(1):
                            o["cones"] = (br.u(16), br.u(16), br.u(16),
                                          br.u(16))
                    if s.soi_3d_bounding_box_present_flag:
                        if br.u(1):
                            o["bbox"] = tuple(br.ue() for _ in range(6))
                    if s.soi_collision_shape_present_flag:
                        o["collision_update"] = bool(br.u(1))
                        if o["collision_update"]:
                            o["collision_id"] = br.u(16)
                    if s.soi_point_style_present_flag:
                        o["point_style_update"] = bool(br.u(1))
                        if o["point_style_update"]:
                            o["point_shape"] = br.u(8)
                            o["point_size"] = br.u(16)
                    if s.soi_material_id_present_flag:
                        o["material_update"] = bool(br.u(1))
                        if o["material_update"]:
                            o["material_id"] = br.u(16)
                s.objects.append(o)
        return s


@dataclasses.dataclass
class SeiManifest(Sei):
    payload_type: int = SeiPayloadType.SEI_MANIFEST
    # (sei_payload_type, description: 0 unknown/1 mandatory/2 optional)
    entries: list[tuple[int, int]] = field(default_factory=list)

    def payload_bytes(self) -> bytes:
        bw = BitWriter()
        bw.u(16, len(self.entries))
        for pt, desc in self.entries:
            bw.u(16, pt)
            bw.u(8, desc)
        bw.zero_align()
        return bw.data()

    @classmethod
    def from_payload(cls, payload: bytes) -> "SeiManifest":
        br = BitReader(payload)
        s = cls()
        n = br.u(16)
        for _ in range(n):
            s.entries.append((br.u(16), br.u(8)))
        return s


_SEI_CLASSES: dict[int, type[Sei]] = {
    SeiPayloadType.USER_DATA_UNREGISTERED: SeiUserDataUnregistered,
    SeiPayloadType.RECOVERY_POINT: SeiRecoveryPoint,
    SeiPayloadType.NO_RECONSTRUCTION: SeiNoReconstruction,
    SeiPayloadType.TIME_CODE: SeiTimeCode,
    SeiPayloadType.ACTIVE_SUB_BITSTREAMS: SeiActiveSubBitstreams,
    SeiPayloadType.OBJECT_LABEL_INFORMATION: SeiObjectLabelInformation,
    SeiPayloadType.VOLUMETRIC_RECTANGLE_INFORMATION: (
        SeiVolumetricRectangleInformation
    ),
    SeiPayloadType.VIEWPORT_CAMERA_PARAMETERS: SeiViewportCameraParameters,
    SeiPayloadType.VIEWPORT_POSITION: SeiViewportPosition,
    SeiPayloadType.ATTRIBUTE_TRANSFORMATION_PARAMS: (
        SeiAttributeTransformationParams
    ),
    SeiPayloadType.SCENE_OBJECT_INFORMATION: SeiSceneObjectInformation,
    SeiPayloadType.SEI_MANIFEST: SeiManifest,
    SeiPayloadType.DECODED_ATLAS_INFORMATION_HASH: SeiDecodedAtlasInformationHash,
    SeiPayloadType.COMPONENT_CODEC_MAPPING: SeiComponentCodecMapping,
    SeiPayloadType.GEOMETRY_SMOOTHING: SeiGeometrySmoothing,
    SeiPayloadType.ATTRIBUTE_SMOOTHING: SeiAttributeSmoothing,
    SeiPayloadType.OCCUPANCY_SYNTHESIS: SeiOccupancySynthesis,
    SeiPayloadType.FILLER_PAYLOAD: SeiFillerPayload,
    SeiPayloadType.USER_DATA_REGISTERED_ITUTT35: SeiUserDataRegisteredItuTT35,
    SeiPayloadType.ATLAS_OBJECT_INFORMATION: SeiAtlasObjectInformation,
    SeiPayloadType.PATCH_INFORMATION: SeiPatchInformation,
    SeiPayloadType.BUFFERING_PERIOD: SeiBufferingPeriod,
    SeiPayloadType.SEI_PREFIX_INDICATION: SeiPrefixIndication,
}
# ATLAS_FRAME_TIMING is typed too, but its bit widths come from the active
# BUFFERING_PERIOD: read_sei_rbsp passes the last one seen in the same rbsp
# and falls back to byte-exact RawSei passthrough when none is available.


def write_sei_rbsp(bw: BitWriter, seis: list[Sei]) -> None:
    """sei_rbsp: sei_message(s) with 0xFF-extended type/size coding.

    No rbsp_trailing byte: the reference reader resumes the sample-stream
    NAL scan at the byte right after the (single) SEI message it parses
    (PCCBitstreamReader.cpp:724-732 seiRbsp parses one message and never
    skips to the declared NAL boundary), so any trailing byte desyncs a
    cross-implementation parse.  The writer emits one message per NAL for
    the same reason (writer.py)."""
    for sei in seis:
        pt = int(sei.payload_type)
        while pt >= 255:
            bw.u(8, 255)
            pt -= 255
        bw.u(8, pt)
        payload = sei.payload_bytes()
        size = len(payload)
        while size >= 255:
            bw.u(8, 255)
            size -= 255
        bw.u(8, size)
        bw.write_bytes(payload)


def read_sei_rbsp(br: BitReader, prefix: bool) -> list[Sei]:
    seis: list[Sei] = []
    while br.remaining() > 1:
        pt = 0
        b = br.u(8)
        while b == 255:
            pt += 255
            b = br.u(8)
        pt += b
        size = 0
        b = br.u(8)
        while b == 255:
            size += 255
            b = br.u(8)
        size += b
        payload = br.read_bytes(size)
        cls = _SEI_CLASSES.get(pt)
        if pt == SeiPayloadType.ATLAS_FRAME_TIMING:
            bp = next(
                (s for s in reversed(seis)
                 if isinstance(s, SeiBufferingPeriod)),
                None,
            )
            sei = SeiAtlasFrameTiming.from_payload(payload, bp=bp)
        elif cls is not None:
            sei = cls.from_payload(payload)
        else:
            sei = RawSei(payload_type=pt, payload=payload)
        sei.prefix = prefix
        seis.append(sei)
    return seis
