"""Profile codec-group signalling and coded-codec-id resolution.

The reference identifies the video codec of a V3C stream through
``ptl_profile_codec_group_idc`` (PCCBitstreamCommon.h:169-173) plus, under
the MP4RA group, the Component Codec Mapping SEI's 4CC entries; decoders
map that back to a concrete codec with ``PCCTranscoder::getCodedCodecId``
(PCCTranscoder.cpp:2110-2243).  This module is that mapping for our codec
set: RBV (the TPU-native codec, signalled as an MP4RA 4CC ``rbv1``) plus
the external HM/JM/SHM/VTM/ffmpeg app backends.
"""

from __future__ import annotations

import dataclasses

from ..utils.enums import CodecId, VideoType

_GEOMETRY_TYPES = frozenset({
    VideoType.GEOMETRY, VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1,
    VideoType.GEOMETRY_RAW,
})
_ATTRIBUTE_TYPES = frozenset({
    VideoType.ATTRIBUTE, VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1,
    VideoType.ATTRIBUTE_RAW, VideoType.ATTRIBUTE_REFL,
})


def component_of(vtype: VideoType) -> str:
    """'occupancy' | 'geometry' | 'attribute' for a video sub-stream type."""
    if vtype == VideoType.OCCUPANCY:
        return "occupancy"
    if vtype in _GEOMETRY_TYPES:
        return "geometry"
    if vtype in _ATTRIBUTE_TYPES:
        return "attribute"
    raise ValueError(f"unknown video type {vtype}")


def is_annexb(data: bytes) -> bool:
    return data[:4] == b"\x00\x00\x00\x01" or data[:3] == b"\x00\x00\x01"

# PCCBitstreamCommon.h:169-173
CODEC_GROUP_AVC_PROGRESSIVE_HIGH = 0
CODEC_GROUP_HEVC_MAIN10 = 1
CODEC_GROUP_HEVC444 = 2
CODEC_GROUP_VVC_MAIN10 = 3
CODEC_GROUP_MP4RA = 127

RBV_4CC = "rbv1"

# codec family -> the codec group a stream encoded with it signals
_GROUP_OF = {
    CodecId.RBV: CODEC_GROUP_MP4RA,
    CodecId.RBV_LOSSLESS: CODEC_GROUP_MP4RA,
    CodecId.JM_APP: CODEC_GROUP_AVC_PROGRESSIVE_HIGH,
    CodecId.HM_APP: CODEC_GROUP_HEVC_MAIN10,
    CodecId.SHM_APP: CODEC_GROUP_HEVC_MAIN10,
    CodecId.FFMPEG_APP: CODEC_GROUP_HEVC_MAIN10,  # libx265 output
    CodecId.VTM_APP: CODEC_GROUP_VVC_MAIN10,
}

# 4CC registered names (MP4RA) per codec family
_FOURCC_OF = {
    CodecId.RBV: RBV_4CC,
    CodecId.RBV_LOSSLESS: RBV_4CC,
    CodecId.JM_APP: "avc3",
    CodecId.HM_APP: "hev1",
    CodecId.SHM_APP: "lhv1",
    CodecId.FFMPEG_APP: "hev1",
    CodecId.VTM_APP: "vvi1",
}

_FOURCC_TO_CODEC = {
    RBV_4CC: CodecId.RBV,
    "avc1": CodecId.JM_APP,
    "avc3": CodecId.JM_APP,
    "hev1": CodecId.HM_APP,
    "hvc1": CodecId.HM_APP,
    "lhv1": CodecId.SHM_APP,
    "vvc1": CodecId.VTM_APP,
    "vvi1": CodecId.VTM_APP,
}

_GROUP_TO_CODEC = {
    CODEC_GROUP_AVC_PROGRESSIVE_HIGH: CodecId.JM_APP,
    CODEC_GROUP_HEVC_MAIN10: CodecId.HM_APP,
    CODEC_GROUP_HEVC444: CodecId.HM_APP,
    CODEC_GROUP_VVC_MAIN10: CodecId.VTM_APP,
}


@dataclasses.dataclass
class CodecSignalling:
    """What a stream's VPS/SEI should say about its video codecs."""

    profile_codec_group_idc: int
    # per-component coded codec id (the oi/gi/ai *_codec_id value)
    component_ids: dict  # {"occupancy"|"geometry"|"attribute": int}
    # (ccm_codec_id, 4cc) entries for the Component Codec Mapping SEI;
    # empty when the group alone identifies every component's codec
    ccm_entries: list


def signalling(
    occ: CodecId,
    geo: CodecId,
    attr: CodecId,
    pinned_group: int | None = None,
    codec_id_index: dict | None = None,
) -> CodecSignalling:
    """Derive PTL group + per-component coded ids + CCM SEI entries from the
    per-component encoder selection (encoder-side getCodedCodecId inverse).

    All-RBV streams signal CODEC_GROUP_MP4RA with a single ``rbv1`` CCM
    entry.  Streams with external components signal that family's codec
    group; RBV components (if mixed in) get a distinct coded id mapped to
    ``rbv1`` via the CCM SEI.  Mixing two different *external* families in
    one stream has no group encoding — reject it like the reference would.
    """
    comps = {"occupancy": occ, "geometry": geo, "attribute": attr}
    if pinned_group == CODEC_GROUP_MP4RA:
        # the user forced the MP4RA group: every component is identified by
        # a CCM SEI entry; external families use the configured codec-id
        # indices (reference *CodecIdIndex options, "Index use if CMC SEI",
        # PCCEncoderParameters.cpp:245-248 + getCodecIdIndex :1248-1276)
        idx = codec_id_index or {}
        default_idx = {
            CodecId.RBV: 0, CodecId.RBV_LOSSLESS: 0,
            CodecId.JM_APP: 0, CodecId.HM_APP: 1,
            CodecId.FFMPEG_APP: 1, CodecId.SHM_APP: 2, CodecId.VTM_APP: 3,
        }
        ids, ccm, seen = {}, [], {}
        for name, c in comps.items():
            cid = idx.get(c, default_idx[c])
            fourcc = _FOURCC_OF[c]
            if cid in seen and seen[cid] != fourcc:
                raise ValueError(
                    f"codec-id index {cid} maps to both {seen[cid]!r} and "
                    f"{fourcc!r}; set distinct *CodecIdIndex values"
                )
            if cid not in seen:
                seen[cid] = fourcc
                ccm.append((cid, fourcc))
            ids[name] = cid
        return CodecSignalling(CODEC_GROUP_MP4RA, ids, ccm)
    ext_groups = {
        _GROUP_OF[c] for c in comps.values()
        if _GROUP_OF[c] != CODEC_GROUP_MP4RA
    }
    if len(ext_groups) > 1:
        raise ValueError(
            f"cannot mix video codec families in one V3C stream: {comps}"
        )
    if not ext_groups:
        return CodecSignalling(
            CODEC_GROUP_MP4RA,
            {k: 0 for k in comps},
            [(0, RBV_4CC)],
        )
    group = ext_groups.pop()
    ids = {}
    ccm = []
    rbv_id = None
    for name, c in comps.items():
        if _GROUP_OF[c] == group:
            ids[name] = 0
        else:  # RBV component riding along an external-family stream
            if rbv_id is None:
                rbv_id = 1
                ccm.append((rbv_id, RBV_4CC))
            ids[name] = rbv_id
    return CodecSignalling(group, ids, ccm)


def coded_codec_id(
    group_idc: int, fourcc: str | None = None
) -> CodecId:
    """getCodedCodecId analog (PCCTranscoder.cpp:2110-2243): resolve the
    codec family a coded component used, from the stream's codec group and
    (under MP4RA, or for components remapped by the CCM SEI) its 4CC."""
    if fourcc:
        codec = _FOURCC_TO_CODEC.get(fourcc)
        if codec is not None:
            return codec
    return _GROUP_TO_CODEC.get(group_idc, CodecId.RBV)


def group_fourcc(codec: CodecId) -> tuple[int, str]:
    """(codec group idc, 4cc) a single-codec stream would signal."""
    return _GROUP_OF[codec], _FOURCC_OF[codec]


def family_from_payload(data: bytes) -> CodecId | None:
    """Codec family whose SPS the payload parses as (PccLibHevcParser /
    PccLibAvcParser role), or None."""
    from .hevc_probe import probe_avc, probe_hevc

    if probe_hevc(data) is not None:
        return CodecId.HM_APP
    if probe_avc(data) is not None:
        return CodecId.JM_APP
    return None


def signalled_codec(
    context, atlas, vtype: VideoType, payload: bytes | None = None
) -> CodecId:
    """The codec family a stream's own signalling declares for one
    component's videos: the PTL codec-group idc picks the family, and the
    Component Codec Mapping SEI's 4CC entries override per coded component
    id (decoder-side getCodedCodecId, PCCTranscoder.cpp:2110-2243).

    Codec-group 0 is both 'AVC Progressive High' and the value legacy
    streams wrote as a don't-care default, so there (and for MP4RA without
    a matching 4CC) a parseable SPS in ``payload`` decides the family
    before the group mapping does.  Returns CodecId.RBV when nothing
    identifies an external family."""
    from ..bitstream.sei import SeiComponentCodecMapping

    if context is None or not getattr(context, "vps_list", []):
        if payload is not None:
            return family_from_payload(payload) or CodecId.RBV
        return CodecId.RBV
    group = context.vps.profile_tier_level.ptl_profile_codec_group_idc
    comp = component_of(vtype)
    va = context.vps.atlas(0)
    coded_id = 0
    if comp == "occupancy":
        coded_id = va.occupancy_information.oi_occupancy_codec_id
    elif comp == "geometry":
        gi = va.geometry_information
        coded_id = (gi.gi_auxiliary_geometry_codec_id
                    if vtype == VideoType.GEOMETRY_RAW
                    else gi.gi_geometry_codec_id)
    else:
        ai = va.attribute_information
        if ai.ai_attribute_codec_id:
            coded_id = ai.ai_attribute_codec_id[0]
    fourcc = None
    if atlas is not None:
        for s in getattr(atlas, "seis_prefix", []):
            if isinstance(s, SeiComponentCodecMapping):
                for cid_, cc in zip(s.ccm_codec_id, s.ccm_codec_4cc):
                    if cid_ == coded_id:
                        fourcc = cc
                        break
                break
    if fourcc and fourcc in _FOURCC_TO_CODEC:
        return _FOURCC_TO_CODEC[fourcc]
    if group in _GROUP_TO_CODEC and group != CODEC_GROUP_AVC_PROGRESSIVE_HIGH:
        return _GROUP_TO_CODEC[group]
    if payload is not None:
        fam = family_from_payload(payload)
        if fam is not None:
            return fam
    return _GROUP_TO_CODEC.get(group, CodecId.RBV)
