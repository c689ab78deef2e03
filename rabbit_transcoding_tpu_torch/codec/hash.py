"""Decoded-atlas-information hashes (hash SEI self-check).

Parity with the reference's hash-SEI byte strings (PCCCodec.cpp:2107-2501,
used by encoder, decoder and transcoder createHashSEI, PCCTranscoder.cpp:1543):
MD5 over the decoded atlas state — high-level syntax and the per-frame patch
parameter tables — so a decoder can verify it reconstructed the same atlas
metadata the encoder produced.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..bitstream.bitio import BitWriter
from ..bitstream.hls import AtlasHLS
from ..bitstream.sei import SeiDecodedAtlasInformationHash
from ..core.patch import Patch


def high_level_hash(atlas: AtlasHLS) -> bytes:
    """MD5 over the serialized ASPS+AFPS parameter sets."""
    h = hashlib.md5()
    for asps in atlas.asps_list:
        bw = BitWriter()
        asps.write(bw)
        h.update(bw.data())
    for afps in atlas.afps_list:
        bw = BitWriter()
        afps.write(bw, atlas.asps(afps.afps_atlas_sequence_parameter_set_id))
        h.update(bw.data())
    return h.digest()


def atlas_patch_hash(patch_frames: list[list[Patch]]) -> bytes:
    """MD5 over every decoded patch's geometry-mapping parameters, in frame
    and decode order."""
    h = hashlib.md5()
    for patches in patch_frames:
        for p in patches:
            h.update(np.ascontiguousarray(p.axes_struct()).tobytes())
    return h.digest()


def create_hash_sei(atlas: AtlasHLS, patch_frames) -> SeiDecodedAtlasInformationHash:
    return SeiDecodedAtlasInformationHash(
        daih_hash_type=0,
        high_level_md5=high_level_hash(atlas),
        atlas_md5=atlas_patch_hash(patch_frames),
    )


def verify_hash_sei(
    atlas: AtlasHLS, patch_frames
) -> tuple[bool, SeiDecodedAtlasInformationHash | None]:
    """Decoder-side self check: recompute and compare against a received
    hash SEI.  Returns (ok, sei) — ok is True when no hash SEI is present."""
    for sei in atlas.seis_prefix + atlas.seis_suffix:
        if isinstance(sei, SeiDecodedAtlasInformationHash) and not sei.daih_cancel_flag:
            ok = True
            if sei.daih_decoded_high_level_hash_present_flag:
                ok &= sei.high_level_md5 == high_level_hash(atlas)
            if sei.daih_decoded_atlas_hash_present_flag:
                ok &= sei.atlas_md5 == atlas_patch_hash(patch_frames)
            return ok, sei
    return True, None
