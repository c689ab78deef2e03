"""The RABBIT live V3C transcoder: the RBV ``reencode``, ``requant`` and
``abr`` rate modes.

Port of ``rabbit_transcoding_tpu/transcoder/transcoder.py``.  Take a decoded
Context (HLS + video sub-bitstreams), re-encode (or requantise in the DCT
domain) each RBV video component at new rate points without re-running
segmentation or packing, optionally downscale the occupancy map, refresh the
hash SEI, and leave all other atlas metadata intact for remux.

* Lossy planes transcode on ``device`` (the card unless the caller asks
  for the CPU; no card raises): a stream without MC, intra,
  deblocking or threshold through the hand-written Hopper kernel on a CUDA
  device, every other one through the plain PyTorch chains on the same
  device.
* A lossless input over an occupancy map is background-filled (push-pull on
  ``device``) before its first quantisation.
* A predicted map pair (map 1 coded as a delta on map 0's recon) transcodes
  jointly: map 0 is re-encoded, and the delta re-derived against the new
  recon.
* ``rate_mode="abr"`` searches each component family's QP for a bit budget;
  the probes are the transcodes themselves, and the chosen QPs are cached
  per ``Transcoder`` across GOFs.

Parameters are the reference's ``TranscoderParameters`` (the port's copy,
``transcoder/params.py``), unchanged.  Foreign
(Annex-B) video raises ``NotImplementedError`` naming the ROADMAP item that
will port it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.hls import Context
from ..bitstream.sei import SeiDecodedAtlasInformationHash
from ..bitstream.video_bitstream import VideoBitstream
from ..codec.hash import create_hash_sei
from ..codec.mapstream import attr_bias, combine_map1, geo_bias, make_delta
from ..codec.patch_frame import decode_patch_frames
from ..core.image import Video
from ..device import resolve
from ..ops.dilate import pad_pow2, push_pull_fill
from ..ops.occupancy import downscale_maxpool, upsample_nearest
from ..utils.enums import CodecId, ColorFormat, VideoType
from ..utils.timing import StageTimer
from ..video import VideoDecoder, VideoEncoder, VideoEncoderParams, rbv
from .params import TranscoderParameters

PIXEL_VIDEO_TYPES = (
    VideoType.GEOMETRY, VideoType.ATTRIBUTE, VideoType.GEOMETRY_D0,
    VideoType.GEOMETRY_D1, VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1,
)
_GEO_TYPES = {VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
              VideoType.GEOMETRY_D1}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP, queue 1 item {item})"
    )


def _is_lossless_rbv(vb) -> bool:
    return vb.data.startswith(b"RBV") and rbv.probe(vb.data)["lossless"]


def has_lossless_video(atlas) -> bool:
    """Whether any pixel video of the atlas is lossless RBV (its transcode
    then needs the occupancy mask as fill anchors)."""
    return any(
        (vb := atlas.video_bitstreams.get(t)) is not None
        and _is_lossless_rbv(vb)
        for t in PIXEL_VIDEO_TYPES
    ) or any(_is_lossless_rbv(vb) for vb in atlas.attr_ext.values())


class Transcoder:
    def __init__(self, params: TranscoderParameters | None = None,
                 device: torch.device | str = "cuda"):
        self.params = params or TranscoderParameters()
        self.device = resolve(device)
        self.timer = StageTimer()
        # ABR: {"<family>:<stream>": (chosen QP, produced bytes)} across GOFs
        self._rc_cache: dict[str, tuple[int, int]] = {}

    # ------------------------------------------------------------------
    def _keep_intermediate(self, atlas, stage: str) -> None:
        """keepIntermediateFiles: dump each video sub-stream payload
        before/after transcoding for debugging."""
        if not self.params.keepIntermediateFiles:
            return
        base = self.params.test_name or "transcode"
        for vtype, vb in atlas.video_bitstreams.items():
            path = (f"{base}_{stage}_{vtype.name.lower()}"
                    f"_atlas{atlas.atlas_id}.bin")
            with open(path, "wb") as f:
                f.write(vb.data)

    def transcode(self, context: Context, atlas_id: int = 0) -> Context:
        """Transcode one GOF's atlas in place (PCCTranscoder::transcode)."""
        p = self.params
        atlas = context.atlas(atlas_id)
        self._keep_intermediate(atlas, "in")

        # lossless inputs re-encode through a background-filled pixel path;
        # the exact (pre-downscale) occupancy mask anchors the fill
        occ_mask = (self._decode_occupancy_mask(atlas)
                    if has_lossless_video(atlas) else None)

        with self.timer.stage("transcodeOccupancy"):
            self._transcode_occupancy(atlas)
        # predicted map coding: the map-1 delta is bound to the
        # reconstructed map 0, so the pair transcodes jointly in every mode
        map1_abs = context.map1_absolute()
        if p.rate_mode == "abr" and p.targetBitrateMbps > 0:
            # the chosen probe payload is the output; partition and extra
            # attribute streams share the attribute budget, reflectance
            # follows the chosen QP
            with self.timer.stage("rateControl"):
                _, abr_attr_qp = self._rate_control(
                    atlas, occ_mask=occ_mask, map1_abs=map1_abs)
                self._transcode_reflectance(atlas, abr_attr_qp, occ_mask)
        else:
            with self.timer.stage("transcodeGeometry"):
                self._transcode_family(
                    atlas, map1_abs, (VideoType.GEOMETRY,
                                      VideoType.GEOMETRY_D0,
                                      VideoType.GEOMETRY_D1),
                    p.effective_geometry_qp(), "geo", occ_mask)
            with self.timer.stage("transcodeAttribute"):
                self._transcode_family(
                    atlas, map1_abs, (VideoType.ATTRIBUTE,
                                      VideoType.ATTRIBUTE_T0,
                                      VideoType.ATTRIBUTE_T1),
                    p.effective_attribute_qp(), "attr", occ_mask)
                self._transcode_attr_ext(atlas, p.effective_attribute_qp(),
                                         occ_mask)
                self._transcode_reflectance(
                    atlas, p.effective_attribute_qp(), occ_mask)

        if p.computeHashSei:
            with self.timer.stage("createHashSEI"):
                self._refresh_hash_sei(atlas)
        self._keep_intermediate(atlas, "out")
        return context

    def _transcode_family(self, atlas, map1_abs: bool, types, qp: int,
                          component: str, occ_mask) -> None:
        """One component's videos: a predicted map pair (types[1:]) jointly,
        else each video on its own."""
        if not map1_abs and self._has_rbv_pair(atlas, *types[1:]):
            self._transcode_map_pair(atlas, *types[1:], qp, component,
                                     occ_mask=occ_mask)
            return
        for vt in types:
            self._transcode_video(atlas, vt, qp, occ_mask=occ_mask)

    # ------------------------------------------------------------------
    def _transcode_occupancy(self, atlas) -> None:
        """Occupancy is lossless; only its precision (video resolution) can
        change.  Downscale by max-pool when the target precision is
        coarser."""
        p = self.params
        vb = atlas.video_bitstreams.get(VideoType.OCCUPANCY)
        if vb is None or p.occupancyPrecision <= 0:
            return
        if not vb.data.startswith(b"RBV"):
            raise _not_ported("foreign (Annex-B) occupancy video", "9b")
        info = rbv.probe(vb.data)
        # incoming precision is implicit: atlas width / occupancy video width
        asps = atlas.asps_list[0]
        cur_precision = max(1, asps.asps_frame_width // info["width"])
        if p.occupancyPrecision == cur_precision:
            return
        if p.occupancyPrecision < cur_precision:
            raise ValueError(
                f"cannot upscale occupancy precision {cur_precision} -> "
                f"{p.occupancyPrecision}"
            )
        factor = p.occupancyPrecision // cur_precision
        video = VideoDecoder.create(CodecId.RBV, self.device).decode(vb.data)
        occ = torch.from_numpy(np.ascontiguousarray(video.planes[0]))
        small = downscale_maxpool(occ.to(self.device), factor).cpu().numpy()
        out_video = Video(
            video.width // factor, video.height // factor, video.bitdepth,
            ColorFormat.YUV400, [small],
        )
        payload, _ = VideoEncoder.create(
            CodecId.RBV_LOSSLESS, self.device
        ).encode(out_video, VideoEncoderParams(lossless=True))
        atlas.set_video_bitstream(VideoBitstream(VideoType.OCCUPANCY, payload))

    # ------------------------------------------------------------------
    def _decode_occupancy_mask(self, atlas) -> np.ndarray | None:
        """(F, H, W) uint8 atlas-resolution occupancy, upsampled from the
        current occupancy video (fill anchors for a lossless re-encode)."""
        vb = atlas.video_bitstreams.get(VideoType.OCCUPANCY)
        if vb is None or not vb.data.startswith(b"RBV") or not atlas.asps_list:
            return None
        video = VideoDecoder.create(CodecId.RBV, self.device).decode(vb.data)
        asps = atlas.asps_list[0]
        factor = max(1, asps.asps_frame_width // video.width)
        occ = (np.asarray(video.planes[0]) > 0).astype(np.uint8)
        if factor > 1:
            occ = upsample_nearest(torch.from_numpy(occ).to(self.device),
                                   factor).cpu().numpy()
        return occ[:, : asps.asps_frame_height, : asps.asps_frame_width]

    def _fill_video(self, video: Video, occ_mask: np.ndarray,
                    map_count: int) -> tuple[Video, bool]:
        """Occupancy-anchored push-pull background fill of a decoded video
        (the reference's dilate-before-encode) -> (filled video,
        per_map_stream)."""
        per_map_stream = video.frame_count == occ_mask.shape[0]
        if per_map_stream:
            occ_rep = occ_mask  # per-map sub-stream: one frame per source
        else:
            occ_rep = np.repeat(occ_mask, map_count,
                                axis=0)[: video.frame_count]
        maxval = (1 << video.bitdepth) - 1
        planes = []
        for pl in video.planes:
            pl = np.asarray(pl)
            mask = occ_rep
            if pl.shape[1:] != occ_rep.shape[1:]:
                # chroma subsampled plane: pool the mask down
                fy = occ_rep.shape[1] // pl.shape[1]
                mask = downscale_maxpool(
                    torch.from_numpy(occ_rep).to(self.device), fy
                ).cpu().numpy()
            mask = mask[:, : pl.shape[1], : pl.shape[2]]
            gpad, opad, (oh, ow) = pad_pow2(pl.astype(np.float32), mask)
            filled = push_pull_fill(torch.from_numpy(gpad).to(self.device),
                                    torch.from_numpy(opad).to(self.device))
            # torch.round rounds half to even, as np.round does
            filled = torch.clamp(torch.round(filled[:, :oh, :ow]), 0, maxval)
            planes.append(filled.cpu().numpy().astype(pl.dtype))
        return (
            Video(video.width, video.height, video.bitdepth, video.format,
                  planes),
            per_map_stream,
        )

    @staticmethod
    def _map_count(atlas) -> int:
        return (atlas.asps_list[0].asps_map_count_minus1 + 1
                if atlas.asps_list else 1)

    def _encode_filled(self, filled: tuple[Video, bool], qp: int,
                       map_count: int) -> bytes:
        """A filled lossless video -> lossy RBV at ``qp``: per-map
        sub-streams are not map-interleaved, so their GOP has no map
        factor."""
        p = self.params
        video, per_map_stream = filled
        gop = max(1, (1 if per_map_stream else map_count)
                  * (1 if p.allIntra else p.videoGopSize))
        payload, _ = VideoEncoder.create(CodecId.RBV, self.device).encode(
            video, VideoEncoderParams(qp=qp, gop_size=gop))
        return payload

    def _reencode_lossless_filled(self, atlas, vb, qp: int,
                                  occ_mask: np.ndarray | None) -> bytes:
        """Lossless video input -> lossy at ``qp``, with the occupancy-
        anchored background fill first: unfilled lossless planes ring hard
        at patch borders and waste bits on background edges."""
        if occ_mask is None:
            return rbv._reencode_lossless(vb.data, qp, None, 6, self.device)
        video = VideoDecoder.create(CodecId.RBV, self.device).decode(vb.data)
        map_count = self._map_count(atlas)
        return self._encode_filled(
            self._fill_video(video, occ_mask, map_count), qp, map_count)

    # ------------------------------------------------------------------
    @staticmethod
    def _has_rbv_pair(atlas, t0: VideoType, t1: VideoType) -> bool:
        vb0 = atlas.video_bitstreams.get(t0)
        vb1 = atlas.video_bitstreams.get(t1)
        return (
            vb0 is not None and vb1 is not None
            and vb0.data.startswith(b"RBV") and vb1.data.startswith(b"RBV")
        )

    def _prepare_map_pair(self, atlas, t0: VideoType, t1: VideoType,
                          component: str,
                          occ_mask: np.ndarray | None = None):
        """The QP-invariant prefix of a predicted-map-pair transcode: decode
        both maps, rebuild the absolute map 1 from (delta, rec0_old), and
        (for lossless inputs) the occupancy-anchored fill.  Hoisted out of
        the per-QP encode so that ABR's probes pay it once."""
        data0 = atlas.video_bitstreams[t0].data
        data1 = atlas.video_bitstreams[t1].data
        info0 = rbv.probe(data0)
        use_motion = bool(info0["motion"])  # keep the input's MC choice
        decoder = VideoDecoder.create(CodecId.RBV, self.device)
        v0, v1 = decoder.decode(data0), decoder.decode(data1)
        bias = (geo_bias(v0.bitdepth) if component == "geo"
                else attr_bias(v0.bitdepth))
        maxv = (1 << v0.bitdepth) - 1
        abs1 = [combine_map1(np.asarray(d), np.asarray(r0), bias, maxv)
                for d, r0 in zip(v1.planes, v0.planes)]
        if info0["lossless"] and occ_mask is not None:
            # fill the exact planes so that the lossy re-encode does not
            # ring at patch borders
            map_count = self._map_count(atlas)
            v0, _ = self._fill_video(v0, occ_mask, map_count)
            abs1_v, _ = self._fill_video(
                Video(v1.width, v1.height, v1.bitdepth, v1.format, abs1),
                occ_mask, map_count)
            abs1 = [np.asarray(pl) for pl in abs1_v.planes]
        return v0, v1, abs1, bias, maxv, use_motion

    def _make_map_pair_payloads(self, atlas, t0: VideoType, t1: VideoType,
                                qp: int, component: str,
                                occ_mask: np.ndarray | None = None,
                                prepared=None) -> tuple[bytes, bytes]:
        """Joint transcode of a predicted map pair: re-encode map 0 at the
        new QP, then re-derive and encode the delta against the new rec0."""
        p = self.params
        if prepared is None:
            prepared = self._prepare_map_pair(atlas, t0, t1, component,
                                              occ_mask=occ_mask)
        v0, v1, abs1, bias, maxv, use_motion = prepared
        gop = max(1, 1 if p.allIntra else p.videoGopSize)
        vep = VideoEncoderParams(
            qp=qp, gop_size=gop,
            motion=use_motion and gop > 1,
            coeff_threshold=(p.geometryCoeffThreshold
                             if component == "geo" else 0),
            intra=(p.geometryIntraPrediction if component == "geo"
                   else p.attributeIntraPrediction) and gop <= 4,
        )
        encoder = VideoEncoder.create(CodecId.RBV, self.device)
        payload0, rec0_new = encoder.encode(v0, vep)
        delta_new = [make_delta(a1, np.asarray(r0), bias, maxv)
                     for a1, r0 in zip(abs1, rec0_new.planes)]
        payload1, _ = encoder.encode(
            Video(v1.width, v1.height, v1.bitdepth, v1.format, delta_new),
            vep)
        return payload0, payload1

    def _transcode_map_pair(self, atlas, t0: VideoType, t1: VideoType,
                            qp: int, component: str,
                            occ_mask: np.ndarray | None = None) -> None:
        payload0, payload1 = self._make_map_pair_payloads(
            atlas, t0, t1, qp, component, occ_mask=occ_mask)
        atlas.set_video_bitstream(VideoBitstream(t0, payload0))
        atlas.set_video_bitstream(VideoBitstream(t1, payload1))

    # ------------------------------------------------------------------
    def _transcode_video(self, atlas, vtype: VideoType, qp: int,
                         occ_mask: np.ndarray | None = None) -> None:
        vb = atlas.video_bitstreams.get(vtype)
        if vb is None:
            return
        payload = self._transcode_payload_any(atlas, vtype, vb, qp,
                                              occ_mask=occ_mask)
        atlas.set_video_bitstream(VideoBitstream(vtype, payload))

    def _transcode_payload_any(self, atlas, vtype: VideoType, vb, qp: int,
                               occ_mask: np.ndarray | None = None) -> bytes:
        """One sub-stream payload -> transcoded payload (used for both the
        standard VideoType slots and the attr_ext streams)."""
        p = self.params
        if not vb.data.startswith(b"RBV"):
            raise _not_ported(f"foreign (Annex-B) {vtype.name} video", "9b")
        info = rbv.probe(vb.data)
        if info["lossless"]:
            return self._reencode_lossless_filled(atlas, vb, qp, occ_mask)
        if (p.effective_mode(qp, motion=info["motion"]) == "requant"
                and not p.transcodeBaseline):
            return rbv.requantize(vb.data, qp, device=self.device)
        # fused decode -> re-encode on the device
        return rbv.transcode_payload(
            vb.data, qp,
            new_gop=1 if p.allIntra else p.videoGopSize,
            coeff_threshold=(p.geometryCoeffThreshold
                             if vtype in _GEO_TYPES else 0),
            device=self.device,
        )

    def _transcode_attr_ext(self, atlas, qp: int,
                            occ_mask: np.ndarray | None = None) -> None:
        """Dimension-partitioned / extra attribute sub-streams transcode at
        the attribute QP like the primary stream."""
        for key, vb in list(atlas.attr_ext.items()):
            payload = self._transcode_payload_any(
                atlas, VideoType.ATTRIBUTE, vb, qp, occ_mask=occ_mask)
            atlas.attr_ext[key] = VideoBitstream(VideoType.ATTRIBUTE, payload)

    def _transcode_reflectance(self, atlas, qp: int,
                               occ_mask: np.ndarray | None = None) -> None:
        """Reflectance (attribute index 1): a lossless stream passes through
        untouched; a lossy one transcodes like any attribute video."""
        vb = atlas.video_bitstreams.get(VideoType.ATTRIBUTE_REFL)
        if vb is None or _is_lossless_rbv(vb):
            return
        payload = self._transcode_payload_any(
            atlas, VideoType.ATTRIBUTE_REFL, vb, qp, occ_mask=occ_mask)
        atlas.set_video_bitstream(
            VideoBitstream(VideoType.ATTRIBUTE_REFL, payload))

    # ------------------------------------------------------------------
    def _rate_control(self, atlas, occ_mask=None,
                      map1_abs: bool = True) -> tuple[int, int]:
        """rate_mode='abr': pick (geometry QP, attribute QP) hitting the
        target bitrate and install the winning payloads (the probes are
        DCT-domain requantisations, so search and transcode are one
        operation).  Chosen QPs are cached across GOFs and re-searched only
        when the produced size drifts > 20% from target.  Per-map
        sub-streams split their family's budget by input-size share;
        lossless inputs probe through the filled re-encode; predicted map
        pairs search jointly."""
        p = self.params
        map_count = self._map_count(atlas)
        interleaved = {VideoType.GEOMETRY, VideoType.ATTRIBUTE}

        def collect(types):
            return [(t, vb) for t in types
                    if (vb := atlas.video_bitstreams.get(t)) is not None
                    and vb.data.startswith(b"RBV")]

        geo_vbs = collect((VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
                           VideoType.GEOMETRY_D1))
        attr_vbs = collect((VideoType.ATTRIBUTE, VideoType.ATTRIBUTE_T0,
                            VideoType.ATTRIBUTE_T1))
        # partition / extra-attribute sub-streams (keyed by the (attr,
        # partition, map) triple) share the attribute family budget
        attr_vbs += [(key, vb) for key, vb in sorted(atlas.attr_ext.items())
                     if vb.data.startswith(b"RBV")]
        # predicted map pairs search jointly, outside the per-stream lists
        geo_pair = (not map1_abs) and self._has_rbv_pair(
            atlas, VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1)
        attr_pair = (not map1_abs) and self._has_rbv_pair(
            atlas, VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1)
        if geo_pair:
            geo_vbs = [x for x in geo_vbs if x[0] == VideoType.GEOMETRY]
        if attr_pair:
            attr_vbs = [x for x in attr_vbs
                        if x[0] == VideoType.ATTRIBUTE
                        or isinstance(x[0], tuple)]
        if not geo_vbs and not attr_vbs and not geo_pair and not attr_pair:
            return 32, 32  # foreign payloads only: ABR not applicable

        def gof_frames(t, vb) -> int:
            try:
                f = rbv.probe(vb.data)["frame_count"]
                return max(1, f // (map_count if t in interleaved else 1))
            except ValueError:
                return 1

        frame_src = geo_vbs or attr_vbs
        if frame_src:
            frames = gof_frames(*frame_src[0])
        else:
            t0 = (VideoType.GEOMETRY_D0 if geo_pair
                  else VideoType.ATTRIBUTE_T0)
            frames = gof_frames(t0, atlas.video_bitstreams[t0])
        budget = p.targetBitrateMbps * 1e6 / 8.0 * frames / max(
            1e-6, p.frameRate)
        geo_budget = budget * p.geometryBitrateShare
        attr_budget = budget - geo_budget

        filled_cache: dict[int, tuple] = {}

        def probe_payload(vb, qp: int) -> bytes:
            if not rbv.probe(vb.data)["lossless"]:
                return rbv.requantize(vb.data, qp, device=self.device)
            # the first quantisation of a lossless input goes through the
            # filled re-encode; decode + fill are QP-invariant, done once
            if occ_mask is None:
                return rbv._reencode_lossless(vb.data, qp, None, 6,
                                              self.device)
            key = id(vb)
            if key not in filled_cache:
                video = VideoDecoder.create(CodecId.RBV,
                                            self.device).decode(vb.data)
                filled_cache[key] = self._fill_video(video, occ_mask,
                                                     map_count)
            return self._encode_filled(filled_cache[key], qp, map_count)

        def install_for(t):
            """A family entry's installer: a VideoType into its slot, an
            (attr, partition, map) key back into attr_ext."""
            if isinstance(t, tuple):
                return lambda payload: atlas.attr_ext.__setitem__(
                    t, VideoBitstream(VideoType.ATTRIBUTE, payload))
            return lambda payload: atlas.set_video_bitstream(
                VideoBitstream(t, payload))

        def bisect(make, size, install, target_bytes, cache_key):
            """The QP in [4, 48] of the largest output within target_bytes
            (48 when none fits), installed -> (qp, bytes)."""
            cached = self._rc_cache.get(cache_key)
            if cached is not None:
                qp, nbytes = cached
                if abs(nbytes - target_bytes) <= 0.2 * target_bytes:
                    out = make(qp)
                    install(out)
                    return qp, size(out)
            lo, hi = 4, 48
            best, best_out = hi, None
            while lo <= hi:
                mid = (lo + hi) // 2
                out = make(mid)
                if size(out) <= target_bytes:
                    best, best_out = mid, out
                    hi = mid - 1
                else:
                    lo = mid + 1
            if best_out is None:
                best_out = make(best)
            self._rc_cache[cache_key] = (best, size(best_out))
            install(best_out)
            return best, size(best_out)

        def search_family(vbs, family_budget, prefix) -> tuple[int, int]:
            if not vbs:
                return 32, 0
            total_in = sum(len(vb.data) for _, vb in vbs)
            # the family's representative QP is the largest sub-stream's
            qp_out, best_share = 32, -1.0
            nbytes = 0
            for t, vb in vbs:
                share = len(vb.data) / max(1, total_in)
                name = f"ext{t}" if isinstance(t, tuple) else t.name
                qp, nb = bisect(
                    lambda q, vb=vb: probe_payload(vb, q), len,
                    install_for(t), family_budget * share,
                    f"{prefix}:{name}")
                if share > best_share:
                    qp_out, best_share = qp, share
                nbytes += nb
            return qp_out, nbytes

        def search_pair(t0, t1, target_bytes, cache_key,
                        component) -> tuple[int, int]:
            # decode + combine + fill are QP-invariant: once per search
            prepared = self._prepare_map_pair(atlas, t0, t1, component,
                                              occ_mask=occ_mask)

            def make(qp: int) -> tuple[bytes, bytes]:
                return self._make_map_pair_payloads(
                    atlas, t0, t1, qp, component, occ_mask=occ_mask,
                    prepared=prepared)

            def install(pair) -> None:
                atlas.set_video_bitstream(VideoBitstream(t0, pair[0]))
                atlas.set_video_bitstream(VideoBitstream(t1, pair[1]))

            return bisect(make, lambda pair: len(pair[0]) + len(pair[1]),
                          install, target_bytes, cache_key)

        def run_geo(fam_budget) -> tuple[int, int]:
            if geo_pair:
                return search_pair(VideoType.GEOMETRY_D0,
                                   VideoType.GEOMETRY_D1, fam_budget,
                                   "geo:pair", "geo")
            return search_family(geo_vbs, fam_budget, "geo")

        def run_attr(fam_budget) -> tuple[int, int]:
            if attr_pair:
                return search_pair(VideoType.ATTRIBUTE_T0,
                                   VideoType.ATTRIBUTE_T1, fam_budget,
                                   "attr:pair", "attr")
            return search_family(attr_vbs, fam_budget, "attr")

        geo_qp, geo_bytes = run_geo(geo_budget)
        attr_qp, attr_bytes = run_attr(attr_budget)

        # cross-component reallocation: each family lands at or below its
        # share, typically one QP step under; hand the surplus to the family
        # still coded coarser (higher QP) and re-search just that family
        has_geo = bool(geo_vbs) or geo_pair
        has_attr = bool(attr_vbs) or attr_pair
        surplus = budget - geo_bytes - attr_bytes
        if surplus > 0.05 * budget and has_geo and has_attr:
            if attr_qp >= geo_qp:
                attr_qp, attr_bytes = run_attr(attr_budget + surplus)
            else:
                geo_qp, geo_bytes = run_geo(geo_budget + surplus)
        return geo_qp, attr_qp

    # ------------------------------------------------------------------
    def _refresh_hash_sei(self, atlas) -> None:
        """Replace any decoded-atlas-hash SEI with a freshly computed one.
        Atlas metadata is untouched by transcoding, so the recomputed hash
        certifies the passthrough."""
        patch_frames = decode_patch_frames(atlas)
        sei = create_hash_sei(atlas, patch_frames)
        atlas.seis_prefix = [
            s for s in atlas.seis_prefix
            if not isinstance(s, SeiDecodedAtlasInformationHash)
        ]
        atlas.seis_prefix.append(sei)
