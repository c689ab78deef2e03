"""Multi-stream transcoder: N GOF contexts, their lossy videos batched over
a device mesh.

Port of ``rabbit_transcoding_tpu/transcoder/multistream.py``.  Everything a
single-stream ``Transcoder`` does per GOF happens here too (occupancy
downscale, hash-SEI refresh, ABR), and the lossy video payloads of all
streams go through ``parallel.multistream.transcode_payloads`` over the
transcoder's mesh: one batched device call per plane, group of streams of
one shape and shard.  Lossless inputs and predicted map pairs take each
stream's own ``Transcoder`` (``single(i)``), as in the reference; so does
ABR, whose search and QP cache are per-stream state.  Stream i's own
``Transcoder`` runs on the first device of mesh row ``i % rows`` (rows: the
"stream" axis).

Output: byte-identical bitstreams to ``Transcoder.transcode`` on each
context, for every mesh.  Unlike the reference's batched call, the batched
call here is passed the geometry coefficient threshold, so that this holds
with ``geometryCoeffThreshold`` set too (ROADMAP queue 3 item i).
"""

from __future__ import annotations

import torch

from ..bitstream.hls import Context
from ..bitstream.video_bitstream import VideoBitstream
from ..device import resolve
from ..parallel.mesh import Mesh, mesh_of
from ..parallel.multistream import transcode_payloads
from ..utils.enums import VideoType
from ..utils.timing import StageTimer
from ..video import rbv
from .params import TranscoderParameters
from .transcoder import _GEO_TYPES, Transcoder, has_lossless_video

_GEO_FAMILY = (VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
               VideoType.GEOMETRY_D1)
_ATTR_FAMILY = (VideoType.ATTRIBUTE, VideoType.ATTRIBUTE_T0,
                VideoType.ATTRIBUTE_T1)


class MultiStreamTranscoder:
    def __init__(self, params: TranscoderParameters | None = None,
                 device: torch.device | str | None = None,
                 mesh: Mesh | None = None):
        """``mesh`` places the batched calls; without one, ``device``
        (default ``cuda``) gives it (``parallel.mesh.mesh_of``): every
        visible card for ``cuda`` with no index, as the reference's
        ``make_mesh()`` default, else that one device.  Giving both raises,
        and so does a CUDA device where there is no card."""
        if mesh is not None and device is not None:
            raise ValueError("give a device or a mesh, not both")
        self.params = params or TranscoderParameters()
        self.device = (mesh.first if mesh is not None
                       else resolve(device or "cuda"))
        self._mesh = mesh
        self.timer = StageTimer()
        # one Transcoder per stream: per-stream state (the ABR QP cache) and
        # every non-batched stage
        self._singles: list[Transcoder] = []

    @property
    def mesh(self) -> Mesh:
        """The mesh of the batched calls, made at first use."""
        if self._mesh is None:
            self._mesh = mesh_of(self.device)
        return self._mesh

    def single(self, i: int) -> Transcoder:
        """Stream i's own Transcoder (its ABR QP cache lives there), on the
        first device of mesh row ``i % rows``."""
        rows = self.mesh.devices
        while len(self._singles) <= i:
            k = len(self._singles)
            self._singles.append(Transcoder(self.params,
                                            rows[k % len(rows), 0]))
        return self._singles[i]

    # ------------------------------------------------------------------
    def transcode_many(self, contexts: list[Context],
                       stream_ids: list[int] | None = None) -> list[Context]:
        """Transcode one GOF of each stream in place, every atlas each
        context carries, batching each atlas_id's video payloads across
        streams.  ``stream_ids`` ties contexts to stable per-stream state
        when the batch membership varies by round."""
        ids = (stream_ids if stream_ids is not None
               else list(range(len(contexts))))
        atlas_ids = sorted({a.atlas_id for ctx in contexts
                            for a in ctx.atlases})
        for aid in atlas_ids:
            sub = [(i, ctx) for i, ctx in zip(ids, contexts)
                   if any(a.atlas_id == aid for a in ctx.atlases)]
            self._transcode_atlases(
                [ctx.atlas(aid) for _, ctx in sub], [i for i, _ in sub],
                [ctx.map1_absolute() for _, ctx in sub])
        return contexts

    def transcode(self, contexts: list[Context],
                  atlas_id: int = 0) -> list[Context]:
        """Transcode one GOF of each stream in place, batched."""
        self._transcode_atlases(
            [ctx.atlas(atlas_id) for ctx in contexts],
            list(range(len(contexts))),
            [ctx.map1_absolute() for ctx in contexts])
        return contexts

    # ------------------------------------------------------------------
    def _transcode_atlases(self, atlases, stream_ids: list[int],
                           map1_abs: list[bool]) -> None:
        p = self.params
        singles = [self.single(i) for i in stream_ids]
        # the pre-downscale occupancy masks of streams with lossless video
        # (the single-stream path's fill anchors)
        occ_masks = [s._decode_occupancy_mask(atlas)
                     if has_lossless_video(atlas) else None
                     for s, atlas in zip(singles, atlases)]

        with self.timer.stage("transcodeOccupancy"):
            for s, atlas in zip(singles, atlases):
                s._transcode_occupancy(atlas)

        if p.rate_mode == "abr" and p.targetBitrateMbps > 0:
            # the search is per-stream state; its probes are one device
            # pass each
            with self.timer.stage("rateControl"):
                for s, atlas, occ, m1 in zip(singles, atlases, occ_masks,
                                             map1_abs):
                    _, abr_attr_qp = s._rate_control(atlas, occ_mask=occ,
                                                     map1_abs=m1)
                    s._transcode_reflectance(atlas, abr_attr_qp, occ)
        else:
            # predicted map pairs transcode jointly through the single-
            # stream path; the batched calls below leave them alone
            done: set[tuple[int, VideoType]] = set()
            for k, (s, atlas) in enumerate(zip(singles, atlases)):
                if map1_abs[k]:
                    continue
                for family, qp, component in (
                        (_GEO_FAMILY, p.effective_geometry_qp(), "geo"),
                        (_ATTR_FAMILY, p.effective_attribute_qp(), "attr")):
                    if s._has_rbv_pair(atlas, *family[1:]):
                        s._transcode_map_pair(atlas, *family[1:], qp,
                                              component,
                                              occ_mask=occ_masks[k])
                        done |= {(k, family[1]), (k, family[2])}
            with self.timer.stage("transcodeGeometry"):
                for vt in _GEO_FAMILY:
                    self._transcode_video_batched(
                        atlases, singles, occ_masks, done, vt,
                        p.effective_geometry_qp())
            with self.timer.stage("transcodeAttribute"):
                for vt in _ATTR_FAMILY:
                    self._transcode_video_batched(
                        atlases, singles, occ_masks, done, vt,
                        p.effective_attribute_qp())
                # partition / extra-attribute and reflectance streams: the
                # single-stream path (small, per-stream)
                for s, atlas, occ in zip(singles, atlases, occ_masks):
                    s._transcode_attr_ext(atlas, p.effective_attribute_qp(),
                                          occ)
                    s._transcode_reflectance(
                        atlas, p.effective_attribute_qp(), occ)

        if p.computeHashSei:
            with self.timer.stage("createHashSEI"):
                for s, atlas in zip(singles, atlases):
                    s._refresh_hash_sei(atlas)

    # ------------------------------------------------------------------
    def _transcode_video_batched(self, atlases, singles, occ_masks,
                                 done: set, vtype: VideoType,
                                 qp: int) -> None:
        p = self.params
        by_mode: dict[str, list[int]] = {}
        for k, atlas in enumerate(atlases):
            vb = atlas.video_bitstreams.get(vtype)
            if vb is None or (k, vtype) in done:
                continue
            info = rbv.probe(vb.data) if vb.data.startswith(b"RBV") else None
            if info is None or info["lossless"]:
                # foreign payloads and lossless inputs (the filled
                # re-encode) take the single-stream path
                singles[k]._transcode_video(atlas, vtype, qp,
                                            occ_mask=occ_masks[k])
                continue
            # the mode resolves per payload ('auto'); each resolved mode is
            # one batched call
            m = p.effective_mode(qp, motion=info["motion"])
            mode = ("requant" if m == "requant" and not p.transcodeBaseline
                    else "reencode")
            by_mode.setdefault(mode, []).append(k)
        for mode, ks in by_mode.items():
            payloads = transcode_payloads(
                [atlases[k].video_bitstreams[vtype].data for k in ks], qp,
                mesh=self.mesh,
                new_gop=1 if p.allIntra else p.videoGopSize, mode=mode,
                coeff_threshold=(p.geometryCoeffThreshold
                                 if vtype in _GEO_TYPES else 0))
            for k, payload in zip(ks, payloads):
                atlases[k].set_video_bitstream(VideoBitstream(vtype, payload))
