"""The port's copies of the foreign route's host modules against their
originals: the in-tree HEVC subsets (IPCM, compressed all-intra), the
HEVC/AVC/SHVC probes and layer filter, the codec-group signalling, the
stand-in codec and the reference syntax gate's flattener.

Every module here is integer host code, so the tolerance is 0 throughout:
equal bytes, arrays equal in order, equal dicts.  Only bytes, numpy arrays
and plain values pass between the packages.
"""

import numpy as np
import pytest
import torch

import mock_hevc as ref_mock
from rabbit_transcoding_tpu.bitstream import V3CReader as RefReader
from rabbit_transcoding_tpu.bitstream.hls import Context as RefContext
from rabbit_transcoding_tpu.bitstream.sei import (
    SeiComponentCodecMapping as RefCcm,
)
from rabbit_transcoding_tpu.bitstream.syntax import (
    V3CParameterSet as RefVps,
)
from rabbit_transcoding_tpu.conformance import refgate as ref_refgate
from rabbit_transcoding_tpu.core.image import Video as RefVideo
from rabbit_transcoding_tpu.utils.enums import CodecId as RefCodecId
from rabbit_transcoding_tpu.utils.enums import ColorFormat as RefFormat
from rabbit_transcoding_tpu.utils.enums import VideoType as RefVideoType
from rabbit_transcoding_tpu.video import codec_group as ref_cg
from rabbit_transcoding_tpu.video import hevc_intra as ref_intra
from rabbit_transcoding_tpu.video import hevc_ipcm as ref_ipcm
from rabbit_transcoding_tpu.video import hevc_probe as ref_probe
from rabbit_transcoding_tpu.video import shvc as ref_shvc
from rabbit_transcoding_tpu_torch import mock_hevc, testdata
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.bitstream.bitio import BitWriter
from rabbit_transcoding_tpu_torch.bitstream.hls import Context
from rabbit_transcoding_tpu_torch.bitstream.sei import (
    SeiComponentCodecMapping,
)
from rabbit_transcoding_tpu_torch.bitstream.syntax import V3CParameterSet
from rabbit_transcoding_tpu_torch.conformance import refgate
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.utils.enums import (
    CodecId,
    ColorFormat,
    VideoType,
)
from rabbit_transcoding_tpu_torch.video import (
    codec_group,
    hevc_intra,
    hevc_ipcm,
    hevc_probe,
    shvc,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def planes_for(w: int, h: int, mono: bool, depth: int, frames: int = 2,
               seed: int = 0) -> list[np.ndarray]:
    """Smooth content with noise (what a background-filled plane looks
    like), one array per plane."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if depth <= 8 else np.uint16
    maxv = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([
        maxv / 2 + maxv / 4 * np.sin((xx + 3 * f) / 7.0) * np.cos(yy / 5.0)
        + rng.normal(0, maxv / 64, (h, w)) for f in range(frames)])
    planes = [np.clip(np.round(y), 0, maxv).astype(dtype)]
    if not mono:
        for k in (1, 2):
            c = rng.integers(maxv // 3, 2 * maxv // 3,
                             (frames, h // 2, w // 2))
            planes.append(c.astype(dtype))
    return planes


def videos(w, h, mono, depth, frames=2, seed=0):
    """The same content as the port's and the reference's Video."""
    planes = planes_for(w, h, mono, depth, frames, seed)
    fmt = "YUV400" if mono else "YUV420"
    return (Video(w, h, depth, ColorFormat[fmt], [p.copy() for p in planes]),
            RefVideo(w, h, depth, RefFormat[fmt], [p.copy() for p in planes]))


def assert_videos_equal(got, want):
    assert (got.width, got.height, got.bitdepth, got.format.name) == \
        (want.width, want.height, want.bitdepth, want.format.name)
    assert len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- the in-tree HEVC subsets ---------------------------------------------------
@pytest.mark.parametrize("w,h,mono", [(64, 48, True), (64, 48, False),
                                      (70, 42, True), (70, 42, False)])
def test_ipcm_bytes_and_decode_equal(w, h, mono):
    port, ref = videos(w, h, mono, 8)
    data = hevc_ipcm.encode(port)
    assert data == ref_ipcm.encode(ref)
    assert_videos_equal(hevc_ipcm.decode(data), ref_ipcm.decode(data))
    assert hevc_ipcm.is_ipcm_subset(data) == ref_ipcm.is_ipcm_subset(data)
    assert hevc_ipcm.is_ipcm_subset(data)
    # lossless: the decode gives the input back
    assert_videos_equal(hevc_ipcm.decode(data), port)


@pytest.mark.parametrize("w,h,mono,depth,qp", [
    (64, 48, True, 10, 16),
    (64, 48, False, 8, 22),
    (70, 42, True, 10, 32),
    (70, 42, False, 8, 42),
    (48, 32, True, 8, 0),
    (48, 32, False, 10, 51),
])
def test_intra_bytes_and_decode_equal(w, h, mono, depth, qp):
    port, ref = videos(w, h, mono, depth)
    data = hevc_intra.encode(port, qp)
    assert data == ref_intra.encode(ref, qp)
    assert_videos_equal(hevc_intra.decode(data), ref_intra.decode(data))
    for a, b in ((hevc_intra.is_intra_subset, ref_intra.is_intra_subset),
                 (hevc_ipcm.is_ipcm_subset, ref_ipcm.is_ipcm_subset)):
        assert a(data) == b(data)
    assert hevc_intra.is_intra_subset(data)
    assert not hevc_ipcm.is_ipcm_subset(data)


def test_subset_membership_of_foreign_payloads():
    """Payloads outside both subsets: the stand-in codec's, a lone SPS, a
    payload that is not Annex-B."""
    port, _ = videos(32, 32, True, 10)
    payloads = [mock_hevc.encode(port, 20)[0],
                b"\x00\x00\x00\x01\x42\x01" + bytes(12), b"RBV2" + bytes(8)]
    for data in payloads:
        for a, b in ((hevc_intra.is_intra_subset, ref_intra.is_intra_subset),
                     (hevc_ipcm.is_ipcm_subset, ref_ipcm.is_ipcm_subset),
                     (codec_group.is_annexb, ref_cg.is_annexb)):
            assert a(data) == b(data)


@pytest.mark.parametrize("depth,chroma", [(10, "YUV400"), (8, "YUV420"),
                                          (8, "YUV444")])
def test_stand_in_codec_equal_to_the_reference_stand_in(depth, chroma):
    planes = planes_for(48, 32, chroma == "YUV400", depth)
    if chroma == "YUV444":
        planes = [planes[0]] * 3
    port = Video(48, 32, depth, ColorFormat[chroma], planes)
    ref = RefVideo(48, 32, depth, RefFormat[chroma], planes)
    for qp in (4, 20, 36):
        data, recon = mock_hevc.encode(port, qp)
        ref_data, ref_recon = ref_mock.encode(ref, qp)
        assert data == ref_data
        assert_videos_equal(recon, ref_recon)
        assert_videos_equal(mock_hevc.decode(data), ref_mock.decode(data))


# --- the probes ------------------------------------------------------------------
def sample_payloads() -> list[bytes]:
    """Annex-B payloads of every kind the probes meet: both subsets, the
    stand-in's, AVC SPSs, and streams without an SPS."""
    out = []
    for w, h, mono, depth in ((64, 48, True, 10), (70, 42, False, 8)):
        port, _ = videos(w, h, mono, depth, frames=1)
        out.append(hevc_intra.encode(port, 30))
        out.append(mock_hevc.encode(port, 12)[0])
        if depth == 8:
            out.append(hevc_ipcm.encode(port))
    for w_mbs, h_mbs, profile in ((80, 45, 100), (40, 30, 66)):
        bw = BitWriter()
        bw.u(8, profile)
        bw.u(8, 0)
        bw.u(8, 40)
        bw.ue(0)                   # seq_parameter_set_id
        if profile == 100:
            bw.ue(1)               # chroma_format_idc
            bw.ue(0)               # bit_depth_luma_minus8
            bw.ue(0)               # bit_depth_chroma_minus8
            bw.u(1, 0)             # qpprime_y_zero_transform_bypass
            bw.u(1, 0)             # seq_scaling_matrix_present
        bw.ue(0)                   # log2_max_frame_num_minus4
        bw.ue(2)                   # pic_order_cnt_type
        bw.ue(1)                   # max_num_ref_frames
        bw.u(1, 0)                 # gaps_in_frame_num_allowed
        bw.ue(w_mbs - 1)
        bw.ue(h_mbs - 1)
        bw.u(1, 1)                 # frame_mbs_only
        bw.zero_align()
        out.append(b"\x00\x00\x00\x01\x67" + bw.data())
    out.append(b"\x00\x00\x00\x01\x02\x01\xde\xad")
    out.append(b"\x00\x00\x01\x40\x01" + bytes(20))
    return out


def test_probes_equal():
    payloads = sample_payloads()
    seen = set()
    for data in payloads:
        for a, b in ((hevc_probe.probe_hevc, ref_probe.probe_hevc),
                     (hevc_probe.probe_avc, ref_probe.probe_avc),
                     (hevc_probe.hevc_layer_ids, ref_probe.hevc_layer_ids)):
            assert a(data) == b(data)
        seen.add((hevc_probe.probe_hevc(data) is None,
                  hevc_probe.probe_avc(data) is None))
        fam = codec_group.family_from_payload(data)
        ref_fam = ref_cg.family_from_payload(data)
        assert (fam and fam.name) == (ref_fam and ref_fam.name)
    # HEVC, AVC and neither all occur
    assert {(False, True), (True, False), (True, True)} <= seen


def two_layer_stream(module, writer_cls, nal_payload) -> bytes:
    """An SHVC stream: VPS with two rep formats, a base SPS, an
    enhancement-layer SPS, and one slice per layer."""
    vps = module.ShvcVps(
        max_layers=2,
        rep_formats=[module.RepFormat(width=64, height=32),
                     module.RepFormat(width=128, height=64,
                                      bit_depth_luma=10,
                                      bit_depth_chroma=10)],
        rep_format_idx=[0, 1])
    bw = writer_cls()
    vps.write(bw)
    stream = module.make_nal(module.HEVC_NAL_VPS, 0, bw.data())
    bw = writer_cls()
    module.write_base_sps(bw, 64, 32, 8, 1)
    stream += module.make_nal(module.HEVC_NAL_SPS, 0, bw.data())
    bw = writer_cls()
    module.write_multilayer_sps(bw)
    stream += module.make_nal(module.HEVC_NAL_SPS, 1, bw.data())
    for layer in (0, 1):
        stream += module.make_nal(1, layer, nal_payload)
    return stream


def test_shvc_layers_and_filter_equal():
    from rabbit_transcoding_tpu.bitstream.bitio import BitWriter as RefWriter

    data = two_layer_stream(shvc, BitWriter, b"\x80\x01\x02")
    assert data == two_layer_stream(ref_shvc, RefWriter, b"\x80\x01\x02")
    assert hevc_probe.hevc_layer_ids(data) == \
        ref_probe.hevc_layer_ids(data) == {0, 1}
    assert shvc.probe_shvc_layers(data) == ref_shvc.probe_shvc_layers(data)
    for layer in (0, 1, 5):
        base = hevc_probe.filter_hevc_layers(data, layer)
        assert base == ref_probe.filter_hevc_layers(data, layer)
    base = hevc_probe.filter_hevc_layers(data, 0)
    assert hevc_probe.hevc_layer_ids(base) == {0} and len(base) < len(data)
    assert shvc.probe_shvc_layers(base) == ref_shvc.probe_shvc_layers(base)


# --- codec-group signalling -------------------------------------------------------
_COMBOS = [
    ("RBV", "RBV", "RBV", None),
    ("RBV_LOSSLESS", "HM_APP", "HM_APP", None),
    ("HM_APP", "HM_APP", "RBV", None),
    ("JM_APP", "JM_APP", "JM_APP", None),
    ("VTM_APP", "RBV", "VTM_APP", None),
    ("RBV", "SHM_APP", "RBV", None),
    ("HM_APP", "JM_APP", "RBV", None),           # two families: raises
    ("RBV", "HM_APP", "FFMPEG_APP", 127),        # pinned MP4RA
    ("JM_APP", "VTM_APP", "SHM_APP", 127),
]


@pytest.mark.parametrize("occ,geo,attr,pinned", _COMBOS)
def test_signalling_equal(occ, geo, attr, pinned):
    def run(cg, ids):
        try:
            s = cg.signalling(ids[occ], ids[geo], ids[attr],
                              pinned_group=pinned)
        except ValueError as e:
            return ("raises", str(e).split(":")[0])
        return (s.profile_codec_group_idc, s.component_ids, s.ccm_entries)

    assert run(codec_group, CodecId) == run(ref_cg, RefCodecId)
    # with codec-id indices that collide: both raise alike
    if pinned:
        idx = {"HM_APP": 2, "SHM_APP": 2, "FFMPEG_APP": 2, "JM_APP": 0,
               "VTM_APP": 3, "RBV": 0}

        def run_idx(cg, ids):
            try:
                s = cg.signalling(
                    ids[occ], ids[geo], ids[attr], pinned_group=pinned,
                    codec_id_index={ids[k]: v for k, v in idx.items()})
            except ValueError as e:
                return ("raises", str(e))
            return (s.profile_codec_group_idc, s.component_ids,
                    s.ccm_entries)

        assert run_idx(codec_group, CodecId) == run_idx(ref_cg, RefCodecId)


def _contexts(group: int, ccm):
    """A port and a reference context with ``group`` signalled, their
    atlases carrying a CCM SEI of ``ccm`` [(coded id, 4cc)] when given."""
    out = []
    for ctx_cls, vps_cls, sei_cls in ((Context, V3CParameterSet,
                                       SeiComponentCodecMapping),
                                      (RefContext, RefVps, RefCcm)):
        ctx = ctx_cls()
        vps = vps_cls()
        vps.profile_tier_level.ptl_profile_codec_group_idc = group
        va = vps.atlas(0)
        va.occupancy_information.oi_occupancy_codec_id = 1
        va.geometry_information.gi_geometry_codec_id = 0
        va.geometry_information.gi_auxiliary_geometry_codec_id = 2
        va.attribute_information.ai_attribute_codec_id = [0]
        ctx.vps_list.append(vps)
        atlas = ctx.atlas(0)
        if ccm:
            atlas.seis_prefix.append(sei_cls(
                ccm_codec_mappings_count_minus1=len(ccm) - 1,
                ccm_codec_id=[c for c, _ in ccm],
                ccm_codec_4cc=[f for _, f in ccm]))
        out.append((ctx, atlas))
    return out


@pytest.mark.parametrize("group,ccm", [
    (0, None), (1, None), (2, None), (3, None), (127, None),
    (127, [(0, "rbv1"), (1, "hev1"), (2, "vvi1")]),
    (1, [(1, "rbv1")]),
    (0, [(0, "avc3")]),
])
def test_signalled_codec_equal(group, ccm):
    (ctx, atlas), (ref_ctx, ref_atlas) = _contexts(group, ccm)
    port_video, _ = videos(16, 16, True, 8, frames=1)
    payloads = [None, mock_hevc.encode(port_video, 10)[0],
                sample_payloads()[-4]]   # an AVC SPS
    for vt in ("OCCUPANCY", "GEOMETRY", "GEOMETRY_RAW", "ATTRIBUTE",
               "ATTRIBUTE_T1"):
        for payload in payloads:
            for use_ctx in (True, False):
                got = codec_group.signalled_codec(
                    ctx if use_ctx else None, atlas, VideoType[vt], payload)
                want = ref_cg.signalled_codec(
                    ref_ctx if use_ctx else None, ref_atlas,
                    RefVideoType[vt], payload)
                assert got.name == want.name, (vt, use_ctx)
        assert codec_group.component_of(VideoType[vt]) == \
            ref_cg.component_of(RefVideoType[vt])
    for name in ("JM_APP", "HM_APP", "SHM_APP", "VTM_APP", "FFMPEG_APP",
                 "RBV"):
        assert codec_group.group_fourcc(CodecId[name]) == \
            ref_cg.group_fourcc(RefCodecId[name])
    for fourcc in (None, "rbv1", "hvc1", "lhv1", "vvc1", "avc1", "xxxx"):
        assert codec_group.coded_codec_id(group, fourcc).name == \
            ref_cg.coded_codec_id(group, fourcc).name


# --- the reference syntax gate's flattener --------------------------------------
@pytest.mark.parametrize("kw", [dict(patches=True, smoothing=True),
                                dict(map_pair=True)])
def test_refgate_flatten_and_compare_equal(kw):
    data = testdata.make_stream(2, 64, 64, **kw)
    ours = refgate.flatten_contexts(
        [V3CReader().decode(g) for g in V3CReader().read(data)])
    theirs = ref_refgate.flatten_contexts(
        [RefReader().decode(g) for g in RefReader().read(data)])
    assert ours == theirs and len(ours) > 20
    assert refgate.compare(theirs, ours) == []
    # a changed, a missing and an extra field
    other = dict(theirs)
    keys = sorted(other)
    other[keys[3]] += 1
    del other[keys[0]]
    other["extra.field"] = 1
    assert refgate.compare(other, ours) == ref_refgate.compare(other, ours)
    assert len(refgate.compare(other, ours)) == 3
    assert refgate.compare(other, ours, ("extra",)) == \
        ref_refgate.compare(other, ours, ("extra",))


def test_refgate_needs_the_reference_tree():
    """The gate's tools build against a TMC2 source tree, which is not part
    of the checkout: without it the gate reports itself unavailable."""
    if not refgate.reference_available():
        assert not (refgate.REF_ROOT / "source/lib").is_dir()
    assert refgate._TOOLS.is_dir()
