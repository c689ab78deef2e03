"""The encoder's half of the foreign route, on the CPU: external video codecs
selected per component (``videoEncoder<Comp>CodecId=HM_APP``, run through
the stand-in binaries of each package) and the HDRTools colour conversion
(a stand-in HDRConvert), through the port's encoder given the JAX normals
(``test_torch_encoder.encode_both``) and through the JAX encoder.  V3C bytes
and closed-loop checksums must be equal: tolerance 0.  The stream that uses
the binaries for every component decodes through the port's decoder to the
closed loop's clouds.
"""

import numpy as np
import pytest

from rabbit_transcoding_tpu.apps import color_convert as ref_app
from rabbit_transcoding_tpu.core.image import Video as RefVideo
from rabbit_transcoding_tpu.utils.enums import ColorFormat as RefFormat
from rabbit_transcoding_tpu.video import hdrtools as ref_hdrtools
from rabbit_transcoding_tpu_torch import testdata
from rabbit_transcoding_tpu_torch.apps import color_convert as app
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.bitstream.sei import (
    SeiComponentCodecMapping,
)
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.utils.enums import ColorFormat
from rabbit_transcoding_tpu_torch.video import codec_group, hdrtools

from test_torch_encoder import (  # noqa: F401 (an autouse fixture)
    KNOB_BASE, encode_both, knob_clouds, one_torch_thread)
from test_torch_foreign import (
    COMPONENTS, decode_port, write_hdrconvert, write_ref_wrappers)


@pytest.fixture(scope="module")
def wrappers(tmp_path_factory):
    """(port encoder, port decoder), (JAX encoder, JAX decoder)."""
    return (testdata.write_codec_wrappers(tmp_path_factory.mktemp("port")),
            write_ref_wrappers(tmp_path_factory.mktemp("ref")))


def reflective_clouds():
    """The knob clouds with a reflectance per point (as the JAX package's
    reflectance-signalling test gives its cloud)."""
    clouds = knob_clouds()
    for c in clouds:
        c.reflectances = ((c.positions[:, 1].astype(np.uint32) * 31)
                          % 60000).astype(np.uint16)
    return clouds


def external(components, wrappers) -> tuple[dict, dict]:
    """(JAX params, the port's overrides) selecting HM_APP through each
    package's stand-in encoder for ``components``."""
    (port_enc, _), (ref_enc, _) = wrappers
    ref = dict(KNOB_BASE)
    port = {}
    for comp in components:
        ref[f"videoEncoder{comp}CodecId"] = "HM_APP"
        ref[f"videoEncoder{comp}Path"] = ref_enc
        port[f"videoEncoder{comp}Path"] = port_enc
    return ref, port


def context_of(data: bytes):
    reader = V3CReader()
    return reader.decode(reader.read(data)[0])


@pytest.fixture(scope="module")
def all_external(wrappers):
    """Every component through the stand-in, reflectance included (which
    stays RBV-lossless)."""
    ref, port = external(COMPONENTS, wrappers)
    return encode_both(ref, reflective_clouds(), port_params=port)


def test_occupancy_through_the_stand_in(wrappers):
    ref, port = external(("Occupancy",), wrappers)
    (want, want_sums), (got, got_sums) = encode_both(
        ref, knob_clouds(), port_params=port)
    assert got == want and got_sums == want_sums
    atlas = context_of(got).atlas(0)
    kinds = {vt.name: vb.data[:4]
             for vt, vb in atlas.video_bitstreams.items()}
    assert kinds == {"OCCUPANCY": b"\x00\x00\x00\x01",
                     "GEOMETRY": b"RBV2", "ATTRIBUTE": b"RBV2"}


def test_all_components_and_the_reflectance_signalling(all_external):
    """The port's twin of the JAX package's
    ``test_refl_maps_to_rbv_under_external_group``: with every main
    component on an external codec, reflectance (RBV-lossless) gets its own
    coded codec id, mapped to ``rbv1`` by the CCM SEI; the stream signals
    the HEVC group.  Bytes equal the JAX encoder's."""
    (want, want_sums), (got, got_sums) = all_external
    assert got == want and got_sums == want_sums
    context = context_of(got)
    assert (context.vps.profile_tier_level.ptl_profile_codec_group_idc
            == codec_group.CODEC_GROUP_HEVC_MAIN10)
    ai = context.vps.atlas(0).attribute_information
    assert ai.ai_attribute_count == 2
    main_cid, refl_cid = ai.ai_attribute_codec_id
    assert refl_cid != main_cid
    ccm = [s for s in context.atlas(0).seis_prefix
           if isinstance(s, SeiComponentCodecMapping)]
    assert ccm, "an external + RBV mix must carry a CCM SEI"
    assert dict(zip(ccm[0].ccm_codec_id, ccm[0].ccm_codec_4cc))[
        refl_cid] == "rbv1"


def test_decoder_reads_the_external_stream(all_external, wrappers,
                                           monkeypatch):
    """The port's decoder finds the stand-in decoder by the path
    parameters and by RABBIT_HM_APP_DECODER alone (the family from the
    stream's codec group): the closed loop's clouds both times."""
    _, (got, got_sums) = all_external
    (_, port_dec), _ = wrappers
    clouds = decode_port(got, **{f"videoDecoder{c}Path": port_dec
                                 for c in COMPONENTS})
    assert [ps.compute_checksum() for ps in clouds] == got_sums
    monkeypatch.setenv("RABBIT_HM_APP_DECODER", port_dec)
    clouds = decode_port(got)
    assert [ps.compute_checksum() for ps in clouds] == got_sums


CFG = ("SourceBitDepthCmp0: {sd}\nSourceChromaFormat: {sc}\n"
       "SourceColorSpace: {ss}\nOutputBitDepthCmp0: {od}\n"
       "OutputChromaFormat: {oc}\nOutputColorSpace: {os}\n")


@pytest.mark.parametrize("src,out", [
    ((8, 1, 0), (8, 1, 0)),       # YUV420 -> YUV420
    ((8, 3, 1), (8, 1, 0)),       # RGB444 -> YUV420
    ((8, 1, 0), (10, 3, 1)),      # YUV420 -> RGB444, 10-bit
])
def test_hdrconvert_wrapper_equal(tmp_path, src, out):
    binary = write_hdrconvert(tmp_path)
    cfg = tmp_path / "conv.cfg"
    cfg.write_text(CFG.format(sd=src[0], sc=src[1], ss=src[2], od=out[0],
                              oc=out[1], os=out[2]))
    conv = hdrtools.ExternalColorConverter(binary, str(cfg))
    ref = ref_hdrtools.ExternalColorConverter(binary, str(cfg))
    assert (conv.src_format.name, conv.out_format.name, conv.src_bitdepth,
            conv.out_bitdepth) == (ref.src_format.name, ref.out_format.name,
                                   ref.src_bitdepth, ref.out_bitdepth)
    rng = np.random.default_rng(2)
    fmt = conv.src_format.name
    shapes = ([(2, 16, 24)] * 3 if fmt != "YUV420"
              else [(2, 16, 24), (2, 8, 12), (2, 8, 12)])
    planes = [rng.integers(0, 256, s).astype(np.uint8) for s in shapes]
    got = conv.convert(Video(24, 16, 8, ColorFormat[fmt], planes))
    want = ref.convert(RefVideo(24, 16, 8, RefFormat[fmt], planes))
    assert got.format.name == want.format.name
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)
    # a video that does not match the cfg's Source keys is refused
    with pytest.raises(ValueError, match="Source keys"):
        conv.convert(Video(24, 16, 10, ColorFormat[fmt], planes))
    assert hdrtools.find_hdrconvert() == ref_hdrtools.find_hdrconvert()


def test_color_convert_app_runs_hdrconvert(tmp_path, monkeypatch):
    """With a cfg file and RABBIT_HDRCONVERT_BIN, both apps run the binary
    and write equal files."""
    binary = write_hdrconvert(tmp_path)
    monkeypatch.setenv("RABBIT_HDRCONVERT_BIN", binary)
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "conv.cfg"
    cfg.write_text(CFG.format(sd=8, sc=3, ss=1, od=8, oc=1, os=0))
    np.random.default_rng(5).integers(0, 256, 2 * 3 * 32 * 24).astype(
        np.uint8).tofile("in.rgb")
    args = ["--srcVideoPath=in.rgb", "--width=32", "--height=24",
            f"--configFile={cfg}"]
    assert ref_app.main(args + ["--dstVideoPath=ref.yuv"]) == 0
    assert app.main(args + ["--dstVideoPath=port.yuv", "--device=cpu"]) == 0
    got = (tmp_path / "port.yuv").read_bytes()
    assert got == (tmp_path / "ref.yuv").read_bytes()
    assert len(got) == 2 * 32 * 24 * 3 // 2
