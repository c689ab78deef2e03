"""The port's decoder on streams that the JAX package's V-PCC encoder writes
from a small sphere cloud, one per coding tool the decoder has a branch for:
both decoders read the same bytes and give equal clouds (arrays in order,
checksums), and the port's clouds carry the encoder's closed-loop checksums.
The port also transcodes such a stream, and both decoders agree on the
output.  Only bytes pass between the packages."""

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.bitstream.sei import (
    SeiAttributeSmoothing,
    SeiGeometrySmoothing,
    SeiOccupancySynthesis,
)
from rabbit_transcoding_tpu_torch.testdata import BRANCH_CARRIED

from test_e2e_codec import make_sphere_cloud
from test_torch_decoder import assert_clouds_equal, decode_port, decode_ref


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores, and torch's
    default pool of one thread per core in each of them oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_BASE = dict(minimumImageWidth=256, minimumImageHeight=64, geometryQP=8,
             attributeQP=16, occupancyPrecision=2, frameCount=1,
             groupOfFramesSize=1)


def _reflective_cloud():
    src = make_sphere_cloud(seed=4)
    src.reflectances = (
        (src.positions[:, 1].astype(np.uint32) * 31) % 60000
    ).astype(np.uint16)
    return src


# name -> (encoder parameters, what the stream must carry)
_VARIANTS = {
    "default": dict(),
    "two_frames": dict(frameCount=2, groupOfFramesSize=2),
    "lossy_occupancy_pbf": dict(occupancyPrecision=4, lossyOccupancyMap=True,
                                pbfEnableFlag=True),
    "plr": dict(pointLocalReconstruction=True, mapCountMinus1=0,
                flagGeometrySmoothing=False, constrainedPack=False),
    "pixel_interleaving": dict(singleMapPixelInterleaving=True,
                               mapCountMinus1=1),
    "raw_points": dict(rawPointsPatch=True, losslessGeo=True,
                       flagGeometrySmoothing=False),
    "eom": dict(enhancedOccupancyMapCode=True, losslessGeo=True,
                occupancyPrecision=1, flagGeometrySmoothing=False),
    "projection_45": dict(additionalProjectionPlaneMode=3,
                          flagGeometrySmoothing=False, constrainedPack=False,
                          rawPointsPatch=False),
    "lod": dict(levelOfDetailX=2, levelOfDetailY=2, rawPointsPatch=False),
    "reflectance": dict(),
    "map_streams": dict(multipleStreams=True, absoluteD1=False,
                        absoluteT1=False),
    "smoothing_gated_colour": dict(
        flagGeometrySmoothing=True, gridSmoothing=True,
        thresholdSmoothing=16.0, flagColorSmoothing=True, cgridSize=4,
        thresholdColorSmoothing=6.0, thresholdColorVariation=20.0,
        thresholdColorDifference=20.0),
    "reconstruction_idc_1": dict(
        flagGeometrySmoothing=True, gridSmoothing=True,
        thresholdSmoothing=16.0, profileReconstructionIdc=1,
        attributeTransferFilterType=1),
}


def _encode(name: str):
    params = dict(_BASE)
    params.update(_VARIANTS[name])
    frames = params["frameCount"]
    clouds = ([_reflective_cloud()] if name == "reflectance"
              else [make_sphere_cloud(seed=7 + i) for i in range(frames)])
    context, recon = Encoder(EncoderParameters(**params)).encode(
        GroupOfFrames(clouds))
    writer = ref_bitstream.V3CWriter()
    return (writer.write(writer.encode(context)),
            [ps.compute_checksum() for ps in recon])


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _encode(name)
        return cache[name]
    return get


def _atlas(data: bytes):
    reader = V3CReader()
    return reader.decode(reader.read(data)[0]).atlas(0)


def _has_sei(atlas, cls) -> bool:
    return any(isinstance(s, cls) for s in atlas.seis_prefix
               + atlas.seis_suffix)


# what each stream must carry for its test to mean what its name says (the
# branch streams' predicates are the committed branch fixtures')
_CARRIES = {
    **BRANCH_CARRIED,
    "lossy_occupancy_pbf": lambda a: _has_sei(a, SeiOccupancySynthesis),
    "eom": lambda a: a.asps_list[0].asps_eom_patch_enabled_flag,
    "smoothing_gated_colour": lambda a: (
        _has_sei(a, SeiGeometrySmoothing)
        and _has_sei(a, SeiAttributeSmoothing)),
    "reconstruction_idc_1": lambda a: _has_sei(a, SeiGeometrySmoothing),
}


# the coding tools' streams are decoded in test_torch_decoder_tools.py and
# test_torch_decoder_points.py (each file stays under a minute)
TOOL_STREAMS = ("lossy_occupancy_pbf", "plr", "pixel_interleaving")
POINT_STREAMS = ("raw_points", "eom", "projection_45", "lod")


def check_stream(streams, name: str) -> None:
    data, recon_checksums = streams(name)
    if name in _CARRIES:
        assert _CARRIES[name](_atlas(data)), name
    got = decode_port(data)
    assert_clouds_equal(got, decode_ref(data))
    # the decoder reproduces the encoder's closed loop
    assert [ps.compute_checksum() for ps in got] == recon_checksums
    assert all(ps.point_count > 1000 for ps in got)


@pytest.mark.parametrize(
    "name", [n for n in _VARIANTS if n not in TOOL_STREAMS + POINT_STREAMS])
def test_decoders_equal_on_encoder_streams(streams, name):
    check_stream(streams, name)


def test_reflectance_values_come_through(streams):
    data, _ = streams("reflectance")
    got = decode_port(data)[0]
    assert got.reflectances is not None
    assert got.reflectances.dtype == np.uint16 and got.reflectances.any()


@pytest.mark.parametrize("atf", [0, 1])
def test_attribute_transfer_filter_option(streams, atf):
    from rabbit_transcoding_tpu import bitstream as rb
    from rabbit_transcoding_tpu.decoder.decoder import (
        Decoder as RefDecoder,
        DecoderParameters as RefParams,
    )

    data, _ = streams("reconstruction_idc_1")
    reader = rb.V3CReader()
    want = RefDecoder(RefParams(attributeTransferFilterType=atf)).decode(
        reader.decode(reader.read(data)[0]))
    assert_clouds_equal(
        decode_port(data, attributeTransferFilterType=atf), want)


@pytest.mark.parametrize("name", ["default", "map_streams"])
def test_port_transcodes_and_both_decoders_agree(streams, name):
    from rabbit_transcoding_tpu_torch.transcoder import (
        Transcoder,
        TranscoderParameters,
        V3CWriter,
    )

    data, _ = streams(name)
    reader = V3CReader()
    context = reader.decode(reader.read(data)[0])
    Transcoder(TranscoderParameters(geometryQP=24, attributeQP=34),
               "cpu").transcode(context)
    writer = V3CWriter()
    out = writer.write(writer.encode(context))
    assert out != data
    assert_clouds_equal(decode_port(out), decode_ref(out))
