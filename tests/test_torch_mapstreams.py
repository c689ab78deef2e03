"""Per-map sub-streams, predicted map pairs and ABR rate control: the port's
Transcoder against the JAX package's on the CPU (bytes, chosen QPs and the
QP cache).  Each package parses V3C bytes with its own reader; the two meet
only in bytes."""

import dataclasses

import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParameters,
)
from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder as RefTranscoder
from rabbit_transcoding_tpu_torch import bitstream
from rabbit_transcoding_tpu_torch.bitstream import V3CReader
from rabbit_transcoding_tpu_torch.testdata import make_stream, with_input_qps
from rabbit_transcoding_tpu_torch.transcoder.params import TranscoderParameters
from rabbit_transcoding_tpu_torch.transcoder.transcoder import Transcoder
from rabbit_transcoding_tpu_torch.utils.enums import VideoType

from test_e2e_codec import make_sphere_cloud


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


def _encode(**kw) -> bytes:
    params = dict(minimumImageWidth=256, minimumImageHeight=64,
                  geometryQP=12, attributeQP=20, occupancyPrecision=2,
                  flagGeometrySmoothing=False, frameCount=1,
                  groupOfFramesSize=1)
    params.update(kw)
    context, _ = Encoder(EncoderParameters(**params)).encode(
        GroupOfFrames([make_sphere_cloud(seed=7)]))
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


@pytest.fixture(scope="module")
def predicted_pairs() -> bytes:
    """The D1-from-rec-D0 / T1-from-rec-T0 encoder configuration."""
    return _encode(multipleStreams=True, absoluteD1=False, absoluteT1=False)


@pytest.fixture(scope="module")
def absolute_maps() -> bytes:
    """Per-map sub-streams, both maps coded absolutely."""
    return _encode(multipleStreams=True, absoluteD1=True, absoluteT1=True)


def _transcode(data: bytes, transcoder, gof: int = 0) -> bytes:
    """GOF ``gof`` of ``data`` through ``transcoder``, read and written by
    the V3C reader and writer of the transcoder's own package."""
    bs = ref_bitstream if isinstance(transcoder, RefTranscoder) else bitstream
    reader = bs.V3CReader()
    context = reader.decode(reader.read(data)[gof])
    transcoder.transcode(context)
    writer = bs.V3CWriter()
    return writer.write(writer.encode(context))


def _pair(params: TranscoderParameters):
    """(reference Transcoder, port Transcoder on the CPU) of ``params``."""
    return (RefTranscoder(RefParameters(**dataclasses.asdict(params))),
            Transcoder(params, "cpu"))


def _both(data: bytes, **kw):
    ref, port = _pair(TranscoderParameters(**kw))
    return _transcode(data, port), _transcode(data, ref), port, ref


@pytest.mark.parametrize("kw", [
    {"mode": "reencode"},
    {"mode": "requant"},
    {"mode": "reencode", "allIntra": True, "geometryQP": 24},
    {"mode": "reencode", "geometryCoeffThreshold": 6},
])
def test_predicted_pairs_bytes_identical(predicted_pairs, kw):
    ctx = V3CReader().decode(V3CReader().read(predicted_pairs)[0])
    assert not ctx.map1_absolute()
    assert VideoType.GEOMETRY_D1 in ctx.atlas(0).video_bitstreams
    assert VideoType.ATTRIBUTE_T1 in ctx.atlas(0).video_bitstreams
    params = dict(geometryQP=28, attributeQP=36)
    params.update(kw)
    got, want, _, _ = _both(predicted_pairs, **params)
    assert got == want


@pytest.mark.parametrize("mode", ["reencode", "requant"])
def test_testdata_map_pair_bytes_identical(mode):
    # without MC (the encoder's pairs above are MC + intra): the joint
    # re-encode keeps the input's choice and turns intra on
    data = make_stream(4, 128, 128, map_pair=True)
    ctx = V3CReader().decode(V3CReader().read(data)[0])
    assert not ctx.map1_absolute()
    got, want, _, _ = _both(data, geometryQP=30, attributeQP=40, mode=mode)
    assert got == want


def test_absolute_maps_bytes_identical(absolute_maps):
    got, want, _, _ = _both(absolute_maps, geometryQP=28, attributeQP=36)
    assert got == want


# --- ABR ----------------------------------------------------------------------
def _abr(data: bytes, mbps: float):
    got, want, port, ref = _both(data, rate_mode="abr",
                                 targetBitrateMbps=mbps)
    assert got == want
    assert port._rc_cache == ref._rc_cache
    return port._rc_cache


@pytest.mark.parametrize("mbps", [0.5, 2.0, 6.0])
def test_abr_plain_stream(mbps):
    cache = _abr(make_stream(4, 128, 128), mbps)
    assert set(cache) == {"geo:GEOMETRY", "attr:ATTRIBUTE"}


def test_abr_per_map_substreams(absolute_maps):
    cache = _abr(absolute_maps, 0.5)
    assert any(k.startswith("geo:GEOMETRY_D") for k in cache)
    assert any(k.startswith("attr:ATTRIBUTE_T") for k in cache)


def test_abr_predicted_pairs(predicted_pairs):
    cache = _abr(predicted_pairs, 0.5)
    assert "geo:pair" in cache and "attr:pair" in cache


def test_abr_testdata_map_pair_and_lossless():
    assert "geo:pair" in _abr(make_stream(4, 128, 128, map_pair=True), 1.0)
    assert "geo:GEOMETRY" in _abr(make_stream(4, 128, 128, lossless=True),
                                  1.0)


def test_abr_cache_reused_across_gofs():
    # one Transcoder per side over three GOFs: the same content twice (the
    # cached QPs are reused), then the content at other input QPs (the
    # cache is checked against the new sizes)
    base = make_stream(4, 128, 128)
    gofs = [base, base, with_input_qps(base, 24, 30)]
    ref, port = _pair(TranscoderParameters(rate_mode="abr",
                                           targetBitrateMbps=2.0))
    caches = []
    for data in gofs:
        assert _transcode(data, port) == _transcode(data, ref)
        assert port._rc_cache == ref._rc_cache
        caches.append(dict(port._rc_cache))
    assert caches[1] == caches[0]
