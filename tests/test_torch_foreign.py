"""The foreign-codec route of the port against the JAX package's, on the CPU:
V3C streams whose video sub-streams are HEVC Annex-B, through the
transcoder (the in-tree HEVC subsets, the stand-in external binaries, the
SHVC layer filter, passthrough), the multi-stream transcoder and the
decoder (``test_torch_foreign_decode.py``).  The JAX package's bytes
against the port's ``device=cpu`` bytes,
decoded clouds as arrays in order: everything on this route is integer host
code, so the tolerance is 0.

The stand-in binaries: the port runs ``testdata.write_codec_wrappers``
(``rabbit_transcoding_tpu_torch.mock_hevc`` under HM's command line); the
JAX package runs the same wrappers over its own stand-in,
``tests/mock_hevc.py``.  Both kinds put the repo root on ``PYTHONPATH``,
so the child process finds its package installed or not.
"""

import os
import shlex
import stat
import sys

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.decoder.decoder import Decoder as RefDecoder
from rabbit_transcoding_tpu.decoder.decoder import (
    DecoderParameters as RefDecoderParameters,
)
from rabbit_transcoding_tpu.transcoder.params import (
    TranscoderParameters as RefParams,
)
from rabbit_transcoding_tpu.transcoder.transcoder import (
    Transcoder as RefTranscoder,
)
from rabbit_transcoding_tpu_torch import bitstream, mock_hevc, testdata
from rabbit_transcoding_tpu_torch.bitstream import VideoBitstream
from rabbit_transcoding_tpu_torch.bitstream.bitio import BitWriter
from rabbit_transcoding_tpu_torch.decoder.decoder import (
    Decoder,
    DecoderParameters,
)
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder,
    Transcoder,
    TranscoderParameters,
    VideoType,
)
from rabbit_transcoding_tpu_torch.video import hevc_intra, hevc_ipcm, shvc
from rabbit_transcoding_tpu_torch.video.hevc_probe import hevc_layer_ids


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MOCK = os.path.join(REPO, "tests", "mock_hevc.py")
COMPONENTS = ("Occupancy", "Geometry", "Attribute")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _executable(path, text: str) -> str:
    path.write_text(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return str(path)


def write_ref_wrappers(directory) -> tuple[str, str]:
    """The JAX package's stand-in binaries (``tests/mock_hevc.py``) under
    HM's command line, with the repo root on ``PYTHONPATH``."""
    directory.mkdir(parents=True, exist_ok=True)
    return tuple(_executable(
        directory / name,
        "#!/bin/sh\n"
        f"PYTHONPATH={shlex.quote(REPO)}${{PYTHONPATH:+:$PYTHONPATH}}\n"
        "export PYTHONPATH\n"
        f"exec {shlex.quote(sys.executable)} {shlex.quote(REF_MOCK)} "
        f"{mode} \"$@\"\n") for name, mode in (("TAppEncoder.sh", "encode"),
                                                ("TAppDecoder.sh", "decode")))


def write_hdrconvert(directory) -> str:
    """A stand-in HDRConvert (HDRConvert's ``-f cfg -p Key=Value``
    command line): writes an output file of the size the cfg's Output*
    keys ask for, the input's bytes repeated and cut to that size.  A fixed
    function of its input, so that both packages meet the same colours."""
    script = (
        "import sys\n"
        "args = sys.argv[1:]\n"
        "cfg = open(args[args.index('-f') + 1]).read()\n"
        "kv = dict(a.split('=', 1) for a in args if '=' in a)\n"
        "def key(k):\n"
        "    for line in cfg.splitlines():\n"
        "        if line.split(':')[0].strip() == k:\n"
        "            return int(line.split(':')[1])\n"
        "    return 0\n"
        "n = int(kv['SourceWidth']) * int(kv['SourceHeight'])\n"
        "n = n * 3 // 2 if key('OutputChromaFormat') == 1 else 3 * n\n"
        "size = n * int(kv['NumberOfFrames'])\n"
        "size *= 2 if key('OutputBitDepthCmp0') > 8 else 1\n"
        "data = open(kv['SourceFile'], 'rb').read()\n"
        "data = data * (size // max(1, len(data)) + 1)\n"
        "open(kv['OutputFile'], 'wb').write(data[:size])\n")
    return _executable(
        directory / "HDRConvert",
        f"#!/bin/sh\nexec {shlex.quote(sys.executable)} -c "
        f"{shlex.quote(script)} \"$@\"\n")


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """{"port": (encoder, decoder), "ref": (encoder, decoder)}: the
    stand-in binaries of each package."""
    return {
        "port": testdata.write_codec_wrappers(
            tmp_path_factory.mktemp("port_hm")),
        "ref": write_ref_wrappers(tmp_path_factory.mktemp("ref_hm")),
    }


@pytest.fixture()
def no_binaries(monkeypatch):
    """No external codec binary resolves: an empty PATH, no overrides."""
    for name in ("HM", "JM", "SHM", "VTM", "FFMPEG"):
        for role in ("ENCODER", "DECODER"):
            monkeypatch.delenv(f"RABBIT_{name}_APP_{role}", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")


def _units(data: bytes, reader):
    return reader.read(data)[0]


def transcode_port(data: bytes, **kw) -> bytes:
    reader = bitstream.V3CReader()
    context = reader.decode(_units(data, reader))
    Transcoder(TranscoderParameters(**kw), "cpu").transcode(context)
    writer = bitstream.V3CWriter()
    return writer.write(writer.encode(context))


def transcode_ref(data: bytes, **kw) -> bytes:
    reader = ref_bitstream.V3CReader()
    context = reader.decode(_units(data, reader))
    RefTranscoder(RefParams(**kw)).transcode(context)
    writer = ref_bitstream.V3CWriter()
    return writer.write(writer.encode(context))


def videos_of(data: bytes) -> dict:
    reader = bitstream.V3CReader()
    atlas = reader.decode(_units(data, reader)).atlas(0)
    return {vt.name: vb.data for vt, vb in atlas.video_bitstreams.items()}


def rewrite(data: bytes, keep=None, group=None, **payloads) -> bytes:
    """The first GOF of ``data`` with its videos replaced by ``payloads``
    ({video type name: bytes}), only the types in ``keep`` kept when given,
    and the codec group set to ``group`` when given."""
    reader = bitstream.V3CReader()
    context = reader.decode(_units(data, reader))
    atlas = context.atlas(0)
    for vt in list(atlas.video_bitstreams):
        if keep is not None and vt.name not in keep:
            del atlas.video_bitstreams[vt]
    for name, payload in payloads.items():
        atlas.set_video_bitstream(VideoBitstream(VideoType[name], payload))
    if group is not None:
        context.vps.profile_tier_level.ptl_profile_codec_group_idc = group
    writer = bitstream.V3CWriter()
    return writer.write(writer.encode(context))


@pytest.fixture(scope="module")
def rbv_stream():
    return testdata.make_stream(2, 128, 128, patches=True, smoothing=True)


@pytest.fixture(scope="module")
def intra_stream(rbv_stream):
    """The patch stream's videos as the in-tree subsets: IPCM occupancy,
    all-intra geometry (QP 16) and attribute (QP 22)."""
    return testdata.to_foreign(rbv_stream)


@pytest.fixture(scope="module")
def mock_stream(rbv_stream):
    """The patch stream's videos as the stand-in codec's payloads: outside
    both in-tree subsets."""
    return testdata.to_foreign(rbv_stream, codec="mock")


# --- the transcoder ---------------------------------------------------------------
@pytest.mark.parametrize("precision", [2, 4, 8])
def test_intra_subset_stream_equal(intra_stream, no_binaries, precision):
    """No binary: the route resolves the in-tree subsets, re-encodes the
    geometry and attribute at the new QPs and the occupancy as IPCM at the
    target precision (2 keeps the stream's, 4 and 8 max-pool it)."""
    kw = dict(geometryQP=32, attributeQP=42, occupancyPrecision=precision)
    got = transcode_port(intra_stream, **kw)
    assert got == transcode_ref(intra_stream, **kw)
    before, after = videos_of(intra_stream), videos_of(got)
    for name in ("GEOMETRY", "ATTRIBUTE"):
        assert hevc_intra.is_intra_subset(after[name])
        assert len(after[name]) < len(before[name])
    occ_in = hevc_ipcm.decode(before["OCCUPANCY"]).planes[0]
    occ_out = hevc_ipcm.decode(after["OCCUPANCY"]).planes[0]
    f = precision // 2
    f_, h, w = occ_in.shape
    pooled = occ_in.reshape(f_, h // f, f, w // f, f).max(axis=(2, 4))
    np.testing.assert_array_equal(occ_out, pooled)


def test_passthrough_when_nothing_resolves(mock_stream, no_binaries):
    """No binary, payloads outside both subsets: every video passes
    through untouched in both packages."""
    kw = dict(geometryQP=32, attributeQP=42, occupancyPrecision=4)
    got = transcode_port(mock_stream, **kw)
    assert got == transcode_ref(mock_stream, **kw)
    assert videos_of(got) == videos_of(mock_stream)


@pytest.mark.parametrize("way", ["explicit_path", "environment",
                                 "auto_family"])
def test_stand_in_binaries_resolved(mock_stream, bins, no_binaries,
                                    monkeypatch, way):
    """The stand-in binaries found three ways: the videoEncoder/Decoder
    path parameters, the RABBIT_HM_APP_{ENCODER,DECODER} overrides, and the
    codec family derived from the stream's own signalling (VVC group ->
    RABBIT_VTM_APP_*).  The geometry video alone keeps the binary calls
    few."""
    data = rewrite(mock_stream, keep=("GEOMETRY",),
                   group=3 if way == "auto_family" else None)
    kw = dict(geometryQP=34, attributeQP=42)
    out = {}
    for pkg, run in (("port", transcode_port), ("ref", transcode_ref)):
        enc, dec = bins[pkg]
        params = dict(kw)
        if way == "explicit_path":
            params.update(videoEncoderGeometryPath=enc,
                          videoDecoderGeometryPath=dec)
        else:
            family = "VTM_APP" if way == "auto_family" else "HM_APP"
            monkeypatch.setenv(f"RABBIT_{family}_ENCODER", enc)
            monkeypatch.setenv(f"RABBIT_{family}_DECODER", dec)
        out[pkg] = run(data, **params)
    assert out["port"] == out["ref"]
    geo_in, geo_out = (videos_of(d)["GEOMETRY"] for d in (data,
                                                          out["port"]))
    assert len(geo_out) < len(geo_in)
    got, want = mock_hevc.decode(geo_out), mock_hevc.decode(geo_in)
    err = got.planes[0].astype(np.int64) - want.planes[0]
    assert float(np.sqrt(np.mean(err ** 2.0))) < 32


def test_ten_bit_occupancy_downscale(rbv_stream, bins, no_binaries):
    """A 10-bit occupancy video (uint16 planes) through the stand-in with a
    precision change: the max-pool on the port's device gives the JAX
    package's bytes."""
    from rabbit_transcoding_tpu_torch.video import rbv

    occ = rbv.decode(videos_of(rbv_stream)["OCCUPANCY"], "cpu")
    occ.planes = [p.astype(np.uint16) * 700 for p in occ.planes]
    occ.bitdepth = 10
    data = rewrite(rbv_stream, keep=("OCCUPANCY",),
                   OCCUPANCY=mock_hevc.encode(occ, 4)[0])
    out = {}
    for pkg, run in (("port", transcode_port), ("ref", transcode_ref)):
        enc, dec = bins[pkg]
        out[pkg] = run(data, occupancyPrecision=4, occupancyMapQP=4,
                       videoEncoderOccupancyPath=enc,
                       videoDecoderOccupancyPath=dec)
    assert out["port"] == out["ref"]
    got = mock_hevc.decode(videos_of(out["port"])["OCCUPANCY"])
    assert got.bitdepth == 10 and got.width == occ.width // 2
    assert got.planes[0].max() == 700


def shvc_payload() -> bytes:
    """A two-layer SHVC payload: VPS, base and enhancement SPS, one slice
    per layer."""
    vps = shvc.ShvcVps(
        max_layers=2,
        rep_formats=[shvc.RepFormat(width=64, height=64),
                     shvc.RepFormat(width=128, height=128)],
        rep_format_idx=[0, 1])
    bw = BitWriter()
    vps.write(bw)
    out = shvc.make_nal(shvc.HEVC_NAL_VPS, 0, bw.data())
    bw = BitWriter()
    shvc.write_base_sps(bw, 64, 64, 10, 0)
    out += shvc.make_nal(shvc.HEVC_NAL_SPS, 0, bw.data())
    bw = BitWriter()
    shvc.write_multilayer_sps(bw)
    out += shvc.make_nal(shvc.HEVC_NAL_SPS, 1, bw.data())
    for layer in (0, 1):
        out += shvc.make_nal(1, layer, bytes([0x80, 7, layer]))
    return out


@pytest.mark.parametrize("layer", [0, 1, -1])
def test_shvc_layer_index(rbv_stream, no_binaries, layer):
    """A layered geometry payload keeps its layers up to shvcLayerIndex
    (no pixel re-encode); -1 turns the filter off (then nothing resolves
    and the payload passes through)."""
    data = rewrite(rbv_stream, GEOMETRY=shvc_payload())
    kw = dict(geometryQP=32, attributeQP=42, shvcLayerIndex=layer)
    got = transcode_port(data, **kw)
    assert got == transcode_ref(data, **kw)
    layers = hevc_layer_ids(videos_of(got)["GEOMETRY"])
    assert layers == ({0} if layer == 0 else {0, 1})


@pytest.mark.parametrize("name", ["GEOMETRY", "OCCUPANCY"])
def test_payload_neither_rbv_nor_annexb_raises(rbv_stream, name):
    data = rewrite(rbv_stream, **{name: b"\x07junk" + bytes(16)})
    for run in (transcode_port, transcode_ref):
        with pytest.raises(ValueError, match="not RBV, not Annex-B"):
            run(data, geometryQP=32, attributeQP=42, occupancyPrecision=4)


def test_failing_binary_raises(mock_stream, no_binaries, tmp_path):
    """An external binary that fails raises RuntimeError in both packages:
    nothing turns it into a passthrough."""
    bad = _executable(tmp_path / "fails.sh",
                      "#!/bin/sh\necho broken >&2\nexit 3\n")
    data = rewrite(mock_stream, keep=("GEOMETRY",))
    kw = dict(geometryQP=32, videoEncoderGeometryPath=bad,
              videoDecoderGeometryPath=bad)
    for run in (transcode_port, transcode_ref):
        with pytest.raises(RuntimeError, match="external decoder failed"):
            run(data, **kw)


def test_multistream_with_a_foreign_stream(rbv_stream, intra_stream,
                                           no_binaries):
    """A foreign stream batched with RBV streams takes the single-stream
    route: every output equals the sequential port's (and the JAX
    transcoder's)."""
    streams = [rbv_stream, intra_stream,
               testdata.with_input_qps(rbv_stream, 18, 24)]
    kw = dict(geometryQP=32, attributeQP=42, occupancyPrecision=4)
    reader = bitstream.V3CReader()
    contexts = [reader.decode(_units(d, reader)) for d in streams]
    MultiStreamTranscoder(TranscoderParameters(**kw), "cpu").transcode_many(
        contexts)
    writer = bitstream.V3CWriter()
    batched = [writer.write(writer.encode(c)) for c in contexts]
    for got, data in zip(batched, streams):
        assert got == transcode_port(data, **kw)
    assert batched[1] == transcode_ref(intra_stream, **kw)


# --- the decoder (its cases: test_torch_foreign_decode.py) -------------------
def decode_port(data: bytes, **kw):
    reader = bitstream.V3CReader()
    return Decoder(DecoderParameters(**kw), "cpu").decode(
        reader.decode(_units(data, reader)))


def decode_ref(data: bytes, **kw):
    reader = ref_bitstream.V3CReader()
    return RefDecoder(RefDecoderParameters(**kw)).decode(
        reader.decode(_units(data, reader)))


def _paths(pair, components=COMPONENTS) -> dict:
    return {f"videoDecoder{c}Path": pair[1] for c in components}
