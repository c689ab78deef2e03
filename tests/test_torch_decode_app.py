"""The port's rabbit-decode app against the JAX package's on the CPU, on the
same stream files: PLY bytes, checksum and hash-SEI lines, the ``dec_*``
conformance logs, the option table; and ``rabbit-stream --trace`` against the
reference app's ``enc_*`` logs.  The apps read and write files; nothing else
passes between the packages."""

import os

import pytest
import torch

from rabbit_transcoding_tpu import bitstream as ref_bitstream
from rabbit_transcoding_tpu.apps import decode as ref_app
from rabbit_transcoding_tpu.apps import stream as ref_stream_app
from rabbit_transcoding_tpu.core.gof import GroupOfFrames
from rabbit_transcoding_tpu.encoder.encoder import Encoder
from rabbit_transcoding_tpu.encoder.params import EncoderParameters
from rabbit_transcoding_tpu_torch.apps import decode as app
from rabbit_transcoding_tpu_torch.apps import stream as stream_app
from rabbit_transcoding_tpu_torch.testdata import make_stream

from test_e2e_codec import make_sphere_cloud
from test_option_parity import DECODER_OPTIONS
from test_torch_stream_app import _write_gofs


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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_app")
    context, _ = Encoder(EncoderParameters(
        minimumImageWidth=256, minimumImageHeight=64, geometryQP=12,
        attributeQP=20, occupancyPrecision=2, frameCount=1,
        groupOfFramesSize=1,
    )).encode(GroupOfFrames([make_sphere_cloud(seed=7)]))
    writer = ref_bitstream.V3CWriter()
    writer.write_file(writer.encode(context), str(d / "encoder.bin"))
    return {
        # 2 GOFs of the port's patch-carrying stream
        "patches": _write_gofs(d / "patches.bin", [
            make_stream(2, 128, 128, patches=True, smoothing=True),
            make_stream(2, 128, 128, patches=True, motion=True, intra=True),
        ]),
        # the reference encoder's stream
        "encoder": str(d / "encoder.bin"),
    }


def _run(main, argv, cwd, capsys):
    """Run an app's main in ``cwd`` -> (return code, its lines on stdout,
    {file name: bytes} of what it wrote there)."""
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        capsys.readouterr()
        rc = main(argv)
        out = capsys.readouterr().out.splitlines()
    finally:
        os.chdir(old)
    written = {}
    for name in sorted(os.listdir(cwd)):
        if os.path.isfile(os.path.join(cwd, name)):
            with open(os.path.join(cwd, name), "rb") as f:
                written[name] = f.read()
    return rc, out, written


def _kept(lines):
    return [ln for ln in lines
            if ln.startswith(("checksum frame", "hash SEI check"))]


@pytest.mark.parametrize("name", ["patches", "encoder"])
def test_decode_app_equal_to_the_reference_app(files, name, tmp_path,
                                               capsys):
    argv = [f"--compressedStreamPath={files[name]}",
            "--reconstructedDataPath=rec_%04d.ply", "--trace=1",
            "--startFrameNumber=3"]
    rc, out, got = _run(app.main, argv + ["--device=cpu"],
                        str(tmp_path / "port"), capsys)
    ref_rc, ref_out, want = _run(ref_app.main, argv, str(tmp_path / "ref"),
                                 capsys)
    assert rc == ref_rc == 0
    assert _kept(out) == _kept(ref_out) and _kept(out)
    plys = [n for n in want if n.endswith(".ply")]
    logs = [n for n in want if n.startswith("dec_")]
    assert plys and plys[0] == "rec_0003.ply" and "dec_pcframe.txt" in logs
    for n in plys + logs:
        assert got[n] == want[n], n
    assert "timings_decoder.txt" in got


def test_option_table_is_the_reference_s_plus_device(monkeypatch):
    seen = {}
    for key, mod in (("port", app), ("ref", ref_app)):
        monkeypatch.setattr(
            mod, "parse_or_help",
            lambda reg, argv, params, title, key=key: seen.__setitem__(
                key, reg))
        assert mod.main([]) == 0
    port_names = set(seen["port"].values)
    ref_names = set(seen["ref"].values)
    # shardingMesh takes a Mesh object, not a flag: no app registers it
    assert port_names == (ref_names - {"shardingMesh"}) | {"device"}
    for name in port_names - {"device"}:
        assert seen["port"][name] == seen["ref"][name], name
    assert seen["port"]["device"] == "cuda"
    missing = [o for o in DECODER_OPTIONS if o not in seen["port"]]
    assert not missing


@pytest.mark.parametrize("option,item", [
    ("--computeMetrics=1", 7), ("--checkConformance=1", 9),
    ("--profileDir=prof", 9)])
def test_options_not_ported_name_their_roadmap_item(files, option, item,
                                                    tmp_path, capsys):
    """These flags named their ROADMAP item until items 7 and 9a ported
    them; now each runs (``tests/test_torch_apps_small.py`` holds their
    output against the reference app's), and the table of flags that are
    not ported is gone."""
    assert not hasattr(app, "_NOT_PORTED")
    rc, _, _ = _run(app.main, [f"--compressedStreamPath={files['patches']}",
                               "--reconstructedDataPath=rec_%04d.ply",
                               "--device=cpu"], str(tmp_path), capsys)
    assert rc == 0
    rc, out, got = _run(
        app.main, [f"--compressedStreamPath={files['patches']}", option,
                   "--uncompressedDataPath=rec_%04d.ply", "--device=cpu"],
        str(tmp_path), capsys)
    assert rc == 0
    marker = {"--computeMetrics=1": "D1 (p2point) mse, PSNR : 0.000000, inf",
              "--checkConformance=1": "conformance: ",
              "--profileDir=prof": "profiler trace written to prof"}[option]
    assert any(ln.startswith(marker) for ln in out), out
    assert os.path.isdir(tmp_path / "prof") == (option == "--profileDir=prof")


def test_decode_app_needs_a_card_unless_asked_for_the_cpu(files,
                                                          monkeypatch,
                                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([f"--compressedStreamPath={files['patches']}"])
    assert app.main([]) == 1          # no stream named


def test_stream_app_trace_equal_to_the_reference_app(files, tmp_path,
                                                     capsys):
    argv = [f"--compressedStreamPath={files['patches']}",
            "--outStreamPath=out.bin", "--geometryQP=28", "--attributeQP=38",
            "--trace=1"]
    rc, _, got = _run(stream_app.main, argv + ["--device=cpu"],
                      str(tmp_path / "port"), capsys)
    ref_rc, _, want = _run(ref_stream_app.main, argv, str(tmp_path / "ref"),
                           capsys)
    assert rc == ref_rc == 0
    logs = [n for n in want if n.startswith("enc_")]
    assert "enc_pcframe.txt" in logs and "enc_hls.txt" in logs
    for n in logs + ["out.bin"]:
        assert got[n] == want[n], n
    assert b"gof_1_atlas_0_frame_1_checksum" in got["enc_pcframe.txt"]
    # the conformance pair: rabbit-decode --trace on the written stream
    # logs the same values under dec_*
    out_path = str(tmp_path / "port" / "out.bin")
    rc, out, dec = _run(app.main, [f"--compressedStreamPath={out_path}",
                                   "--trace=1", "--device=cpu"],
                        str(tmp_path / "dec"), capsys)
    assert rc == 0
    # the transcoder wrote a hash SEI per GOF, and the decoded atlas agrees
    assert out.count("hash SEI check: OK") == 2
    for n in logs:
        assert dec["dec_" + n[4:]] == got[n], n
