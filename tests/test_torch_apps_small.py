"""The port's small apps and app flags against the JAX package's apps on the
CPU: ``rabbit-metrics``, ``rabbit-normals``, ``rabbit-conformance``,
``rabbit-parse``, ``rabbit-video-encode`` / ``-decode``, and the flags
``--computeMetrics``, ``--checkConformance``, ``--trace`` and
``--profileDir`` of ``rabbit-decode`` and ``rabbit-transcode``.

The apps read and write files; both packages' apps get the same files and
arguments (the port's with ``--device=cpu``), and their printed metric
lines, ``enc_*`` / ``dec_*`` logs, conformance reports and written files are
equal.  Where a normal is computed, the ``D2`` line may differ in its last
printed digit (``test_torch_metrics.py`` holds the bound); it is compared
within 1e-4 dB, every other line as text."""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.apps import conformance as ref_conformance_app
from rabbit_transcoding_tpu.apps import decode as ref_decode_app
from rabbit_transcoding_tpu.apps import metrics as ref_metrics_app
from rabbit_transcoding_tpu.apps import normals as ref_normals_app
from rabbit_transcoding_tpu.apps import parser as ref_parser_app
from rabbit_transcoding_tpu.apps import transcode as ref_transcode_app
from rabbit_transcoding_tpu.apps import video_decode as ref_video_decode_app
from rabbit_transcoding_tpu.apps import video_encode as ref_video_encode_app
from rabbit_transcoding_tpu_torch.apps import conformance as conformance_app
from rabbit_transcoding_tpu_torch.apps import decode as decode_app
from rabbit_transcoding_tpu_torch.apps import metrics as metrics_app
from rabbit_transcoding_tpu_torch.apps import normals as normals_app
from rabbit_transcoding_tpu_torch.apps import parser as parser_app
from rabbit_transcoding_tpu_torch.apps import transcode as transcode_app
from rabbit_transcoding_tpu_torch.apps import video_decode as video_decode_app
from rabbit_transcoding_tpu_torch.apps import video_encode as video_encode_app
from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames
from rabbit_transcoding_tpu_torch.core.pointset import PointSet
from rabbit_transcoding_tpu_torch.testdata import (
    ENCODER_STREAM_DIR,
    load_encoder_stream,
    make_stream,
)

from test_option_parity import (
    METRICS_OPTIONS,
    NORMALS_OPTIONS,
    TRANSCODER_OPTIONS,
)
from test_torch_decoder import decode_port

STREAM = "scene_lossy_occupancy_pbf"      # 2 frames, ~11,500 points each


def _run(main, argv, cwd):
    """Run an app's main in ``cwd`` -> (return code, its lines on stdout,
    {file name: bytes} of the files in ``cwd`` afterwards)."""
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(old)
    written = {}
    for name in sorted(os.listdir(cwd)):
        path = os.path.join(cwd, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                written[name] = f.read()
    return rc, buf.getvalue().splitlines(), written


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The committed encoder stream, its source clouds as PLYs, and the
    port's decode of it as PLYs."""
    d = tmp_path_factory.mktemp("apps_small")
    data, sources, record = load_encoder_stream(STREAM)
    GroupOfFrames(sources).write(str(d / "src_%04d.ply"), 0)
    GroupOfFrames(decode_port(data)).write(str(d / "rec_%04d.ply"), 0)
    return {"stream": os.path.join(ENCODER_STREAM_DIR, STREAM + ".bin"),
            "src": str(d / "src_%04d.ply"), "rec": str(d / "rec_%04d.ply"),
            "record": record, "sources": sources}


_D2 = re.compile(r"^D2 \(p2plane\) mse, PSNR : ([0-9.]+), ([0-9.]+) dB$")


def _metric_lines(lines):
    """The lines that carry results (no wall times, no memory)."""
    return [ln for ln in lines if ln.startswith((
        "checksum frame", "frame ", "D1 ", "D2 ", "Color ", "Reflectance",
        "--- average", "hash SEI check", "conformance:", "  missing",
        "  mismatch", "  level", "csv written"))]


def assert_lines_equal(got, want) -> None:
    assert len(got) == len(want) > 0, (got, want)
    for a, b in zip(got, want):
        ma, mb = _D2.match(a), _D2.match(b)
        if ma and mb:
            assert abs(float(ma[1]) - float(mb[1])) <= 2e-6, (a, b)
            assert abs(float(ma[2]) - float(mb[2])) <= 1e-4, (a, b)
        else:
            assert a == b


# --- rabbit-metrics -----------------------------------------------------------
def test_metrics_app_equal_to_the_reference_app(files, tmp_path):
    argv = [f"--uncompressedDataPath={files['src']}",
            f"--reconstructedDataPath={files['rec']}", "--frameCount=2",
            "--csvFile=m.csv"]
    rc, out, got = _run(metrics_app.main, argv + ["--device=cpu"],
                        str(tmp_path / "port"))
    ref_rc, ref_out, want = _run(ref_metrics_app.main, argv,
                                 str(tmp_path / "ref"))
    assert rc == ref_rc == 0
    assert_lines_equal(_metric_lines(out), _metric_lines(ref_out))
    assert any(ln.startswith("--- average over 2 frames") for ln in out)
    # the csv prints 4 decimals of every PSNR
    assert got["m.csv"] == want["m.csv"]
    # the summary the app prints is the library call's, and the committed one
    summary = files["record"]["metrics_summary"]
    assert summary.print().splitlines()[0] in out
    assert summary.print().splitlines()[2:] == out[-4:-2]


def test_metrics_app_options_and_given_normals(files, tmp_path):
    """Other drop-duplicates and neighbour modes, no checksums, and normals
    from a PLY sequence: with given normals every line is equal as text."""
    n = np.zeros_like(files["sources"][0].positions, dtype=np.float32)
    n[:, 2] = 1.0
    PointSet(positions=files["sources"][0].positions, normals=n).write_ply(
        str(tmp_path / "n_0000.ply"))
    argv = [f"--uncompressedDataPath={os.path.basename(files['src'])}",
            f"--uncompressedDataFolder={os.path.dirname(files['src'])}",
            f"--reconstructedDataPath={files['rec']}",
            f"--normalDataPath={tmp_path / 'n_%04d.ply'}",
            "--dropdups=1", "--neighborsProc=3", "--resolution=511",
            "--computeChecksum=0"]
    rc, out, _ = _run(metrics_app.main, argv + ["--device=cpu"],
                      str(tmp_path / "port"))
    ref_rc, ref_out, _ = _run(ref_metrics_app.main, argv,
                              str(tmp_path / "ref"))
    assert rc == ref_rc == 0
    assert _metric_lines(out) == _metric_lines(ref_out)
    assert len(_metric_lines(out)) == 1 + 4 + 1 + 4
    assert metrics_app.main(["--device=cpu"]) == 1     # no paths given


# --- rabbit-normals (tests/test_aux_apps.py::TestNormalsApp) -------------------
def _sphere(n=500, radius=40.0, center=(64.0, 64.0, 64.0), seed=3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.round(np.asarray(center) + radius * v).astype(np.float32)


class TestNormalsApp:
    def test_cli_end_to_end(self, tmp_path):
        pts = np.unique(_sphere(n=300), axis=0)
        src = tmp_path / "frame_%04d.ply"
        PointSet(pts).write_ply(str(src) % 0)
        argv = [f"--srcPlyPath={src}", "--startFrameNumber=0",
                "--frameCount=1", "--orientationStrategy=2",
                "--viewPointX=300", "--storeEigenvalues=1",
                "--storeCentroids=1",
                "--storeNumberOfNearestNeighborsInNormalEstimation=1",
                "--dstPlyPath=out_%04d.ply"]
        rc, out, got = _run(normals_app.main, argv + ["--device=cpu"],
                            str(tmp_path / "port"))
        ref_rc, ref_out, want = _run(ref_normals_app.main, argv,
                                     str(tmp_path / "ref"))
        assert rc == ref_rc == 0 and out == ref_out
        assert sorted(got) == sorted(want) == [
            "out_0000.ply", "out_0000_centroids.npy",
            "out_0000_eigenvalues.npy", "out_0000_nncounts.npy"]
        assert got["out_0000_centroids.npy"] == want["out_0000_centroids.npy"]
        assert got["out_0000_nncounts.npy"] == want["out_0000_nncounts.npy"]
        a = PointSet.read_ply(str(tmp_path / "port" / "out_0000.ply"))
        b = PointSet.read_ply(str(tmp_path / "ref" / "out_0000.ply"))
        assert a.has_normals and len(a.normals) == len(pts)
        np.testing.assert_array_equal(a.positions, b.positions)
        # unit normals within 1e-5 rad of the reference app's
        cos = np.clip((a.normals.astype(np.float64) * b.normals).sum(axis=1),
                      -1, 1)
        assert np.arccos(cos).max() <= 2e-3      # float32 acos near 1
        assert np.abs(a.normals - b.normals).max() <= 1e-5

    def test_unused_cfg_options_accepted(self, tmp_path, capsys):
        pts = _sphere(n=100)
        src = tmp_path / "f_%04d.ply"
        PointSet(pts).write_ply(str(src) % 0)
        cfg = tmp_path / "enc.cfg"
        cfg.write_text(
            "maxPatchSize: 1024\nminNormSumOfInvDist4MPSelection: 0.35\n"
            "surfaceSeparation: 0\n")
        rc = normals_app.main(["-c", str(cfg), f"--srcPlyPath={src}",
                               "--frameCount=1", "--device=cpu"])
        assert rc == 0
        assert PointSet.read_ply(str(tmp_path / "f_0000_n.ply")).has_normals
        assert "warning" not in capsys.readouterr().err

    def test_single_file_knn_count_and_missing_source(self, tmp_path):
        pts = _sphere(n=120)
        PointSet(pts).write_ply(str(tmp_path / "one.ply"))
        assert normals_app.main([
            f"--uncompressedDataFolder={tmp_path}",
            "--uncompressedDataPath=one.ply", "--knnCount=6",
            f"--outputDataPath={tmp_path / 'one_out.ply'}",
            "--device=cpu"]) == 0
        assert PointSet.read_ply(str(tmp_path / "one_out.ply")).has_normals
        assert normals_app.main(["--device=cpu"]) == 1


# --- rabbit-decode: --computeMetrics, --checkConformance, --profileDir ---------
@pytest.fixture(scope="module")
def transcoded(files, tmp_path_factory):
    """rabbit-transcode --trace of both packages on the encoder's stream
    (the port's also with --checkConformance and --profileDir): the
    directory, and (return code, lines, files) of each."""
    d = tmp_path_factory.mktemp("transcode_app")
    argv = [f"--compressedStreamPath={files['stream']}",
            "--outStreamPath=out.bin", "--geometryQP=32", "--attributeQP=42",
            "--trace=1"]
    port = _run(transcode_app.main,
                argv + ["--device=cpu", "--profileDir=prof",
                        "--checkConformance=1", "--path=."],
                str(d / "port"))
    ref = _run(ref_transcode_app.main, argv, str(d / "ref"))
    return d, port, ref


@pytest.fixture(scope="module")
def decoded(files, transcoded):
    """rabbit-decode of both packages on the transcoded stream, each in the
    directory that holds its transcoder's enc_* logs."""
    d, _, _ = transcoded
    argv = ["--compressedStreamPath=out.bin", "--trace=1",
            "--computeMetrics=1", f"--uncompressedDataPath={files['src']}",
            "--checkConformance=1", "--path=."]
    port = _run(decode_app.main,
                argv + ["--device=cpu", "--profileDir=dprof"],
                str(d / "port"))
    ref = _run(ref_decode_app.main, argv, str(d / "ref"))
    return d, port, ref


def test_transcode_app_trace_equal_to_the_reference_app(transcoded):
    d, (rc, out, got), (ref_rc, ref_out, want) = transcoded
    assert rc == ref_rc == 0
    logs = [n for n in want if n.startswith("enc_")]
    assert "enc_pcframe.txt" in logs and "enc_hls.txt" in logs
    for n in logs + ["out.bin"]:
        assert got[n] == want[n], n
    # only enc_* logs exist yet: the comparator reports every dec_* missing
    assert "conformance: FAIL (0 log pairs compared)" in out
    assert any(ln.startswith("  missing") for ln in out)
    assert os.listdir(d / "port" / "prof") == ["rabbit-transcode.pt.trace.json"]
    assert os.path.getsize(
        d / "port" / "prof" / "rabbit-transcode.pt.trace.json") > 1000
    assert "profiler trace written to prof" in out


def test_decode_app_metrics_conformance_and_profile(decoded):
    """rabbit-decode on the transcoded stream: the metric summary, the
    conformance report (PASS: every enc_/dec_ pair equal) and the dec_* logs
    equal the reference app's."""
    d, (rc, out, got), (ref_rc, ref_out, want) = decoded
    assert rc == ref_rc == 0
    assert_lines_equal(_metric_lines(out), _metric_lines(ref_out))
    kept = _metric_lines(out)
    assert any(ln.startswith("D1 (p2point)") for ln in kept)
    assert "conformance: PASS (4 log pairs compared)" in kept
    for n in [n for n in want if n.startswith("dec_")]:
        assert got[n] == want[n], n
    assert os.listdir(d / "port" / "dprof") == ["rabbit-decode.pt.trace.json"]


def test_conformance_app_equal_to_the_reference_app(decoded, tmp_path):
    """Both directories hold every log pair: PASS and return code 0 from
    both apps; on a directory with a broken pair, FAIL and 1, with equal
    reports."""
    d, _, _ = decoded
    os.makedirs(tmp_path / "broken")
    for n in os.listdir(d / "port"):
        if n.startswith(("enc_", "dec_")):
            text = (d / "port" / n).read_text()
            if n == "dec_pcframe.txt":
                text = text.replace("checksum = ", "checksum = 0", 1)
            (tmp_path / "broken" / n).write_text(text)
    for path, want_rc in ((d / "port", 0), (tmp_path / "broken", 1)):
        argv = [f"--path={path}"]
        rc, out, _ = _run(conformance_app.main, argv, str(tmp_path))
        ref_rc, ref_out, _ = _run(ref_conformance_app.main, argv,
                                  str(tmp_path))
        assert rc == ref_rc == want_rc
        assert out == ref_out and out[0].startswith("conformance: ")


# --- rabbit-parse, rabbit-video-encode, rabbit-video-decode --------------------
def test_parser_app_equal_to_the_reference_app(files, tmp_path):
    port_stream = tmp_path / "patches.bin"
    port_stream.write_bytes(make_stream(2, 128, 128, patches=True,
                                        map_pair=True))
    for path in (files["stream"], str(port_stream)):
        rc, out, _ = _run(parser_app.main, [f"--bin={path}"],
                          str(tmp_path / "p"))
        ref_rc, ref_out, _ = _run(ref_parser_app.main, [f"--bin={path}"],
                                  str(tmp_path / "r"))
        assert rc == ref_rc == 0
        assert out == ref_out and any(" RBV " in ln for ln in out)
        assert any(ln.startswith("  ASPS") for ln in out)
    assert parser_app.main([]) == 1


def test_parser_app_names_item_9b_for_foreign_payloads(tmp_path):
    from rabbit_transcoding_tpu_torch.bitstream import V3CReader, V3CWriter

    reader = V3CReader()
    context = reader.decode(reader.read(make_stream(2, 64, 64))[0])
    for vb in context.atlas(0).video_bitstreams.values():
        vb.data = b"\x00\x00\x00\x01\x40\x01" + bytes(40)
    writer = V3CWriter()
    path = tmp_path / "foreign.bin"
    path.write_bytes(writer.write(writer.encode(context)))
    with pytest.raises(NotImplementedError, match="queue 1 item 9b"):
        parser_app.main([f"--bin={path}"])


@pytest.mark.parametrize("fmt,depth,extra", [
    ("yuv420", 8, ["--qp=30", "--gopSize=2"]),
    ("yuv400", 10, ["--qp=22", "--allIntra=1"]),
    ("yuv444", 8, ["--lossless=1"]),
])
def test_video_apps_equal_to_the_reference_apps(fmt, depth, extra, tmp_path):
    """A raw YUV file through rabbit-video-encode and -decode of both
    packages: equal payload bytes, equal decoded files, equal lines."""
    rng = np.random.default_rng(11)
    w, h, f = 64, 48, 3
    planes = {"yuv400": [(h, w)], "yuv420": [(h, w), (h // 2, w // 2)] + [
        (h // 2, w // 2)], "yuv444": [(h, w)] * 3}[fmt]
    yy, xx = np.mgrid[0:h, 0:w]
    raw = bytearray()
    for t in range(f):
        for (ph, pw) in planes:
            img = (((xx[:ph, :pw] * 3 + yy[:ph, :pw] * 2 + 7 * t)
                    % (1 << depth)) + rng.integers(0, 3, (ph, pw)))
            img = np.clip(img, 0, (1 << depth) - 1)
            raw += img.astype(np.uint8 if depth == 8 else "<u2").tobytes()
    (tmp_path / "in.yuv").write_bytes(bytes(raw))
    enc = [f"--videoPath={tmp_path / 'in.yuv'}", "--bin=v.rbv",
           f"--width={w}", f"--height={h}", f"--frameCount={f}",
           f"--inputBitDepth={depth}", f"--format={fmt}"] + extra
    dec = ["--bin=v.rbv", "--videoPath=out.yuv"]
    results = []
    for e_app, d_app, dev, sub in (
            (video_encode_app, video_decode_app, ["--device=cpu"], "port"),
            (ref_video_encode_app, ref_video_decode_app, [], "ref")):
        rc1, out1, _ = _run(e_app.main, enc + dev, str(tmp_path / sub))
        rc2, out2, written = _run(d_app.main, dec + dev,
                                  str(tmp_path / sub))
        assert rc1 == rc2 == 0
        results.append((out1, out2, written))
    assert results[0][0] == results[1][0] and results[0][1] == results[1][1]
    assert results[0][2]["v.rbv"] == results[1][2]["v.rbv"]
    assert results[0][2]["out.yuv"] == results[1][2]["out.yuv"]
    assert len(results[0][2]["out.yuv"]) == len(raw)
    if "--lossless=1" in extra:
        assert results[0][2]["out.yuv"] == bytes(raw)
    assert video_encode_app.main(["--device=cpu"]) == 1
    assert video_decode_app.main(["--device=cpu"]) == 1


# --- option tables and the device ----------------------------------------------
_APPS = {
    "metrics": (metrics_app, ref_metrics_app, METRICS_OPTIONS, True),
    "normals": (normals_app, ref_normals_app, NORMALS_OPTIONS, True),
    "transcode": (transcode_app, ref_transcode_app, TRANSCODER_OPTIONS, True),
    "conformance": (conformance_app, ref_conformance_app, [], False),
    "parser": (parser_app, ref_parser_app, [], False),
    "video_encode": (video_encode_app, ref_video_encode_app, [], True),
    "video_decode": (video_decode_app, ref_video_decode_app, [], True),
}


@pytest.mark.parametrize("name", list(_APPS))
def test_option_table_is_the_reference_s_plus_device(name, monkeypatch):
    """The pattern of tests/test_option_parity.py: every option of the
    reference app, with its default, and ``device`` (default ``cuda``) where
    the app touches the device."""
    port, ref, options, has_device = _APPS[name]
    seen = {}
    for key, mod in (("port", port), ("ref", ref)):
        monkeypatch.setattr(
            mod, "parse_or_help",
            lambda reg, argv, params, title, key=key: seen.__setitem__(
                key, (reg, title)))
        assert mod.main([]) == 0
    (reg, title), (ref_reg, ref_title) = seen["port"], seen["ref"]
    assert title == ref_title
    ref_names = set(ref_reg.values) - {"shardingMesh"}
    assert set(reg.values) == ref_names | ({"device"} if has_device else set())
    for n in ref_names:
        assert reg[n] == ref_reg[n], n
    if has_device:
        assert reg["device"] == "cuda"
    assert not [o for o in options if o not in reg]


@pytest.mark.parametrize("name", [n for n, a in _APPS.items() if a[3]])
def test_apps_need_a_card_unless_asked_for_the_cpu(name, files, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "v.rbv").write_bytes(b"RBV")
    argv = {
        "metrics": [f"--uncompressedDataPath={files['src']}",
                    f"--reconstructedDataPath={files['rec']}"],
        "normals": [f"--srcPlyPath={files['src']}"],
        "transcode": [f"--compressedStreamPath={files['stream']}"],
        "video_encode": ["--videoPath=v.rbv", "--width=16", "--height=16"],
        "video_decode": ["--bin=v.rbv"],
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _APPS[name][0].main(argv)


def test_not_ported_tables_are_gone():
    assert not hasattr(decode_app, "_NOT_PORTED")
    assert not hasattr(transcode_app, "_NOT_PORTED")
