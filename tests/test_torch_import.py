"""The PyTorch port imports neither JAX, nor the JAX package, nor Triton,
and loads no CUDA library when imported (the machine with the GPU has no
JAX)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHECK = """
import sys
{imports}
from rabbit_transcoding_tpu_torch.ops import _build
bad = [m for m in ("jax", "jaxlib", "triton") if m in sys.modules]
assert not bad, bad
assert _build._lib is None, "a CUDA library was loaded at import"
print("ok")
"""


def _run(imports: str) -> None:
    # one OpenMP thread: the tier-1 run's other test processes share the
    # host's cores
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK.format(imports=imports)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    # the last line: an app run by the check prints its own lines first
    assert proc.returncode == 0 and proc.stdout.split()[-1:] == ["ok"], (
        proc.stderr)


def test_main_path_modules_import_without_jax():
    _run(
        "import rabbit_transcoding_tpu_torch\n"
        "import rabbit_transcoding_tpu_torch.transcoder.transcoder\n"
        "import rabbit_transcoding_tpu_torch.apps.transcode\n"
        "import rabbit_transcoding_tpu_torch.testdata\n"
    )


def test_multistream_modules_import_without_jax():
    _run(
        "import rabbit_transcoding_tpu_torch.parallel.multistream\n"
        "import rabbit_transcoding_tpu_torch.transcoder.multistream\n"
        "import rabbit_transcoding_tpu_torch.apps.stream\n"
        "import rabbit_transcoding_tpu_torch.ops.dilate\n"
    )


def test_decoder_modules_import_without_jax():
    _run(
        "import rabbit_transcoding_tpu_torch.decoder.decoder\n"
        "import rabbit_transcoding_tpu_torch.codec.reconstruct\n"
        "import rabbit_transcoding_tpu_torch.codec.postprocess\n"
        "import rabbit_transcoding_tpu_torch.apps.decode\n"
        "import rabbit_transcoding_tpu_torch.ops.smoothing\n"
    )


def test_mesh_modules_import_without_jax():
    _run(
        "import rabbit_transcoding_tpu_torch.parallel.mesh\n"
        "import rabbit_transcoding_tpu_torch.parallel.pipeline\n"
        "from rabbit_transcoding_tpu_torch.metrics.metrics import "
        "d1_psnr_sharded\n"
        "from rabbit_transcoding_tpu_torch.parallel.mesh import make_mesh\n"
        "import torch\n"
        "make_mesh([torch.device('cpu')] * 4)\n"
    )


def test_every_module_imports_without_jax():
    _run(
        "import importlib, pkgutil, rabbit_transcoding_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
    )


def test_cpu_transcode_leaves_the_reference_and_jax_unimported():
    # every module of the port, then a whole transcode on the CPU
    _run(
        "import importlib, pkgutil, rabbit_transcoding_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from rabbit_transcoding_tpu_torch.testdata import make_stream\n"
        "from rabbit_transcoding_tpu_torch.transcoder import (\n"
        "    Transcoder, V3CReader, V3CWriter)\n"
        "reader = V3CReader()\n"
        "context = reader.decode(reader.read(make_stream(2, 64, 64))[0])\n"
        "Transcoder(device='cpu').transcode(context)\n"
        "writer = V3CWriter()\n"
        "assert writer.write(writer.encode(context))\n"
        "ref = [m for m in sys.modules if m == 'rabbit_transcoding_tpu'\n"
        "       or m.startswith('rabbit_transcoding_tpu.')]\n"
        "assert not ref, ref\n"
    )


def test_cpu_decode_leaves_the_reference_and_jax_unimported(tmp_path):
    # a patch-carrying stream through the decoder and the decode app
    _run(
        "import os\n"
        "from rabbit_transcoding_tpu_torch.apps import decode\n"
        "from rabbit_transcoding_tpu_torch.bitstream import V3CReader\n"
        "from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder\n"
        "from rabbit_transcoding_tpu_torch.testdata import make_stream\n"
        "data = make_stream(2, 128, 128, patches=True, smoothing=True)\n"
        "reader = V3CReader()\n"
        "clouds = Decoder(device='cpu').decode(\n"
        "    reader.decode(reader.read(data)[0]))\n"
        "assert sum(ps.point_count for ps in clouds) > 1000\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "open('in.bin', 'wb').write(data)\n"
        "assert decode.main(['--compressedStreamPath=in.bin',\n"
        "                    '--reconstructedDataPath=r_%04d.ply',\n"
        "                    '--trace=1', '--device=cpu']) == 0\n"
        "assert os.path.exists('r_0001.ply')\n"
        "ref = [m for m in sys.modules if m == 'rabbit_transcoding_tpu'\n"
        "       or m.startswith('rabbit_transcoding_tpu.')]\n"
        "assert not ref, ref\n"
    )


def test_cpu_metrics_leave_the_reference_and_jax_unimported(tmp_path):
    # a committed encoder stream decoded, its normals and metrics on the
    # CPU, then the metrics and normals apps on the PLYs
    _run(
        "import os\n"
        "from rabbit_transcoding_tpu_torch.apps import metrics, normals\n"
        "from rabbit_transcoding_tpu_torch.bitstream import V3CReader\n"
        "from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames\n"
        "from rabbit_transcoding_tpu_torch.decoder.decoder import Decoder\n"
        "from rabbit_transcoding_tpu_torch.metrics.metrics import (\n"
        "    compute_sequence_metrics)\n"
        "from rabbit_transcoding_tpu_torch.testdata import (\n"
        "    load_encoder_stream)\n"
        "data, sources, record = load_encoder_stream(\n"
        "    'sphere_eom_lossless')\n"
        "reader = V3CReader()\n"
        "clouds = Decoder(device='cpu').decode(\n"
        "    reader.decode(reader.read(data)[0]))\n"
        "_, got = compute_sequence_metrics(sources, clouds, device='cpu')\n"
        "assert got.color_psnr == record['metrics_summary'].color_psnr\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "GroupOfFrames(sources).write('s_%04d.ply', 0)\n"
        "GroupOfFrames(clouds).write('r_%04d.ply', 0)\n"
        "assert normals.main(['--srcPlyPath=s_%04d.ply',\n"
        "                     '--device=cpu']) == 0\n"
        "assert metrics.main(['--uncompressedDataPath=s_%04d.ply',\n"
        "                     '--reconstructedDataPath=r_%04d.ply',\n"
        "                     '--normalDataPath=s_%04d_n.ply',\n"
        "                     '--device=cpu']) == 0\n"
        "ref = [m for m in sys.modules if m == 'rabbit_transcoding_tpu'\n"
        "       or m.startswith('rabbit_transcoding_tpu.')]\n"
        "assert not ref, ref\n"
    )


def test_cpu_encode_leaves_the_reference_and_jax_unimported(tmp_path):
    # the encoder on a committed source, then the encode app on its PLYs
    _run(
        "import os\n"
        "from rabbit_transcoding_tpu_torch.apps import encode\n"
        "from rabbit_transcoding_tpu_torch.bitstream import V3CWriter\n"
        "from rabbit_transcoding_tpu_torch.core.gof import GroupOfFrames\n"
        "from rabbit_transcoding_tpu_torch.encoder.encoder import Encoder\n"
        "from rabbit_transcoding_tpu_torch.encoder.params import (\n"
        "    EncoderParameters)\n"
        "from rabbit_transcoding_tpu_torch.testdata import (\n"
        "    load_encoder_stream)\n"
        "data, sources, record = load_encoder_stream(\n"
        "    'sphere_eom_lossless')\n"
        "params = EncoderParameters(**record['encoder_parameters'])\n"
        "context, _ = Encoder(params, 'cpu').encode(GroupOfFrames(sources))\n"
        "writer = V3CWriter()\n"
        "assert writer.write(writer.encode(context)) == data\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "GroupOfFrames(sources).write('s_%04d.ply', 0)\n"
        "assert encode.main(['--uncompressedDataPath=s_%04d.ply',\n"
        "                    '--frameCount=1', '--minimumImageWidth=256',\n"
        "                    '--compressedStreamPath=o.bin',\n"
        "                    '--device=cpu']) == 0\n"
        "assert os.path.getsize('o.bin') > 1000\n"
        "ref = [m for m in sys.modules if m == 'rabbit_transcoding_tpu'\n"
        "       or m.startswith('rabbit_transcoding_tpu.')]\n"
        "assert not ref, ref\n"
    )


def test_cpu_foreign_transcode_leaves_the_reference_and_jax_unimported(
        tmp_path):
    # a stream of the in-tree HEVC subsets through the transcoder, and one
    # of the stand-in codec through the transcoder and the decoder with the
    # stand-in binaries (child processes of their own)
    _run(
        "from rabbit_transcoding_tpu_torch import testdata\n"
        "from rabbit_transcoding_tpu_torch.decoder.decoder import (\n"
        "    Decoder, DecoderParameters)\n"
        "from rabbit_transcoding_tpu_torch.transcoder import (\n"
        "    Transcoder, TranscoderParameters, V3CReader, V3CWriter)\n"
        "data = testdata.make_stream(2, 128, 128, patches=True)\n"
        f"enc, dec = testdata.write_codec_wrappers({str(tmp_path)!r})\n"
        "reader, writer = V3CReader(), V3CWriter()\n"
        "for codec, paths in (('intra', {}), ('mock', {\n"
        "        'videoEncoderGeometryPath': enc,\n"
        "        'videoDecoderGeometryPath': dec})):\n"
        "    foreign = testdata.to_foreign(data, codec=codec)\n"
        "    context = reader.decode(reader.read(foreign)[0])\n"
        "    Transcoder(TranscoderParameters(geometryQP=34, **paths),\n"
        "               'cpu').transcode(context)\n"
        "    out = writer.write(writer.encode(context))\n"
        "    assert out != foreign\n"
        "clouds = Decoder(DecoderParameters(\n"
        "    videoDecoderOccupancyPath=dec, videoDecoderGeometryPath=dec,\n"
        "    videoDecoderAttributePath=dec), 'cpu').decode(\n"
        "    reader.decode(reader.read(out)[0]))\n"
        "assert sum(ps.point_count for ps in clouds) > 1000\n"
        "ref = [m for m in sys.modules if m == 'rabbit_transcoding_tpu'\n"
        "       or m.startswith('rabbit_transcoding_tpu.')]\n"
        "assert not ref, ref\n"
    )


def test_the_stand_in_codec_imports_no_torch():
    # the stand-in's child processes start without torch (and so quickly)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import rabbit_transcoding_tpu_torch.mock_hevc\n"
         "import rabbit_transcoding_tpu_torch.video.hevc_intra\n"
         "bad = [m for m in ('torch', 'jax', 'rabbit_transcoding_tpu')\n"
         "       if m in sys.modules]\n"
         "assert not bad, bad\n"
         "print('ok')\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["ok"], (
        proc.stderr)


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_no_source_of_the_port_imports_the_reference_or_jax():
    files = sorted((ROOT / "rabbit_transcoding_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 55
    assert ROOT / "rabbit_transcoding_tpu_torch/metrics/metrics.py" in files
    assert ROOT / "rabbit_transcoding_tpu_torch/apps/decode.py" in files
    assert ROOT / "rabbit_transcoding_tpu_torch/encoder/encoder.py" in files
    # the foreign route's modules and the stand-in codec
    for name in ("video/hevc_probe.py", "video/codec_group.py",
                 "video/hevc_ipcm.py", "video/hevc_intra.py",
                 "video/shvc.py", "video/external.py", "video/hdrtools.py",
                 "transcoder/foreign.py", "conformance/refgate.py",
                 "mock_hevc.py"):
        assert ROOT / "rabbit_transcoding_tpu_torch" / name in files
    bad = {
        str(f.relative_to(ROOT)): sorted(
            m for m in _imported_modules(f)
            if m.split(".")[0] in ("rabbit_transcoding_tpu", "jax", "jaxlib"))
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}
