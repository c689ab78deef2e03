"""The PyTorch port imports neither JAX, nor the JAX package, nor Triton,
and loads no CUDA library when imported (the machine with the GPU has no
JAX)."""

import ast
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
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK.format(imports=imports)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
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
    bad = {
        str(f.relative_to(ROOT)): sorted(
            m for m in _imported_modules(f)
            if m.split(".")[0] in ("rabbit_transcoding_tpu", "jax", "jaxlib"))
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}
