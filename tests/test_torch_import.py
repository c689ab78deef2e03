"""The PyTorch port imports neither JAX nor Triton, and loads no CUDA
library when imported (the machine with the GPU has no JAX)."""

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
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


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


def test_every_module_imports_without_jax():
    _run(
        "import importlib, pkgutil, rabbit_transcoding_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
    )
