"""The port's shell loop ``rabbit_transcoding_tpu_torch/scripts/transcode.sh``
(``DEVICE=cpu``) against the JAX package's apps called by ``python -m`` with
the same arguments: the same encoded and transcoded streams, byte for byte.
The ``rabbit-*`` console scripts are the JAX package's and are not on the
path here, so the reference side is run through its modules."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "rabbit_transcoding_tpu_torch" / "scripts"


def _ref_app(app: str, args: list[str], cwd: Path) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-m", f"rabbit_transcoding_tpu.{app}",
                    *args], cwd=cwd, env=env, check=True,
                   capture_output=True, timeout=600)


def test_transcode_sh_writes_the_jax_apps_bytes(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "ref"
    env = dict(os.environ, DEVICE="cpu", WORK=str(port), OMP_NUM_THREADS="1")
    log = tmp_path / "transcode_sh.log"
    # the loop runs in its own process while the reference apps run
    with open(log, "w") as fh, subprocess.Popen(
            ["bash", str(SCRIPTS / "transcode.sh")], cwd=tmp_path, env=env,
            stdout=fh, stderr=subprocess.STDOUT) as proc:
        ref.mkdir()
        cfg = ROOT / "cfg"
        _ref_app("testdata", ["--frames", "4", "--out",
                              str(ref / "cloud_%04d.ply")], tmp_path)
        _ref_app("apps.encode", [
            f"--config={cfg}/common/ctc-common.cfg",
            f"--config={cfg}/condition/ctc-random-access.cfg",
            f"--config={cfg}/rate/ctc-r5.cfg",
            f"--uncompressedDataPath={ref}/cloud_%04d.ply", "--frameCount=4",
            "--minimumImageWidth=512",
            f"--reconstructedDataPath={ref}/rec_%04d.ply",
            f"--compressedStreamPath={ref}/sphere_r5.bin"], tmp_path)
        _ref_app("apps.transcode", [
            f"--compressedStreamPath={ref}/sphere_r5.bin",
            f"--outStreamPath={ref}/transcoded.bin",
            "--test_name=test_transcode", "--preset=veryfast",
            "--pixelFormat=yuv420p", "--geometryQP=32", "--attributeQP=42",
            "--occupancyPrecision=2", "--rate_mode=qp"], tmp_path)
        proc.wait(timeout=600)
    out = log.read_text()
    assert proc.returncode == 0, out[-2000:]
    assert "average over 4 frames" in out
    assert sorted(p.name for p in port.glob("dec_*.ply")) == [
        f"dec_{i:04d}.ply" for i in range(4)]
    for name in ("cloud_0003.ply", "sphere_r5.bin", "transcoded.bin"):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
