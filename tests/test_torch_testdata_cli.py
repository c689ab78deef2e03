"""The port's cloud-writing CLI (``python -m rabbit_transcoding_tpu_torch.
testdata``) against the JAX package's: the same PLY bytes for the same
arguments."""

import pytest

from rabbit_transcoding_tpu import testdata as ref_testdata
from rabbit_transcoding_tpu_torch import testdata


@pytest.mark.parametrize("scene", ["sphere", "blobs", "dense"])
def test_main_writes_the_reference_plys(tmp_path, capsys, scene):
    args = ["--frames", "2", "--points", "3000", "--start", "3",
            "--scene", scene]
    assert testdata.main(args + ["--out", str(tmp_path / "p_%04d.ply")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert ref_testdata.main(
        args + ["--out", str(tmp_path / "r_%04d.ply")]) == 0
    assert [ln.replace("/r_", "/p_")
            for ln in capsys.readouterr().out.splitlines()] == lines
    for f in (3, 4):
        got = (tmp_path / f"p_{f:04d}.ply").read_bytes()
        assert got == (tmp_path / f"r_{f:04d}.ply").read_bytes()
        assert got.startswith(b"ply\n")
