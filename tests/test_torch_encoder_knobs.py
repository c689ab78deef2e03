"""Encoder knobs through both encoders at a tiny size (two frames of ~4,400
points, a 256-wide atlas): the V3C bytes and the closed-loop clouds'
checksums of the port (CPU, given the JAX normals: ``encode_both``) equal
the JAX encoder's.  One module-scoped JAX encode per configuration; the
other knobs are in ``test_torch_encoder_knobs_more.py`` and
``test_torch_encoder_one_map.py`` (each file stays under a minute).  Also
``rabbit-encode`` on tiny PLYs against the JAX app.  No tolerance: bytes."""

import pytest

from rabbit_transcoding_tpu.apps import encode as ref_app
from rabbit_transcoding_tpu.core.gof import GroupOfFrames as RefGroupOfFrames
from rabbit_transcoding_tpu_torch.apps import encode as app

from test_torch_encoder import (  # noqa: F401 (an autouse fixture)
    KNOB_BASE, encode_both, knob_clouds, one_torch_thread, same_normals)

KNOBS = {
    "defaults": dict(),
    "enhanced_projection_plane": dict(enhancedProjectionPlane=True),
    "patch_color_subsampling": dict(patchColorSubsampling=True),
    "harmonic_background_fill": dict(attributeBGFill=2),
}


@pytest.fixture(scope="module")
def encodes():
    cache = {}
    clouds = knob_clouds()

    def get(name):
        if name not in cache:
            cache[name] = encode_both({**KNOB_BASE, **KNOBS[name]}, clouds)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(KNOBS))
def test_knob_bytes_equal(encodes, name):
    (want, want_sums), (got, got_sums) = encodes(name)
    assert len(want) > 500
    assert got == want
    assert got_sums == want_sums


def test_encode_app_writes_the_reference_apps_bytes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    RefGroupOfFrames(knob_clouds()).write("src_%04d.ply", 0)
    args = ["--uncompressedDataPath=src_%04d.ply"] + [
        f"--{k}={v}" for k, v in KNOB_BASE.items()]
    with same_normals():
        assert ref_app.main(args + ["--compressedStreamPath=ref.bin"]) == 0
        assert app.main(args + ["--compressedStreamPath=port.bin",
                                "--device=cpu"]) == 0
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    assert (tmp_path / "timings.txt").exists()
