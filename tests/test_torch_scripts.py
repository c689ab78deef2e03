"""The port's twins of ``scripts/scaling.py``, ``scripts/rbv_rd.py`` and
``scripts/endurance_metrics.py`` (under ``rabbit_transcoding_tpu_torch/
scripts/``) against the JAX package and the original scripts, on the CPU:
equal payloads and transcodes, RD points and BD-rates, drift rows."""

import importlib.util
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rabbit_transcoding_tpu.core.image import Video as RefVideo
from rabbit_transcoding_tpu.parallel.mesh import make_mesh as ref_make_mesh
from rabbit_transcoding_tpu.parallel.multistream import (
    transcode_payloads as ref_transcode_payloads,
)
from rabbit_transcoding_tpu.utils.enums import ColorFormat as RefColorFormat
from rabbit_transcoding_tpu.video import rbv as ref_rbv
from rabbit_transcoding_tpu_torch import testdata
from rabbit_transcoding_tpu_torch.core.image import Video
from rabbit_transcoding_tpu_torch.core.pointset import PointSet
from rabbit_transcoding_tpu_torch.parallel.mesh import make_mesh
from rabbit_transcoding_tpu_torch.parallel.multistream import (
    transcode_payloads,
)
from rabbit_transcoding_tpu_torch.scripts import (
    endurance_metrics, rbv_rd, scaling,
)
from rabbit_transcoding_tpu_torch.utils.enums import ColorFormat

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    tier-1 run puts six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# scaling.py


def _ref_payload(qp: int, mc: bool) -> bytes:
    """``payload()`` of the original's worker (``scripts/scaling.py:46-55``)
    through the JAX package."""
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.stack([
        (300 + 200 * np.sin((xx + yy) / 9.0 + i)).astype(np.uint16)
        for i in range(8)
    ])
    v = RefVideo(w, h, 10, RefColorFormat.YUV400, [frames])
    return ref_rbv.encode(v, ref_rbv.RbvParams(qp=qp, gop_size=4,
                                               motion=mc))[0]


@pytest.fixture(scope="module")
def scaling_payloads():
    ref = [_ref_payload(16 + 2 * (i % 4), mc=(i % 2 == 1)) for i in range(8)]
    return ref, scaling.payloads("cpu")


def test_scaling_payloads_equal_the_reference(scaling_payloads):
    ref, got = scaling_payloads
    assert len(got) == scaling.N_PAYLOADS == 8
    assert got == ref


@pytest.mark.parametrize("n", [1, 2, 4])
def test_scaling_transcodes_equal_the_reference_mesh(scaling_payloads, n):
    ref, got = scaling_payloads
    devices, virtual = scaling.mesh_devices(n, "cpu")
    assert virtual and len(devices) == n
    mesh = make_mesh(devices)
    ref_mesh = ref_make_mesh(jax.devices()[:n])
    assert mesh.shape == ref_mesh.devices.shape
    assert transcode_payloads(got, 32, mesh=mesh) == ref_transcode_payloads(
        ref, 32, mesh=ref_mesh)


def test_scaling_csv_keeps_the_reference_columns(tmp_path, capsys):
    out = tmp_path / "scaling.csv"
    assert scaling.main(["--counts", "1,2", "--out", str(out),
                         "--device", "cpu"]) == 0
    lines = out.read_text().splitlines()
    caveat = [ln for ln in lines if ln.startswith("#")]
    assert caveat and "virtual rows" in caveat[-1] + caveat[0]
    assert "[1, 2]" in "\n".join(caveat)  # both rows virtual on the CPU
    rows = [ln.split(";") for ln in lines if not ln.startswith("#")]
    assert rows[0] == ["devices", "mesh_shape", "wall_s", "fps_total",
                       "per_device_frame_share"]
    for row, n in zip(rows[1:], (1, 2)):
        shape = ref_make_mesh(jax.devices()[:n]).devices.shape
        assert row[0] == str(n)
        assert row[1] == "x".join(map(str, shape))
        assert float(row[2]) > 0 and float(row[3]) > 0
        assert row[4] == str(round(64 / n, 1))
    assert len(rows) == 3


# ---------------------------------------------------------------------------
# rbv_rd.py


@pytest.fixture(scope="module")
def ref_rd():
    return _load("rbv_rd")


def _video_planes() -> np.ndarray:
    """A 64x64, 4-frame, 10-bit texture moving 2 px a frame."""
    rng = np.random.default_rng(3)
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.normal(size=(80, 80)), 3) * 300 + 500
    return np.stack([np.clip(base[2 * i:2 * i + 64, 2 * i:2 * i + 64], 0,
                             1023).astype(np.uint16) for i in range(4)])


QPS = [16, 22, 28, 34]


@pytest.mark.parametrize("gop,motion,deblock", [
    (1, False, True), (2, False, False), (2, True, True), (4, True, True)])
def test_rbv_rd_ladder_points_equal_the_reference(ref_rd, gop, motion,
                                                  deblock):
    planes = _video_planes()
    ref_v = RefVideo(64, 64, 10, RefColorFormat.YUV400, [planes])
    v = Video(64, 64, 10, ColorFormat.YUV400, [planes.copy()])
    want = ref_rd.ladder(ref_v, QPS, gop, motion, deblock)
    got = rbv_rd.ladder(v, QPS, gop, motion, deblock, device="cpu")
    assert got == want


def test_rbv_rd_bd_rate_equals_the_reference(ref_rd):
    planes = _video_planes()
    v = Video(64, 64, 10, ColorFormat.YUV400, [planes])
    anchor = rbv_rd.ladder(v, QPS, 2, False, device="cpu")
    test = rbv_rd.ladder(v, QPS, 2, True, device="cpu")
    got = rbv_rd.bd_rate(anchor, test)
    assert np.isfinite(got)
    assert got == ref_rd.bd_rate(anchor, test)
    a, b = planes.astype(np.float64), planes[::-1].astype(np.float64)
    assert rbv_rd.psnr(a, b, 1023) == ref_rd.psnr(a, b, 1023)
    assert rbv_rd.psnr(a, a, 1023) == float("inf")


# ---------------------------------------------------------------------------
# endurance_metrics.py


def _write_endurance_dir(work: Path, lossy: bool) -> None:
    """The files the metrics leg reads: ``cloud_*`` from the port's
    testdata CLI (the JAX package's bytes), and the hq and transcoded
    decodes as the sources with a tenth of the points moved by a voxel, and
    again (``lossy``), or equal to the sources (D1 infinite)."""
    work.mkdir()
    assert testdata.main(["--frames", "4", "--points", "3000", "--out",
                          str(work / "cloud_%04d.ply")]) == 0
    rng = np.random.default_rng(7)
    for i in range(4):
        src = PointSet.read_ply(str(work / f"cloud_{i:04d}.ply"))
        pos = src.positions
        for name in ("hqdec", "dec"):
            if lossy:  # a tenth of the points one voxel further each time
                moved = rng.random(len(pos)) < 0.1
                pos = pos + moved[:, None] * rng.integers(-1, 2, pos.shape)
                pos = np.clip(pos, 0, 1023).astype(src.positions.dtype)
            PointSet(positions=pos, colors=src.colors).write_ply(
                str(work / f"{name}_{i:04d}.ply"))


@pytest.mark.parametrize("lossy", [True, False], ids=["lossy", "lossless"])
def test_endurance_metrics_rows_equal_the_reference(tmp_path, monkeypatch,
                                                    capsys, lossy):
    ref = _load("endurance_metrics")
    _write_endurance_dir(tmp_path / "ref", lossy)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    capsys.readouterr()
    monkeypatch.chdir(tmp_path)
    rc_ref = ref.main(["--workdir", str(tmp_path / "ref"), "--gof", "2"])
    want = capsys.readouterr().out.splitlines()
    monkeypatch.chdir(tmp_path)
    rc = endurance_metrics.main(["--workdir", str(tmp_path / "port"),
                                 "--gof", "2", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert (rc, got) == (rc_ref, want)
    assert len([ln for ln in got if ln.startswith("frame ")]) == 4
    cache = "drift_metrics.csv"
    assert ((tmp_path / "port" / cache).read_text()
            == (tmp_path / "ref" / cache).read_text())


@pytest.mark.parametrize("module", [scaling, rbv_rd, endurance_metrics])
def test_scripts_need_a_card_unless_asked_for_the_cpu(module, tmp_path,
                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
