"""The port's CTC ladder twins (``rabbit_transcoding_tpu_torch/scripts/
ladder.py`` and ``ladder_big.py``) against the repo's ``scripts/ladder.py``
on the CPU: the same CSV lines, rate by rate; and the big ladder's resume."""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from rabbit_transcoding_tpu_torch.scripts import ladder, ladder_big

ROOT = Path(__file__).resolve().parents[1]
R1 = {"r1": (32, 42, 4)}


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


def test_ladder_rows_equal_the_reference(monkeypatch, capsys):
    ref = _load("ladder")
    monkeypatch.setattr(ref, "RATES", R1)
    monkeypatch.setattr(ladder, "RATES", R1)
    monkeypatch.setattr(sys, "argv", ["ladder.py", "sphere", "2", "3000"])
    assert ref.main() == 0
    want = capsys.readouterr().out.splitlines()
    assert ladder.main(["sphere", "2", "3000", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    # the CSV header, one row per mode, the delta header and the r1 row
    assert len(want) == 1 + len(ladder.MODES) + 2
    assert got == want


def test_ladder_big_rerun_skips_the_cells_it_has(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(ladder_big, "RATES", R1)
    out = tmp_path / "ladder.csv"
    argv = ["--scene", "sphere", "--frames", "2", "--points", "3000",
            "--gof", "2", "--out", str(out), "--workdir",
            str(tmp_path / "work"), "--modes", "reencode", "--device", "cpu"]
    assert ladder_big.main(argv) == 0
    first = capsys.readouterr()
    rows = out.read_text().splitlines()
    assert rows[0] == ladder_big.HEADER and len(rows) == 2
    assert rows[1].startswith("sphere;r1;reencode;")
    assert "hq encode:" in first.err

    def no_cell(*args, **kwargs):
        raise AssertionError("a cell already in the CSV ran again")

    monkeypatch.setattr(ladder_big, "run_cell", no_cell)
    assert ladder_big.main(argv) == 0
    second = capsys.readouterr()
    assert out.read_text().splitlines() == rows
    assert "hq encode cached" in second.err
    assert "resume: 1 cells" in second.err
    assert second.out == first.out  # the same delta summary


@pytest.mark.parametrize("module", [ladder, ladder_big])
def test_ladders_need_a_card_unless_asked_for_the_cpu(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--out", str(tmp_path / "x.csv")]
                    if module is ladder_big else [])
