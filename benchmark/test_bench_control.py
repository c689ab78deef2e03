"""``correct`` against its control and the faults a cell can have, at a
tiny size on the CPU: the program's run passes; the reference with TF32
products in the program's place fails; and a run whose timed path is
broken underneath (its state returned unchanged, half of a round left out,
a coefficient altered where it is coded) comes out not correct.  Besides:
a run loads no JAX package, and (on a card) the command prints its line."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import gen, harness, transcode
from benchmark.reference import chains, check

CPU = torch.device("cpu")
SEED = 2**31 + 101


def _run(cell):
    return harness.run_cell(cell, SEED, 0.5, False, CPU, time.perf_counter())


def _exceeds(numbers: dict, limits: dict) -> list[str]:
    return [k for k, lim in limits.items() if numbers.get(k, 0) > lim]


@pytest.mark.parametrize("name", ["gop2-depth3", "mcintra-batch4"])
def test_program_passes_and_the_tf32_control_fails(tiny, name):
    cell = tiny(name)
    result = _run(cell)
    assert result["correct"], result["checks"]
    # the control in the program's place, judged as a run judges: the
    # worst of the cell's streams
    numbers = []
    for i in range(cell.traffic["streams"]):
        data = gen.stream(cell.config, SEED + i, CPU)
        want = transcode.expected(cell, data, CPU)
        with chains.tf32_products():
            control = transcode.expected(cell, data, CPU)
        numbers.append(check.compare(want, control, CPU))
    assert _exceeds(check.worst(numbers), cell.config["limits"])


@pytest.mark.parametrize("name", ["gop2-depth3", "mcintra-batch4"])
def test_state_returned_unchanged_is_not_correct(tiny, name, monkeypatch):
    from rabbit_transcoding_tpu_torch.transcoder import (
        MultiStreamTranscoder, Transcoder)

    monkeypatch.setattr(Transcoder, "transcode",
                        lambda self, ctx, atlas_id=0: ctx)
    monkeypatch.setattr(MultiStreamTranscoder, "transcode_many",
                        lambda self, ctxs, stream_ids=None: ctxs)
    result = _run(tiny(name))
    assert not result["correct"]
    assert result["checks"]["headers"][0] > 0


def test_half_of_a_round_left_out_is_not_correct(tiny, monkeypatch):
    from rabbit_transcoding_tpu_torch.transcoder import MultiStreamTranscoder

    whole = MultiStreamTranscoder.transcode_many

    def half(self, contexts, stream_ids=None):
        whole(self, contexts[:len(contexts) // 2])
        return contexts

    monkeypatch.setattr(MultiStreamTranscoder, "transcode_many", half)
    result = _run(tiny("gop2-batch4"))
    assert not result["correct"]


@pytest.mark.parametrize("name", ["gop2-batch4", "mcintra-depth1"])
def test_a_coefficient_altered_where_coded_is_not_correct(tiny, name,
                                                         monkeypatch):
    from rabbit_transcoding_tpu_torch.parallel import multistream
    from rabbit_transcoding_tpu_torch.video import rbv

    code = rbv._encode_coeff_blob

    def altered(q, level=6):
        q = q.clone()
        q.view(-1)[q.numel() // 2] += 100
        return code(q, level)

    monkeypatch.setattr(rbv, "_encode_coeff_blob", altered)
    monkeypatch.setattr(multistream, "_encode_coeff_blob", altered)
    result = _run(tiny(name))
    assert not result["correct"]
    assert result["checks"]["coeff_max"][0] >= 100


def test_a_run_loads_no_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(1)\n"
        "from benchmark import cells, harness\n"
        "cell = cells.load('gop2-depth3')\n"
        "cell.config['atlas'].update(width=128, height=128, frames=4)\n"
        "r = harness.run_cell(cell, 5, 0.3, False, torch.device('cpu'),"
        " time.perf_counter())\n"
        "print(r['correct'], harness.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] == 'jax'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True [] []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rabbit_transcoding_tpu.x", sys)
    assert harness.forbidden_modules() == ["rabbit_transcoding_tpu"]


@pytest.mark.cuda
def test_the_command_prints_its_line_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mcintra-depth1",
         "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
