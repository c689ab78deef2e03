"""The harness finds its configurations, cells, traffic and per-layer
metrics as data files named in BENCHMARK.json (and the cells that wait in
waiting.json), and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import cells, harness

ROOT = cells.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WAITING = json.load(open(os.path.join(cells.HERE, "waiting.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  + WAITING["workloads"]])
def test_every_cell_loads_from_its_files(name):
    cell = cells.load(name)
    assert cell.chips == 1
    proto = harness.protocol(cell)
    for part in ("inputs", "Protocol", "expected", "judge"):
        assert callable(getattr(proto, part)), part
    assert cell.traffic["warm"] >= 1
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    assert cell.per_layer
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS", "torch_intra_op", "torch_inter_op"):
        assert key in cell.config["threads"]


def test_every_per_layer_metric_has_its_reader():
    for m in BENCH["per_layer"] + WAITING["per_layer"]:
        path = os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")
        assert os.path.isfile(path), path
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no-such-cell")


def test_waiting_cells_are_in_no_check_and_keep_their_metrics():
    named = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    for w in WAITING["workloads"]:
        assert w["name"] not in named
        assert w["config"] not in configs
        cell = cells.load(w["name"])
        assert cell.chips == w["chips"]
        assert {m["name"] for m in cell.per_layer} >= {
            m["name"] for m in BENCH["per_layer"]}
    for m in WAITING["per_layer"]:
        assert m["name"] not in {n["name"] for n in BENCH["per_layer"]}
        assert set(m["workloads"]) <= {w["name"]
                                       for w in WAITING["workloads"]}
    # a cell's metric that waits is not given to the benchmark's cells
    for w in BENCH["workloads"]:
        assert not {m["name"] for m in cells.load(w["name"]).per_layer} & {
            m["name"] for m in WAITING["per_layer"]}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and "limits" in cfg
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    assert {c for c, _ in used} == {c["name"] for c in BENCH["configs"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])


@pytest.mark.parametrize("change", [{"bitdepth": 8}, {"format": "YUV444"}])
def test_the_generator_refuses_what_it_cannot_make(change):
    import numpy as np

    from benchmark import gen

    cfg = dict(cells.load("gop2-depth3").config["geometry"], **change)
    with pytest.raises(ValueError):
        gen.video(np.zeros((1, 16, 16), np.uint16), cfg, "geometry")


def test_configurations_hold_no_unread_knobs():
    read = {"name", "deployment", "atlas", "geometry", "attribute",
            "transcode", "precision", "guarantees", "threads", "tools",
            "assumed", "limits"}
    for c in BENCH["configs"] + WAITING["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(cfg) <= read
        assert set(cfg["tools"]) == {"motion", "intra"}
        for video in (cfg["geometry"], cfg["attribute"]):
            assert set(video) == {"bitdepth", "format", "qp_in", "qp_out",
                                  "gop"}
