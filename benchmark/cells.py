"""A cell of the benchmark, found by name in ``BENCHMARK.json``: its
configuration file (the deployment), its traffic file
(``traffic/<traffic>.json``: the protocol and its numbers) and the metrics
that ``BENCHMARK.json`` gives it.  A cell that waits for a later benchmark
change (``waiting.json``, in the same form) is found there after it: it
runs as a cell does, for probes, and is in no check.  Standard library
only, so that the host's thread settings are pinned before torch is
imported."""

from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, or else of the
    benchmark's ``waiting.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        with open(os.path.join(HERE, "waiting.json")) as fh:
            waiting = json.load(fh)
        for key in ("configs", "per_layer"):
            bench[key] = bench[key] + waiting.get(key, [])
        cells = {w["name"]: w for w in waiting["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or "
                       f"waiting.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def pin_threads(config: dict) -> dict:
    """Set the host thread counts the configuration states in the
    environment (before torch is imported) -> the settings."""
    threads = config["threads"]
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[key] = str(threads[key])
    return threads
