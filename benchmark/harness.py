"""One run of a cell: the inputs from the seed, the warm-up, the measured
window, the traced window's per-layer readings, and the check of every
output against the plain reference.

The traffic file's ``protocol`` names a module ``protocols/<protocol>.py``,
found by that name as the per-layer metrics' readers are
(``metrics/<name>.py``).  A protocol module gives ``inputs(cell, seed,
device)`` (the input streams from the seed), ``Protocol(cell, inputs,
device)`` (its set-up, with ``run(rec, deadline=None, count=0)``: work
until ``deadline``, or ``count`` units of warm-up), ``expected(cell, data,
device)`` (the reference's answer for one input) and ``judge(cell, inputs,
rec, device)`` ({number: (reading, limit)} over the window's outputs).  A
new kind of traffic is a new file.

The window starts after ``warm`` units.  Work starts while the window is
open; the window closes when the last work started in it is written, so
the rate counts all the work and all the time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import importlib.util
import os
import resource
import subprocess
import sys
import threading
import time
import traceback

import torch

from . import devtrace
from .cells import HERE, Cell


@dataclasses.dataclass
class Span:
    name: str
    stream: int
    start: float
    end: float


@dataclasses.dataclass
class Gof:
    stream: int
    start: float   # its V3C read starts
    end: float     # its output bytes are written
    frames: int


class Recorder:
    """What the program did in a window: spans, written GOFs with their
    distinct outputs, and the counts of GOFs attempted and failed."""

    def __init__(self, frames: int):
        self.frames = frames
        self.spans: list[Span] = []
        self.gofs: list[Gof] = []
        self.outputs: dict[int, dict[str, bytes]] = {}
        self.attempted = 0
        self.failed = 0
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, stream: int):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(Span(name, stream, t, time.perf_counter()))

    def attempt(self, n: int) -> None:
        with self._lock:
            self.attempted += n

    def fail(self, n: int) -> None:
        with self._lock:
            first = self.failed == 0
            self.failed += n
        if first:
            traceback.print_exc()

    def written(self, stream: int, start: float, out: bytes) -> None:
        self.gofs.append(Gof(stream, start, time.perf_counter(), self.frames))
        key = hashlib.sha256(out).hexdigest()
        with self._lock:
            self.outputs.setdefault(stream, {}).setdefault(key, out)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads: the window's spans and GOFs
    on the host clock, the device's events (traced runs), the cell."""

    cell: Cell
    spans: list[Span]
    gofs: list[Gof]
    t0: float
    t1: float
    events: list[devtrace.Event]


@functools.lru_cache(maxsize=None)
def _module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}", os.path.join(HERE, kind, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def protocol(cell: Cell):
    """The module of the cell's traffic protocol."""
    return _module("protocols", cell.traffic["protocol"])


def read_metric(name: str, reading: Reading):
    """The reader ``metrics/<name>.py`` -> its value, or None when it
    finds nothing to read."""
    return _module("metrics", name).read(reading)


def frames_per_s(gofs: list[Gof], t0: float, t1: float) -> float:
    """Every frame written in the window over the window's whole time."""
    return sum(g.frames for g in gofs if t0 <= g.end <= t1) / (t1 - t0)


def slices(gofs: list[Gof], t0: float, t1: float, n: int) -> list[float]:
    """The rate in each of ``n`` equal slices of the window (a look at its
    steadiness)."""
    width = (t1 - t0) / n
    return [round(frames_per_s([g for g in gofs if a <= g.end < a + width],
                               a, a + width), 2)
            for a in (t0 + k * width for k in range(n))]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi() -> str:
    """The card's name, power limit, SM clock, power draw and temperature,
    as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def host_sample() -> dict:
    """The host's counters that tell why a host-paced rate moves: the
    steal and busy time of all cores (``/proc/stat``), the cores' mean
    clock (``/proc/cpuinfo``), this process's CPU time (and its system
    share), its minor page faults and its context switches."""
    out = {"t": time.perf_counter()}
    try:
        with open("/proc/stat") as fh:
            cpu = [int(v) for v in fh.readline().split()[1:]]
        out["total"] = sum(cpu[:8])
        out["steal"] = cpu[7] if len(cpu) > 7 else 0
        out["idle"] = cpu[3] + cpu[4]
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh
                   if line.startswith("cpu MHz")]
        out["mhz"] = sum(mhz) / len(mhz) if mhz else float("nan")
    except (OSError, ValueError, IndexError):
        pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["cpu_s"] = ru.ru_utime + ru.ru_stime
    out["sys_s"] = ru.ru_stime
    out["minflt"] = ru.ru_minflt
    out["nvcsw"] = ru.ru_nvcsw
    out["nivcsw"] = ru.ru_nivcsw
    return out


def host_delta(a: dict, b: dict) -> str:
    """What the host did between two samples, as one line."""
    wall = b["t"] - a["t"]
    parts = [f"process {b['cpu_s'] - a['cpu_s']:.2f} CPU s "
             f"({(b['cpu_s'] - a['cpu_s']) / wall:.2f} cores, "
             f"{b['sys_s'] - a['sys_s']:.2f} of them in the system), "
             f"{b['minflt'] - a['minflt']} minor page faults, "
             f"{b['nvcsw'] - a['nvcsw']} voluntary and "
             f"{b['nivcsw'] - a['nivcsw']} involuntary switches"]
    if "total" in a and "total" in b and b["total"] > a["total"]:
        total = b["total"] - a["total"]
        steal = 100 * (b["steal"] - a["steal"]) / total
        busy = 100 * (1 - (b["idle"] - a["idle"]) / total)
        parts.append(f"all cores: steal {steal:.2f}%, busy {busy:.2f}%; "
                     f"mean clock {a['mhz']:.0f} -> {b['mhz']:.0f} MHz")
    else:
        parts.append("all cores: /proc/stat moved not at all")
    return "; ".join(parts)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device`` -> the result line's object."""
    cfg, traffic = cell.config, cell.traffic
    frames = cfg["atlas"]["frames"]
    proto_mod = protocol(cell)
    t = time.perf_counter()
    inputs = proto_mod.inputs(cell, seed, device)
    log(f"inputs made in {time.perf_counter() - t:.3f} s")
    proto = proto_mod.Protocol(cell, inputs, device)
    proto.run(Recorder(frames), count=traffic["warm"])
    log(f"warm-up: {traffic['warm']} {traffic['protocol']} units")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        # the peak of the window, not of set-up's input encode and warm-up
        torch.cuda.reset_peak_memory_stats(device)
    log(f"card before the window: {smi()}")

    rec = Recorder(frames)
    prof = devtrace.start() if trace else None
    clock = devtrace.Clock()
    host0 = host_sample()
    t0 = time.perf_counter()
    proto.run(rec, deadline=t0 + seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    host1 = host_sample()
    events = devtrace.stop(prof, clock) if trace else []
    log(f"card after the window: {smi()}")
    log(f"window {t1 - t0:.3f} s: {len(rec.gofs)} GOFs written, "
        f"{rec.attempted} attempted, {rec.failed} failed; frames/s by "
        f"tenths {slices(rec.gofs, t0, t1, 10)}; host load average "
        f"{os.getloadavg()}")
    log(f"host in the window: {host_delta(host0, host1)}")

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": (
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)}
    result: dict = {"correct": False, "attempted": rec.attempted,
                    "failed": rec.failed, "metrics": {},
                    "device": device_info}
    reading = Reading(cell, rec.spans, rec.gofs, t0, t1, events)
    if trace:
        for m in cell.per_layer:
            value = read_metric(m["name"], reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        busy = devtrace.busy_intervals(events, t0, t1)
        device_info["busy_s"] = sum(b - a for a, b in busy)
        device_info["window_s"] = t1 - t0
        result["breakdown"] = devtrace.breakdown(events, rec.spans, t0, t1)
    else:
        # the two every cell reports; any other end-to-end metric has a
        # reader of its own, as a per-layer metric has
        values = {"frames_per_s": frames_per_s(rec.gofs, t0, t1),
                  "setup_s": t0 - t_start}
        for m in cell.end_to_end:
            name = m["name"]
            value = (values[name] if name in values
                     else read_metric(name, reading))
            result["metrics"][name] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs
    del proto
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = proto_mod.judge(cell, inputs, rec, device)
    log(f"reference check of {sum(map(len, rec.outputs.values()))} distinct "
        f"outputs in {time.perf_counter() - t:.3f} s")
    result["correct"] = (rec.failed == 0 and rec.attempted > 0
                         and all(v <= lim for v, lim in checks.values()))
    result["checks"] = {k: [v, lim] for k, (v, lim) in checks.items()}
    return result


FORBIDDEN = ("jax", "jaxlib", "flax", "rabbit_transcoding_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(
        FORBIDDEN))


def conditions(threads: dict) -> None:
    log(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} "
        f"usable, load average {os.getloadavg()}; thread settings "
        f"{threads}; torch threads {torch.get_num_threads()} intra-op, "
        f"{torch.get_num_interop_threads()} inter-op; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
