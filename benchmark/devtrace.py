"""The traced window's device side: the card's activity from
``torch.profiler`` (CUPTI), on the benchmark's own clock.

Device events carry wall-clock nanoseconds; ``Clock`` pairs that clock with
``time.perf_counter`` once, so that device activity and the benchmark's
host spans lie on one time line.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class Event:
    name: str
    start: float   # perf_counter seconds
    end: float

    @property
    def copy(self) -> bool:
        return self.name.startswith(("Memcpy", "Memset"))


class Clock:
    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def seconds(self, wall_ns: int) -> float:
        return (wall_ns - self.offset_ns) / 1e9


def start():
    """A running profiler of the card's activity."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof, clock: Clock) -> list[Event]:
    """Stop ``prof`` -> the device's events (kernels, copies, sets) in time
    order."""
    import torch

    prof.__exit__(None, None, None)
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = clock.seconds(e.start_ns())
        out.append(Event(e.name(), s, s + e.duration_ns() / 1e9))
    out.sort(key=lambda e: e.start)
    return out


def busy_intervals(events: list[Event], t0: float,
                   t1: float) -> list[tuple[float, float]]:
    """The union of the device's activity inside [t0, t1], merged."""
    merged: list[list[float]] = []
    for e in events:
        a, b = max(e.start, t0), min(e.end, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def breakdown(events: list[Event], spans, t0: float, t1: float) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the device, each named by the benchmark span most recently
    opened among those open at its middle."""
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        if e.end > t0 and e.start < t1:
            by_name[e.name[:120]] += e.end - e.start
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [t0] + [x for iv in busy_intervals(events, t0, t1)
                    for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        open_ = [s for s in spans if s.start <= mid < s.end]
        label = max(open_, key=lambda s: s.start).name if open_ else "none"
        named.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
