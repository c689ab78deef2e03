"""Stage timing + memory instrumentation.

Mirrors the reference's observability surface (SURVEY.md §5.1): per-stage
milliseconds appended to ``timings.txt`` / ``timings_decoder.txt``
(PCCEncoder.cpp:783, PCCDecoder.cpp:67), wall+user time and peak memory per
app (PccAppTranscoder.cpp:369-384).  The file format is kept line-compatible
("<stage>: <ms> ms") so existing tooling can diff the two implementations.
"""

from __future__ import annotations

import os
import resource
import time
from contextlib import contextmanager


class Stopwatch:
    """Wall + process-CPU stopwatch (the reference tracks wall/user/children)."""

    def __init__(self) -> None:
        self.wall = 0.0
        self.user = 0.0
        self._w0 = 0.0
        self._u0 = 0.0
        self._running = False

    def start(self) -> None:
        self._w0 = time.perf_counter()
        self._u0 = time.process_time()
        self._running = True

    def stop(self) -> None:
        if self._running:
            self.wall += time.perf_counter() - self._w0
            self.user += time.process_time() - self._u0
            self._running = False

    @contextmanager
    def timing(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


class StageTimer:
    """Accumulates named stage durations; dumps a timings file."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}
        self.order: list[str] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            if name not in self.stages:
                self.stages[name] = 0.0
                self.order.append(name)
            self.stages[name] += dt

    def write(self, path: str, mode: str = "a") -> None:
        with open(path, mode, encoding="utf-8") as f:
            for name in self.order:
                f.write(f"{name}: {self.stages[name]:.3f} ms\n")

    def report(self) -> str:
        return "\n".join(f"{n}: {self.stages[n]:.3f} ms" for n in self.order)


def peak_memory_bytes() -> int:
    """Peak RSS of this process (the reference prints 'Peak memory')."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # ru_maxrss is KiB on Linux
    return int(ru.ru_maxrss) * 1024


def print_run_footer(name: str, sw: Stopwatch) -> str:
    """Reference-style end-of-run footer (PccAppTranscoder.cpp:369-384)."""
    mem = peak_memory_bytes() // (1024 * 1024)
    txt = (
        f"{name}: wall {sw.wall:.3f} s, user {sw.user:.3f} s, "
        f"peak memory {mem} MB"
    )
    print(txt)
    return txt


def write_wall_seconds(test_name: str, sw: Stopwatch, directory: str = ".") -> None:
    """Transcoder writes '<test_name>.txt' with wall seconds (PccAppTranscoder.cpp:386-388)."""
    path = os.path.join(directory, f"{test_name}.txt")
    with open(path, "a", encoding="utf-8") as f:
        f.write(f"{sw.wall:.6f}\n")
