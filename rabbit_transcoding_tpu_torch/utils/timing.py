"""Stage timing + memory instrumentation, and the program's spans.

Mirrors the reference's observability surface (SURVEY.md §5.1): per-stage
milliseconds appended to ``timings.txt`` / ``timings_decoder.txt``
(PCCEncoder.cpp:783, PCCDecoder.cpp:67), wall+user time and peak memory per
app (PccAppTranscoder.cpp:369-384).  The file format is kept line-compatible
("<stage>: <ms> ms") so existing tooling can diff the two implementations.

Spans: ``RECORDER`` keeps, in memory, one ``Span`` for each interval of
work the program marks with ``span(name)`` (every ``StageTimer`` stage is
one too), exactly while a ``torch.profiler`` (or ``torch.autograd.
profiler``) records; each also opens a ``record_function`` range of its
name, so a profiler's trace shows it on the CPU rows.  Outside a profiler a
span reads one flag and allocates nothing.  Nothing is written out: readers
take ``RECORDER.between(t0, t1)``.
"""

from __future__ import annotations

import functools
import itertools
import os
import resource
import sys
import threading
import time
from contextlib import contextmanager


def recording() -> bool:
    """Whether spans are recorded: exactly while a torch profiler records
    (torch's own flag, read without importing torch)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class Span:
    """One interval of the program's work on one thread.

    ``parent`` is the id of the span that caused it; ``call`` the id of the
    root span of its chain (a ``transcode`` call: one GOF, or one round of
    batched streams), shared by every span under it on any thread;
    ``stream`` and ``plane`` are inherited from the parent unless given;
    ``t0``/``t1`` are ``time.perf_counter()`` seconds; ``cpu0``/``cpu1``
    the thread's CPU time (``time.thread_time()``, a system call) at both
    ends where ``cpu`` is set or the parent's is, else None; ``counts``
    holds what the span counts (bytes copied, a race candidate and whether
    it won)."""

    __slots__ = ("name", "id", "parent", "call", "stream", "plane", "cpu",
                 "thread", "t0", "t1", "cpu0", "cpu1", "counts", "_range")

    _ids = itertools.count(1)

    def __init__(self, name: str, parent: Span | None = None,
                 stream: int | None = None, plane: int | None = None,
                 cpu: bool = False):
        self.name = name
        self.id = next(Span._ids)
        self.parent, self.call = ((parent.id, parent.call) if parent
                                  else (None, self.id))
        if parent is not None:
            stream = parent.stream if stream is None else stream
            plane = parent.plane if plane is None else plane
            cpu = cpu or parent.cpu
        self.stream, self.plane, self.cpu = stream, plane, cpu
        self.cpu0 = self.cpu1 = None
        self.counts: dict = {}

    def note(self, key: str, value) -> None:
        self.counts[key] = value

    def __enter__(self) -> Span:
        _stack().append(self)
        self.thread = threading.get_ident()
        # record_function's C++ twin: a tenth of the Python one's cost
        self._range = sys.modules["torch"]._C._profiler._RecordFunctionFast(
            self.name)
        self._range.__enter__()
        if self.cpu:
            self.cpu0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self.cpu:
            self.cpu1 = time.thread_time()
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        RECORDER.spans.append(self)


class _Off:
    """What ``span`` gives outside a profiler: a context that does
    nothing."""

    def note(self, key: str, value) -> None:
        pass

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()
_local = threading.local()


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def current() -> Span | None:
    """The innermost open span of this thread: the parent to hand to work
    that another thread does for it."""
    stack = _stack()
    return stack[-1] if stack else None


def span(name: str, parent: Span | None = None, stream: int | None = None,
         plane: int | None = None, cpu: bool = False):
    """A context that records ``name`` as a ``Span`` while a profiler
    records (caused by ``parent``, default this thread's innermost open
    span), and does nothing otherwise.  ``cpu`` reads the thread's CPU time
    in it and in the spans it causes.  ``as`` gives an object with
    ``note(key, value)`` either way."""
    if not recording():
        return _OFF
    return Span(name, parent or current(), stream, plane, cpu)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Recorder:
    """The spans recorded in this process, in the order they closed."""

    def __init__(self) -> None:
        self.spans: list[Span] = []

    def between(self, t0: float, t1: float) -> list[Span]:
        """The spans that opened and closed inside [t0, t1]."""
        return [s for s in self.spans if t0 <= s.t0 and s.t1 <= t1]

    def clear(self) -> None:
        self.spans = []


RECORDER = Recorder()


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
    """Accumulates named stage durations; dumps a timings file.  Each stage
    is also a span (``span``)."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}
        self.order: list[str] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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
