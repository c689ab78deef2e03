"""CUDA-event timing of a call on the card (``chip_smoke.py`` and
``apps/kernel_ab.py``), and the device's busy time in a ``torch.profiler``
trace (the profiling apps)."""

from __future__ import annotations

import statistics

import torch

# cycles the card spins before each timed call when only the device work is
# timed (~2.5 ms on an H100)
SPIN_CYCLES = 5_000_000


def median_ms(fn, n: int = 20, warmup: int = 3,
              device_only: bool = False) -> float:
    """Milliseconds of ``fn()``: the median of ``n`` calls after ``warmup``,
    each between two CUDA events recorded on the current stream.

    By default the events bracket the whole call, so a wrapper's host work
    (argument checks, the launch through ctypes: ~20-40 us) counts when the
    card waits for it.  With ``device_only`` the card spins before each call,
    so ``fn`` has enqueued its work before the first event runs and the
    events time the device work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_us(events) -> float:
    """Microseconds the card was busy in a profile's ``key_averages()``: the
    kernels' and copies' own rows only.  A CPU-side operator's row repeats
    the device time of the kernels it launched, so a sum over all rows
    counts every kernel twice."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA)
