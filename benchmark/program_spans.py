"""What the per-layer readers of the program's own spans share: the spans
the program recorded in the traced window (``rabbit_transcoding_tpu_torch.
utils.timing.RECORDER``, on ``time.perf_counter``, the benchmark's clock),
self times, and interval sums over the window.

A program without the recorder (a commit before it) gives nothing to read:
``spans`` is then None, and so is every reader's value.
"""

from __future__ import annotations

from bisect import bisect_left

from .devtrace import busy_intervals

ENTROPY = ("entropy_decode", "entropy_encode")
COPIES = ("upload", "download")
# the spans of a transcode's work, below its stages
WORK = ENTROPY + ("submit", "race") + COPIES


def spans(r) -> list | None:
    """The program's spans that lie inside the window ``[r.t0, r.t1]``, or
    None where the program records none."""
    try:
        from rabbit_transcoding_tpu_torch.utils.timing import RECORDER
    except ImportError:
        return None
    return RECORDER.between(r.t0, r.t1) or None


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, merged and in order."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs, ys) -> list[tuple[float, float]]:
    """The intersection of two merged, ordered interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list[tuple[float, float]]:
    """``xs`` less ``ys``, both merged and ordered."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def during(all_spans, names) -> list[tuple[float, float]]:
    """The union of the intervals in which some thread is inside a span
    named in ``names``."""
    return union((s.t0, s.t1) for s in all_spans if s.name in names)


def self_wall_cpu(all_spans, name: str,
                  keep: tuple[str, ...] = ()) -> tuple[float, float]:
    """(wall seconds, thread CPU seconds) of the spans ``name``, less the
    parts their child spans cover, except children named in ``keep``.
    Children on the span's own thread give back their CPU time too.  Spans
    that did not read the thread's CPU time (``cpu0`` None) add no CPU."""
    by_parent: dict[int, list] = {}
    for s in all_spans:
        if s.parent is not None:
            by_parent.setdefault(s.parent, []).append(s)
    wall = cpu = 0.0
    for s in all_spans:
        if s.name != name:
            continue
        kids = [k for k in by_parent.get(s.id, ()) if k.name not in keep]
        covered = intersect(union((k.t0, k.t1) for k in kids),
                            [(s.t0, s.t1)])
        wall += (s.t1 - s.t0) - length(covered)
        if s.cpu0 is not None:
            cpu += (s.cpu1 - s.cpu0) - sum(k.cpu1 - k.cpu0 for k in kids
                                           if k.thread == s.thread)
    return wall, cpu


def self_ms_per_gof(r, name: str, keep: tuple[str, ...] = ()):
    """Self time of the spans ``name`` in ms per GOF written in the window;
    None where the window has no such span or no GOF."""
    got = spans(r)
    if not got or not r.gofs or not any(s.name == name for s in got):
        return None
    return 1e3 * self_wall_cpu(got, name, keep)[0] / len(r.gofs)


def idle_share_pct(r, inside, outside=()):
    """The share of the window in which the card is idle (no kernel, copy
    or set: the complement of ``devtrace.busy_intervals``) while some
    thread is inside a span named in ``inside`` and none is inside one
    named in ``outside``, in %."""
    got = spans(r)
    busy = busy_intervals(r.events, r.t0, r.t1)
    if not got or not busy:
        return None
    idle = subtract([(r.t0, r.t1)], busy)
    mine = subtract(intersect(during(got, inside), [(r.t0, r.t1)]),
                    during(got, outside))
    return 100.0 * length(intersect(idle, mine)) / (r.t1 - r.t0)


def coverage(all_spans) -> list[tuple[float, dict[str, float]]]:
    """For each ``transcode`` span: the share of its wall time that the
    union over threads of its call's ``WORK`` spans covers, and the seconds
    left uncovered, by the name of the root's child (a stage) open over
    them, or ``none`` outside every such child."""
    by_call: dict[int, list] = {}
    for s in all_spans:
        by_call.setdefault(s.call, []).append(s)
    out = []
    for root in all_spans:
        if root.name != "transcode":
            continue
        mine = by_call[root.call]
        whole = [(root.t0, root.t1)]
        inside = intersect(union((s.t0, s.t1) for s in mine
                                 if s.name in WORK), whole)
        gaps = subtract(whole, inside)
        stages = [s for s in mine if s.parent == root.id]
        holes: dict[str, float] = {}
        for st in stages:
            left = length(intersect(gaps, [(st.t0, st.t1)]))
            if left > 0:
                holes[st.name] = holes.get(st.name, 0.0) + left
        rest = length(subtract(gaps, union((s.t0, s.t1) for s in stages)))
        if rest > 0:
            holes["none"] = rest
        out.append((length(inside) / (root.t1 - root.t0), holes))
    return out


def one_clock(downloads, d2h, offset: float = 0.0) -> float | None:
    """The share of ``download`` spans that hold a device-to-host copy
    event (``d2h``, in time order) moved by ``offset`` seconds, to within
    0.2 ms at both ends; None without downloads."""
    if not downloads:
        return None
    tol = 2e-4
    starts = [e.start + offset for e in d2h]
    hit = 0
    for s in downloads:
        i = bisect_left(starts, s.t0 - tol)
        while i < len(d2h) and starts[i] <= s.t1 + tol:
            if d2h[i].end + offset <= s.t1 + tol:
                hit += 1
                break
            i += 1
    return hit / len(downloads)


def best_offset(downloads, d2h) -> tuple[float, float | None]:
    """The move of the device's events, in steps of 20 us up to 3 ms either
    way, that makes the most downloads hold their copy (the smallest move
    among equals) -> (offset, share)."""
    return max(((k * 2e-5, one_clock(downloads, d2h, k * 2e-5))
                for k in sorted(range(-150, 151), key=abs)),
               key=lambda x: x[1] or 0.0)
