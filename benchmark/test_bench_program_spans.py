"""The readers of the program's own spans on synthetic spans and device
events: self time less children, per-GOF division, the idle share put down
to ``submit`` before entropy, the race's waste, and nothing to read where
the window holds no span or the program has no recorder."""

import sys
import types

import pytest

from benchmark import cells, devtrace, harness
from benchmark import program_spans as ps
from rabbit_transcoding_tpu_torch.utils import timing

NEW = ("entropy_decode_ms_per_gof", "entropy_encode_ms_per_gof",
       "entropy_cpu_pct", "race_waste_pct", "submit_ms_per_gof",
       "host_syncs_per_gof", "pageable_upload_mb_per_gof", "idle_submit_pct",
       "idle_entropy_pct")


def _span(name, t0, t1, parent=None, cpu=None, thread=1, **counts):
    """A closed span of the program, as the recorder keeps it; ``cpu``
    False: one that did not read the thread's CPU time."""
    s = timing.Span(name, parent)
    s.t0, s.t1, s.thread = t0, t1, thread
    if cpu is not False:
        s.cpu0, s.cpu1 = 0.0, (t1 - t0) if cpu is None else cpu
    s.counts = counts
    return s


def _reading(n_gofs=2, events=(), t0=0.0, t1=10.0):
    gofs = [harness.Gof(0, t0, t1, 32)] * n_gofs
    return harness.Reading(cells.load("mcintra-depth1"), [], gofs, t0, t1,
                           list(events))


@pytest.fixture
def recorded(monkeypatch):
    """``recorded(spans)``: the recorder holds exactly ``spans``."""
    def put(spans):
        monkeypatch.setattr(timing.RECORDER, "spans", list(spans))
    return put


def test_self_time_leaves_out_the_copies_and_divides_by_gofs(recorded):
    dec = _span("entropy_decode", 0.0, 4.0)
    enc = _span("entropy_encode", 4.0, 8.0)
    sub = _span("submit", 8.0, 10.0)
    recorded([dec, _span("upload", 1.0, 2.0, dec, bytes=10),
              enc, _span("download", 5.0, 6.0, enc, bytes=4),
              _span("race", 6.0, 7.0, enc, candidate="R", won=True),
              sub, _span("upload", 8.5, 9.0, sub, bytes=6, pinned=False),
              _span("upload", 9.0, 9.5, sub, bytes=1000, pinned=True)])
    r = _reading(n_gofs=2)
    read = lambda name: harness.read_metric(name, r)  # noqa: E731
    # 4 s less the 1 s upload; the encode keeps its race, loses its
    # download; the submit loses both uploads; 2 GOFs
    assert read("entropy_decode_ms_per_gof") == pytest.approx(1500.0)
    assert read("entropy_encode_ms_per_gof") == pytest.approx(1500.0)
    assert read("submit_ms_per_gof") == pytest.approx(500.0)
    assert read("host_syncs_per_gof") == pytest.approx(2.0)
    # pinned bytes are not pageable
    assert read("pageable_upload_mb_per_gof") == pytest.approx(8e-6)
    assert read("race_waste_pct") == pytest.approx(0.0)


def test_entropy_cpu_share_is_over_the_self_parts(recorded):
    dec = _span("entropy_decode", 0.0, 4.0, cpu=2.5)
    # the upload's CPU (a spin on the card's stream) leaves with its wall
    up = _span("upload", 1.0, 2.0, dec, cpu=1.0)
    # a child on another thread gives back its wall, not its CPU
    other = _span("upload", 2.0, 3.0, dec, cpu=0.5, thread=2)
    enc = _span("entropy_encode", 4.0, 6.0, cpu=1.0)
    recorded([dec, up, other, enc])
    # (2.5 - 1.0 + 1.0) CPU s over (4 - 2 + 2) wall s
    assert harness.read_metric("entropy_cpu_pct", _reading()) == \
        pytest.approx(100.0 * 2.5 / 4.0)


def test_spans_without_cpu_time_give_wall_time_and_no_cpu(recorded):
    dec = _span("entropy_decode", 0.0, 4.0, cpu=3.0)
    sub = _span("submit", 4.0, 8.0, cpu=False)
    recorded([dec, sub, _span("upload", 5.0, 6.0, sub, cpu=False)])
    r = _reading(n_gofs=1)
    assert harness.read_metric("submit_ms_per_gof", r) == \
        pytest.approx(3000.0)
    assert ps.self_wall_cpu([sub], "submit") == (4.0, 0.0)
    assert harness.read_metric("entropy_cpu_pct", r) == pytest.approx(75.0)


def test_race_waste_with_one_winner_among_three(recorded):
    enc = _span("entropy_encode", 0.0, 5.0)
    recorded([enc,
              _span("race", 0.0, 1.0, enc, candidate="B", won=False),
              _span("race", 1.0, 3.0, enc, candidate="R", won=True),
              _span("race", 3.0, 4.0, enc, candidate="Z", won=False)])
    assert harness.read_metric("race_waste_pct", _reading()) == \
        pytest.approx(50.0)


def test_idle_goes_to_submit_before_entropy(recorded):
    # busy [0, 2] and [6, 7]: idle [2, 6] and [7, 10]
    events = [devtrace.Event("kernel", 0.0, 2.0),
              devtrace.Event("Memcpy HtoD", 6.0, 7.0)]
    recorded([_span("submit", 1.0, 5.0),
              _span("entropy_decode", 3.0, 8.0, thread=2),
              _span("entropy_encode", 8.5, 9.0, thread=3),
              # outside the window's spans: read by neither
              _span("v3c_write", 9.5, 9.9)])
    r = _reading(events=events)
    # idle inside submit: [2, 5]
    assert harness.read_metric("idle_submit_pct", r) == pytest.approx(30.0)
    # idle inside entropy and outside submit: [5, 6], [7, 8], [8.5, 9]
    assert harness.read_metric("idle_entropy_pct", r) == pytest.approx(25.0)
    # the two and the rest make up the card's idle share
    idle = harness.read_metric("device_idle_pct", r)
    assert idle == pytest.approx(70.0)


def test_spans_outside_the_window_are_not_read(recorded):
    recorded([_span("entropy_decode", -2.0, -1.0),
              _span("submit", 9.5, 10.5)])
    r = _reading(events=[devtrace.Event("kernel", 0.0, 1.0)])
    for name in NEW:
        assert harness.read_metric(name, r) is None, name


def test_an_empty_window_reads_none(recorded):
    recorded([])
    r = _reading(events=[devtrace.Event("kernel", 0.0, 1.0)])
    for name in NEW:
        assert harness.read_metric(name, r) is None, name


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    # the parent commit's program: utils.timing without RECORDER
    monkeypatch.setitem(sys.modules,
                        "rabbit_transcoding_tpu_torch.utils.timing",
                        types.ModuleType("timing"))
    r = _reading(events=[devtrace.Event("kernel", 0.0, 1.0)])
    for name in NEW:
        assert harness.read_metric(name, r) is None, name


def test_the_new_metrics_are_in_every_cell():
    for cell in ("mcintra-batch4", "mcintra-depth1"):
        names = {m["name"] for m in cells.load(cell).per_layer}
        assert set(NEW) <= names


def test_coverage_is_the_union_of_work_spans_with_holes_by_stage():
    root = _span("transcode", 0.0, 10.0)
    geo = _span("transcodeGeometry", 0.0, 4.0, root)
    att = _span("transcodeAttribute", 4.0, 10.0, root)
    other = _span("transcode", 20.0, 21.0)
    spans = [root, geo, att, other,
             # overlapping work on two threads counts once
             _span("entropy_decode", 0.0, 3.0, geo),
             _span("submit", 2.0, 3.5, geo, thread=2),
             _span("entropy_encode", 5.0, 9.0, att),
             _span("download", 6.0, 7.0, att),
             # another call's work covers nothing of this one
             _span("submit", 3.5, 5.0, other)]
    (share, holes), (share2, holes2) = ps.coverage(spans)
    assert share == pytest.approx(0.75)
    assert holes == pytest.approx({"transcodeGeometry": 0.5,
                                   "transcodeAttribute": 2.0})
    assert (share2, holes2) == (0.0, {"none": pytest.approx(1.0)})


def test_one_clock_holds_downloads_to_their_copies_and_finds_the_move():
    downs = [_span("download", t, t + 1e-3) for t in (1.0, 2.0, 3.0, 4.0)]
    # three copies lie inside their downloads, one 0.5 ms late
    d2h = [devtrace.Event("Memcpy DtoH", t + 2e-4, t + 8e-4)
           for t in (1.0, 2.0, 3.0)]
    d2h.append(devtrace.Event("Memcpy DtoH", 4.0007, 4.0013))
    assert ps.one_clock(downs, d2h) == pytest.approx(0.75)
    # 0.2 ms of slack at each end lets a copy poke out by that much
    assert ps.one_clock(downs, d2h, offset=-3e-4) == pytest.approx(1.0)
    # moved too far, the first three start 0.21 ms before their downloads
    assert ps.one_clock(downs, d2h, offset=-4.1e-4) == pytest.approx(0.25)
    assert ps.one_clock([], d2h) is None
    # all four end 0.3 ms late: with the 0.2 ms of slack a move of -0.1 ms
    # brings them in
    late = [devtrace.Event(e.name, e.start + 5e-4, e.end + 5e-4)
            for e in d2h[:3]] + [d2h[3]]
    offset, share = ps.best_offset(downs, late)
    assert share == pytest.approx(1.0)
    assert offset == pytest.approx(-1e-4, abs=1e-9)
