"""The rate, the percentile and the device readers on synthetic spans and
events, a stall inside the window among them."""

import math

import pytest

from benchmark import cells, devtrace, harness


def _reading(gofs, spans=(), events=(), t0=0.0, t1=10.0):
    return harness.Reading(cells.load("gop2-depth3"), list(spans),
                           list(gofs), t0, t1, list(events))


def _gofs(ends, frames=32):
    return [harness.Gof(0, e - 0.2, e, frames) for e in ends]


def test_rate_is_all_frames_over_the_whole_window_a_stall_included():
    # 10 GOFs in the first 2 s, nothing for 7 s (a stall), 5 in the last
    ends = [0.2 * (i + 1) for i in range(10)] + [9.2 + 0.15 * i
                                                 for i in range(5)]
    rate = harness.frames_per_s(_gofs(ends), 0.0, 10.0)
    assert rate == pytest.approx(15 * 32 / 10.0)


def test_rate_leaves_out_nothing_written_inside_the_window():
    assert harness.frames_per_s(_gofs([0.5, 1.0, 2.0]), 0.0, 2.0) == 48.0


def test_p95_is_the_nearest_rank_over_every_gof():
    lat = list(range(1, 101))       # ms 1 .. 100, one GOF each
    gofs = [harness.Gof(0, 0.0, x / 1e3, 32) for x in lat]
    v = harness.read_metric("gof_ms_p95", _reading(gofs))
    assert v == pytest.approx(95.0)
    # a single stalled GOF sets the tail once it is 1 in 20 or more
    gofs = [harness.Gof(0, 0.0, 0.01, 32)] * 19 + [
        harness.Gof(0, 0.0, 2.0, 32)]
    assert harness.read_metric("gof_ms_p95", _reading(gofs)) == \
        pytest.approx(10.0)
    assert harness.read_metric("gof_ms_p95", _reading(gofs * 2 + [
        harness.Gof(0, 0.0, 2.0, 32)])) == pytest.approx(2000.0)


def test_span_readers_divide_by_gofs_written():
    spans = [harness.Span("v3c_read", 0, 0.0, 0.01),
             harness.Span("transcode", -1, 0.01, 0.41),
             harness.Span("v3c_write", 0, 0.41, 0.43),
             harness.Span("v3c_write", 1, 0.43, 0.45)]
    r = _reading(_gofs([0.43, 0.45]), spans)
    assert harness.read_metric("v3c_io_ms_per_gof", r) == \
        pytest.approx(25.0)
    assert harness.read_metric("transcode_ms_per_gof", r) == \
        pytest.approx(200.0)


def test_device_readers_on_synthetic_events():
    ev = [devtrace.Event("k1", 1.0, 2.0), devtrace.Event("k2", 1.5, 3.0),
          devtrace.Event("Memcpy HtoD (Pageable -> Device)", 5.0, 5.5),
          devtrace.Event("transcode_gops_kernel", 6.0, 6.5)]
    r = _reading(_gofs([4.0, 8.0]), events=ev)
    assert devtrace.busy_intervals(ev, 0.0, 10.0) == [(1.0, 3.0),
                                                      (5.0, 5.5),
                                                      (6.0, 6.5)]
    assert harness.read_metric("device_idle_pct", r) == pytest.approx(70.0)
    assert harness.read_metric("device_launches_per_gof", r) == 1.5
    assert harness.read_metric("h2d_ms_per_gof", r) == pytest.approx(250.0)
    # one launch for two GOFs of four planes each: nothing to read
    assert harness.read_metric("transcode_gops_roofline", r) is None
    assert harness.read_metric("device_idle_pct", _reading([])) is None


def test_roofline_reader_counts_every_plane_of_every_gof():
    cell = cells.load("gop2-depth3")
    ev = [devtrace.Event("transcode_gops_kernel", i, i + 1e-4)
          for i in range(8)]
    spans = [harness.Span("transcode", 0, e - 0.1, e) for e in (1.0, 2.0)]
    r = harness.Reading(cell, spans, _gofs([1.0, 2.0]), 0.0, 10.0, ev)
    # 2 GOFs: luma 49.30 us x 2 planes + chroma 12.32 us x 2, each GOF
    want = 2 * (2 * 0.049302 + 2 * 0.012325) / (8 * 0.1)
    assert harness.read_metric("transcode_gops_roofline", r) == \
        pytest.approx(100 * want, rel=1e-3)


def test_breakdown_names_gaps_by_the_open_span():
    ev = [devtrace.Event("a", 0.0, 1.0), devtrace.Event("b", 3.0, 4.0)]
    spans = [harness.Span("transcode", 0, 0.5, 2.5),
             harness.Span("v3c_write", 0, 2.6, 3.5)]
    out = devtrace.breakdown(ev, spans, 0.0, 5.0)
    assert out["device_ops"] == [["a", 1.0], ["b", 1.0]]
    assert out["idle_gaps"] == [["transcode", 2.0], ["none", 1.0]]
    assert all(len(out[k]) <= 10 for k in out)
    assert math.isclose(sum(s for _, s in out["idle_gaps"]) + 2.0, 5.0)
