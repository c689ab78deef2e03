"""The port's spans (``utils/timing``): recorded exactly while a torch
profiler records, at each boundary of the transcode path, with the ids,
streams, planes and counts the benchmark's readers take; and the copy
helpers of ``device.py``."""

import concurrent.futures as cf
import json
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rabbit_transcoding_tpu_torch import native
from rabbit_transcoding_tpu_torch.device import to_device, to_host
from rabbit_transcoding_tpu_torch.ops.events import device_busy_s
from rabbit_transcoding_tpu_torch.testdata import make_stream, with_input_qps
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder, Transcoder, TranscoderParameters, V3CReader,
    V3CWriter)
from rabbit_transcoding_tpu_torch.utils import timing

PLANE_SPANS = ("entropy_decode", "submit", "entropy_encode")
PARAMS = TranscoderParameters(geometryQP=32, attributeQP=42,
                              mode="reencode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the tier-1 run shares
    the host's cores among its test processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_recorder():
    timing.RECORDER.clear()
    yield
    timing.RECORDER.clear()


@pytest.fixture(scope="module")
def stream() -> bytes:
    """A small MC + intra GOF: every plane runs the plain chains."""
    return make_stream(4, 64, 64, motion=True, intra=True)


def _profiled(fn):
    """``fn()`` under a CPU profiler -> (its result, the spans recorded,
    the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(timing.RECORDER.spans), prof


def _transcode(data: bytes) -> bytes:
    reader, writer = V3CReader(), V3CWriter()
    context = reader.decode(reader.read(data)[0])
    Transcoder(PARAMS, "cpu").transcode(context)
    return writer.write(writer.encode(context))


def _transcode_many(streams: list[bytes]) -> list[bytes]:
    reader, writer = V3CReader(), V3CWriter()
    contexts = [reader.decode(reader.read(d)[0]) for d in streams]
    MultiStreamTranscoder(PARAMS, "cpu").transcode_many(contexts)
    return [writer.write(writer.encode(c)) for c in contexts]


def test_nothing_is_recorded_outside_a_profiler(stream):
    assert not timing.recording()
    # outside a profiler every span is one shared object that does nothing
    assert timing.span("a") is timing.span("b")
    with timing.span("a") as sp:
        sp.note("bytes", 1)
    to_host(to_device(np.arange(4), "cpu"))
    _transcode(stream)
    assert timing.RECORDER.spans == [] and timing.current() is None


def test_spans_are_recorded_inside_a_profiler():
    def work():
        assert timing.recording()
        with timing.span("outer") as outer:
            outer.note("k", 3)
            with timing.span("inner", plane=2):
                pass
        return outer

    outer, spans, prof = _profiled(work)
    assert not timing.recording()
    inner = next(s for s in spans if s.name == "inner")
    assert [s.name for s in spans] == ["inner", "outer"]
    assert inner.parent == outer.id and inner.call == outer.call == outer.id
    assert outer.counts == {"k": 3} and inner.plane == 2
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    # the thread's CPU time is read only where asked for
    assert outer.cpu0 is None and outer.cpu1 is None
    # each span is a record_function range of the profiler's trace too
    assert {"outer", "inner"} <= {e.key for e in prof.key_averages()}


def test_cpu_time_is_read_where_asked_and_in_what_that_causes():
    def work():
        with timing.span("entropy", cpu=True):
            with timing.span("copy"):
                sum(range(1000))
        with timing.span("submit"):
            with timing.span("copy"):
                pass

    _, spans, _ = _profiled(work)
    by_name = Counter()
    for s in spans:
        parent = next((p for p in spans if p.id == s.parent), None)
        asked = s.name == "entropy" or (parent and parent.name == "entropy")
        assert s.cpu is bool(asked)
        if asked:
            assert 0.0 <= s.cpu0 <= s.cpu1
        else:
            assert s.cpu0 is None and s.cpu1 is None
        by_name[s.name, s.cpu] += 1
    assert by_name == {("entropy", True): 1, ("copy", True): 1,
                       ("submit", False): 1, ("copy", False): 1}


def test_a_parent_handed_to_another_thread_keeps_the_call():
    def work():
        with timing.span("root") as root:
            parent = timing.current()
            with cf.ThreadPoolExecutor(2) as ex:
                list(ex.map(lambda i: timing.span("child", parent,
                                                  stream=i).__enter__()
                            .__exit__(None, None, None), range(2)))
        return root

    root, spans, _ = _profiled(work)
    children = [s for s in spans if s.name == "child"]
    assert len(children) == 2
    assert {s.stream for s in children} == {0, 1}
    assert all(s.parent == root.id and s.call == root.call for s in children)


def test_stage_timer_stages_are_spans():
    timer = timing.StageTimer()

    def work():
        with timing.span("transcode"):
            with timer.stage("transcodeGeometry"):
                pass

    _, spans, _ = _profiled(work)
    root, stage = (next(s for s in spans if s.name == n)
                   for n in ("transcode", "transcodeGeometry"))
    assert stage.parent == root.id
    assert timer.order == ["transcodeGeometry"]
    assert timer.stages["transcodeGeometry"] >= 0.0


def test_payloads_are_equal_with_the_recorder_on_and_off(stream):
    second = with_input_qps(stream, 18, 24)
    off = _transcode(stream), _transcode_many([stream, second])
    on, spans, _ = _profiled(
        lambda: (_transcode(stream), _transcode_many([stream, second])))
    assert on == off
    assert spans


def test_each_plane_has_its_spans_under_one_transcode(stream):
    _, spans, _ = _profiled(lambda: _transcode(stream))
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == "transcode"]
    assert {s.name for s in spans} >= {
        "v3c_read", "v3c_write", "transcodeGeometry", "transcodeAttribute",
        *PLANE_SPANS, "upload", "download"}
    under = [s for s in spans if s.call == root.call]
    # geometry (YUV400) has one plane, attribute (YUV420) three
    for stage, planes in (("transcodeGeometry", 1), ("transcodeAttribute",
                                                      3)):
        (st,) = [s for s in under if s.name == stage]
        assert st.parent == root.id
        kids = [s for s in under if s.parent == st.id]
        assert Counter((s.name, s.plane) for s in kids) == Counter(
            (n, p) for n in PLANE_SPANS for p in range(planes))
        for enc in (s for s in kids if s.name == "entropy_encode"):
            races = [s for s in under if s.parent == enc.id
                     and s.name == "race"]
            if native.available():
                assert sum(s.counts["won"] for s in races) == 1
                assert {s.counts["candidate"] for s in races} <= set("BRZ")
                assert all(s.plane == enc.plane for s in races)
            else:
                assert races == []
    # every copy lies under a plane's span, on that span's thread
    for s in under:
        if s.name in ("upload", "download"):
            parent = by_id[s.parent]
            assert parent.name in PLANE_SPANS
            assert parent.thread == s.thread and parent.plane == s.plane
    # the thread's CPU time is read in the entropy spans and what they
    # cause, and nowhere else
    for s in under:
        entropy = s.name.startswith("entropy_") or (
            s.parent in by_id and by_id[s.parent].name.startswith(
                "entropy_"))
        assert (s.cpu0 is not None) is entropy, s.name
    # the V3C layer's spans lie outside the transcode
    assert all(s.call != root.call for s in spans
               if s.name.startswith("v3c_"))


def test_the_batched_path_spans_carry_their_stream(stream):
    streams = [stream, with_input_qps(stream, 18, 24),
               with_input_qps(stream, 20, 26)]
    _, spans, _ = _profiled(lambda: _transcode_many(streams))
    (root,) = [s for s in spans if s.name == "transcode"]
    for name in ("entropy_decode", "entropy_encode"):
        got = Counter(s.stream for s in spans if s.name == name)
        # one span per stream and plane: 1 geometry + 3 attribute planes
        assert got == {0: 4, 1: 4, 2: 4}
    submits = [s for s in spans if s.name == "submit"]
    # one submit per plane for the one shard, covering all three streams
    assert len(submits) == 4
    assert all(s.stream is None for s in submits)
    assert all(s.call == root.call for s in spans
               if s.name in PLANE_SPANS + ("race",))


@pytest.mark.parametrize("array", [
    np.arange(12, dtype=np.int16).reshape(3, 4),
    np.zeros((2, 5, 7), np.float32),
    np.array(1.5, np.float64),
    np.ones(0, np.uint8),
], ids=["int16", "float32", "scalar", "empty"])
def test_copy_spans_count_the_arrays_bytes(array):
    def work():
        t = to_device(array, "cpu")
        back = to_host(t + 0)
        return t, back

    (t, back), spans, _ = _profiled(work)
    np.testing.assert_array_equal(back, array)
    up, down = spans
    assert (up.name, down.name) == ("upload", "download")
    assert up.counts == {"bytes": array.nbytes}
    assert down.counts == {"bytes": array.nbytes}
    assert t.dtype == torch.from_numpy(array).dtype


def test_the_transcode_copies_count_what_crosses(stream):
    _, spans, _ = _profiled(lambda: _transcode(stream))
    assert all(s.counts == {"bytes": s.counts["bytes"]} and
               s.counts["bytes"] > 0 for s in spans if s.name == "upload")
    # each plane's entropy encode downloads, in this order, its intra mode
    # maps (one uint8 per block of each of the 2 GOPs' I frames), its
    # nonzero counts (256 int64 for 16 x 16 blocks) and its slab (int16
    # (F, kmax, nby, nbx), 0 < kmax <= 256)
    encodes = [s for s in spans if s.name == "entropy_encode"]
    assert len(encodes) == 4
    for enc in encodes:
        blocks = (4 * 4) if enc.plane == 0 else (2 * 2)
        mode, nnz, slab = [s.counts["bytes"] for s in sorted(
            (s for s in spans if s.parent == enc.id
             and s.name == "download"), key=lambda s: s.t0)]
        assert (mode, nnz) == (2 * blocks, 256 * 8)
        assert slab % (4 * blocks * 2) == 0
        assert 0 < slab // (4 * blocks * 2) <= 256


def test_a_profile_dir_trace_shows_the_spans(stream, tmp_path,
                                             monkeypatch):
    from rabbit_transcoding_tpu_torch.apps import transcode

    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.bin").write_bytes(stream)
    assert transcode.main(["--compressedStreamPath=in.bin",
                           "--outStreamPath=out.bin", "--device=cpu",
                           "--profileDir=prof"]) == 0
    trace = json.loads(
        (tmp_path / "prof" / "rabbit-transcode.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"transcode", "transcodeGeometry", "v3c_read", "v3c_write",
            *PLANE_SPANS, "race", "upload", "download"} <= names


def test_device_busy_s_takes_the_union_of_the_device_intervals():
    cuda = torch.autograd.DeviceType.CUDA

    def event(start, dur, device=cuda):
        return types.SimpleNamespace(start_ns=lambda: start,
                                     duration_ns=lambda: dur,
                                     device_type=lambda: device)

    events = [event(0, 10), event(5, 10), event(30, 5), event(31, 2),
              event(100, 50, torch.autograd.DeviceType.CPU)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    # [0, 15) and [30, 35): 20 ns, where a sum of durations gives 27
    assert device_busy_s(prof) == pytest.approx(20e-9)
