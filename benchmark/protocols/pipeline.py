"""The ``pipeline`` protocol: one stream, ``depth`` GOFs in flight on
``depth`` threads that share one ``Transcoder`` (the stream app's
``--pipelineDepth``), each thread taking its next GOF when its last one is
written (closed loop).  The traffic file gives ``streams`` (1), ``depth``
and ``warm`` (GOFs before the window)."""

import threading
import time

from benchmark.transcode import (  # noqa: F401 (the protocol's interface)
    expected, inputs, judge, params, probe_link, read_v3c, write_v3c)


class Protocol:
    def __init__(self, cell, inputs: list[bytes], device):
        from rabbit_transcoding_tpu_torch.transcoder import Transcoder

        probe_link(device)
        (self.data,) = inputs
        self.depth = cell.traffic["depth"]
        self.transcoder = Transcoder(params(cell.config), device)

    def run(self, rec, deadline: float | None = None,
            count: int = 0) -> None:
        left = [count]
        lock = threading.Lock()

        def more() -> bool:
            if deadline is not None:
                return time.perf_counter() < deadline
            with lock:
                left[0] -= 1
                return left[0] >= 0

        def worker() -> None:
            while more():
                self.gof(rec)

        threads = [threading.Thread(target=worker)
                   for _ in range(self.depth)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def gof(self, rec) -> None:
        rec.attempt(1)
        start = time.perf_counter()
        try:
            with rec.span("v3c_read", 0):
                ctx = read_v3c(self.data)
            with rec.span("transcode", 0):
                self.transcoder.transcode(ctx)
            with rec.span("v3c_write", 0):
                out = write_v3c(ctx)
            rec.written(0, start, out)
        except Exception:  # counted as a failed GOF; the loop goes on
            rec.fail(1)
