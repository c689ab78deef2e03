"""The ``rounds`` protocol: ``streams`` streams, seeds ``seed`` ..
``seed + streams - 1``, one GOF each per round; rounds back to back
(closed loop) through one ``MultiStreamTranscoder``: the streams' V3C
reads, then ``transcode_many``, then their V3C writes.  The traffic file
gives ``streams`` and ``warm`` (rounds before the window)."""

import time

from benchmark.transcode import (  # noqa: F401 (the protocol's interface)
    expected, inputs, judge, params, probe_link, read_v3c, write_v3c)


class Protocol:
    def __init__(self, cell, inputs: list[bytes], device):
        from rabbit_transcoding_tpu_torch.transcoder import (
            MultiStreamTranscoder)

        probe_link(device)
        self.inputs = inputs
        self.mst = MultiStreamTranscoder(params(cell.config), device)

    def run(self, rec, deadline: float | None = None,
            count: int = 0) -> None:
        done = 0
        while (time.perf_counter() < deadline if deadline is not None
               else done < count):
            self.round(rec)
            done += 1

    def round(self, rec) -> None:
        s = len(self.inputs)
        rec.attempt(s)
        starts, contexts, written = [], [], 0
        try:
            for i, data in enumerate(self.inputs):
                starts.append(time.perf_counter())
                with rec.span("v3c_read", i):
                    contexts.append(read_v3c(data))
            with rec.span("transcode", -1):
                self.mst.transcode_many(contexts)
            for i, ctx in enumerate(contexts):
                with rec.span("v3c_write", i):
                    out = write_v3c(ctx)
                rec.written(i, starts[i], out)
                written += 1
        except Exception:  # counted as failed GOFs; the loop goes on
            rec.fail(s - written)
