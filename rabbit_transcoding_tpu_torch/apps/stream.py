"""rabbit-stream on PyTorch: the resumable live transcoding app.

Port of ``rabbit_transcoding_tpu/apps/stream.py``.  The GOF is the
checkpoint and batch unit:

* completed GOFs append to the output at once; a sidecar
  ``<out>.state.json`` records the input's md5, the parameters, the count of
  completed GOFs and the output size, replaced atomically after every GOF;
* ``--resume`` continues from the first unfinished GOF (state and partial
  output are checked first);
* ``--onError=skip`` drops a failing GOF and keeps the stream alive
  (``abort`` raises);
* several input streams (comma-separated) transcode concurrently, one
  thread each, and ``--pipelineDepth`` GOFs of a stream are in flight;
* ``--sharded=1`` with several inputs: each round batches every stream's
  next GOF through ``MultiStreamTranscoder``, sharded over a mesh of every
  visible card for ``--device=cuda`` (of the one device for ``cpu`` or an
  indexed card); the outputs are byte-identical to the unbatched mode.

    python -m rabbit_transcoding_tpu_torch.apps.stream \\
        --compressedStreamPath=a.bin,b.bin --outStreamPath=o.bin \\
        --sharded=1 --device=cuda

``--device=cuda`` (the default) raises when there is no GPU.  ``--trace``
(single stream) decodes each transcoded GOF and writes the encoder-side
conformance logs (``enc_*``), to be diffed against ``rabbit-decode --trace``
on the written stream; the reference's link-rate probe is not carried over.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import sys
import time

import torch

from ..bitstream import V3CReader, V3CWriter
from ..bitstream.v3c import sample_stream_header, write_sample_stream_units
from ..codec.patch_frame import decode_patch_frames
from ..codec.trace import emit_conformance_traces
from ..decoder.decoder import Decoder
from ..device import resolve
from ..transcoder.multistream import MultiStreamTranscoder
from ..transcoder.params import TranscoderParameters
from ..transcoder.transcoder import Transcoder
from ..utils.timing import Stopwatch, print_run_footer
from ..utils.tracing import TraceCategory, Tracer
from .common import build_registry, parse_or_help


@dataclasses.dataclass
class StreamParams(TranscoderParameters):
    resume: bool = False
    onError: str = "abort"   # abort | skip
    # GOFs in flight: more than 1 overlaps host entropy of one GOF with
    # device work of the next (GOFs are independent; writes stay ordered)
    pipelineDepth: int = 3
    # batch all input streams' GOFs, one device call per plane and round
    # (requires more than one input; output byte-identical to unbatched)
    sharded: bool = False
    # write enc_* conformance trace logs per GOF (single-stream mode)
    trace: bool = False


def _params_key(params: StreamParams) -> str:
    d = dataclasses.asdict(params)
    for k in ("compressedStreamPath", "outStreamPath", "resume", "sharded",
              "pipelineDepth", "trace"):
        d.pop(k, None)
    return hashlib.md5(json.dumps(d, sort_keys=True).encode()).hexdigest()


def _state_path(out_path: str) -> str:
    return out_path + ".state.json"


class _StreamIO:
    """One stream's input GOFs and checkpointed output (file + sidecar)."""

    def __init__(self, path_in: str, path_out: str, params: StreamParams):
        self.path_in = path_in
        self.path_out = path_out
        self.params = params
        with open(path_in, "rb") as f:
            data = f.read()
        self.input_md5 = hashlib.md5(data).hexdigest()
        self.reader = V3CReader()
        self.gofs = self.reader.read(data)
        self.pkey = _params_key(params)
        self.failures: list[dict] = []
        # rounds whose batched call failed and fell back to per-stream
        # transcoding (transcode_streams_sharded)
        self.batched_failures = 0
        self.t0 = time.perf_counter()

        self.done = 0
        # GOFs written this run: the key of a GOF's trace logs is its
        # position in the output, which a skipped input GOF does not shift
        self.written = 0
        self._mode = "wb"
        spath = _state_path(path_out)
        if params.resume and os.path.exists(spath):
            try:
                with open(spath) as sf:
                    state = json.load(sf)
                if (
                    state.get("input_md5") == self.input_md5
                    and state.get("params") == self.pkey
                    and os.path.exists(path_out)
                    and os.path.getsize(path_out) == state.get("out_bytes", -1)
                ):
                    self.done = state.get("gofs_done", 0)
                    # carry the earlier failures forward: the record stays
                    # cumulative
                    self.failures = list(state.get("failures", []))
                    self._mode = "ab"
                else:
                    print(f"{path_out}: stale state, restarting",
                          file=sys.stderr)
            except (json.JSONDecodeError, OSError):
                print(f"{spath}: unreadable state, restarting",
                      file=sys.stderr)
        self._f = None

    def __enter__(self):
        self._f = open(self.path_out, self._mode)
        if self._mode == "wb":
            # one sample-stream header per file; GOFs append units only
            self._f.write(sample_stream_header(4))
        return self

    def __exit__(self, *exc):
        self._f.close()
        self._f = None

    def _write_state(self) -> None:
        # atomic replace: a crash mid-dump never leaves a torn sidecar
        spath = _state_path(self.path_out)
        tmp = spath + ".tmp"
        with open(tmp, "w") as sf:
            json.dump(
                {
                    "input": self.path_in,
                    "input_md5": self.input_md5,
                    "params": self.pkey,
                    "gofs_done": self.done,
                    "gofs_total": len(self.gofs),
                    "out_bytes": self._f.tell(),
                    "failures": self.failures,
                },
                sf,
            )
        os.replace(tmp, spath)

    def write_gof(self, blob: bytes) -> None:
        self._f.write(blob)
        self._f.flush()
        self.done += 1
        self.written += 1
        self._write_state()

    def skip_gof(self, gi: int, err: Exception) -> None:
        if self.params.onError == "abort":
            raise err
        self.failures.append({"gof": gi, "error": repr(err)})
        print(f"{self.path_in} GOF {gi}: skipped ({err})", file=sys.stderr)
        self.done += 1
        self._write_state()

    def result(self) -> dict:
        return {
            "stream": self.path_in,
            "gofs": len(self.gofs),
            "failures": len(self.failures),
            "batched_failures": self.batched_failures,
            "seconds": time.perf_counter() - self.t0,
            "out_bytes": os.path.getsize(self.path_out),
        }


def _encode_gof(context) -> bytes:
    writer = V3CWriter()
    return write_sample_stream_units(writer.encode(context), 4)


def transcode_stream(path_in: str, path_out: str, params: StreamParams,
                     device: torch.device | str, tracer=None) -> dict:
    """Transcode one stream GOF by GOF on ``device``, with checkpointed
    progress.  With a ``tracer`` each transcoded GOF is decoded and its
    conformance logs are written."""
    transcoder = Transcoder(params, device)

    with _StreamIO(path_in, path_out, params) as sio:

        def process(gi: int):
            context = sio.reader.decode(sio.gofs[gi])
            for atlas in list(context.atlases):
                transcoder.transcode(context, atlas.atlas_id)
            return _encode_gof(context), context

        depth = max(1, params.pipelineDepth)
        with cf.ThreadPoolExecutor(max_workers=depth) as ex:
            futures = {gi: ex.submit(process, gi)
                       for gi in range(sio.done, len(sio.gofs))}
            for gi in sorted(futures):
                try:
                    # pop: a future holds its result until released
                    blob, context = futures.pop(gi).result()
                except Exception as e:  # per-GOF failure containment
                    sio.skip_gof(gi, e)
                    continue
                if tracer is not None:
                    # the logs come from the transcoded context in memory,
                    # BEFORE serialisation, so diffing them against
                    # rabbit-decode --trace on the written stream catches
                    # writer/reader drift.  Written here, in GOF order, not
                    # in the pipeline workers; keyed by the GOF's position
                    # in the output; before the write, so a crash between
                    # the two re-emits a GOF's logs rather than losing them.
                    for atlas in context.atlases:
                        emit_conformance_traces(
                            tracer, atlas, decode_patch_frames(atlas),
                            Decoder(device=device).decode(
                                context, atlas.atlas_id),
                            gof=sio.written, atlas_id=atlas.atlas_id,
                        )
                del context  # free the GOF's decoded planes at once
                sio.write_gof(blob)
        return sio.result()


def transcode_streams_sharded(inputs: list[str], outputs: list[str],
                              params: StreamParams,
                              device: torch.device | str | None = None,
                              mesh=None) -> list[dict]:
    """All streams in lockstep over ``mesh`` or else the mesh that
    ``MultiStreamTranscoder`` makes of ``device`` (give one of the two):
    each round takes the next pending GOF of every stream and transcodes
    them through one ``MultiStreamTranscoder`` call.  Failure containment stays per stream: a
    stream whose GOF fails to decode leaves the round (skipped or aborted
    per --onError); if the batched call itself fails, the exception is
    printed, counted in every result's ``batched_failures``, and the round
    falls back to per-stream transcoding, so that one poison stream cannot
    take the others down."""
    mst = MultiStreamTranscoder(params, device, mesh)
    sios = [_StreamIO(i, o, params) for i, o in zip(inputs, outputs)]
    for sio in sios:
        sio.__enter__()
    try:
        while True:
            active = [s for s in sios if s.done < len(s.gofs)]
            if not active:
                break
            round_sios: list[_StreamIO] = []
            batch = []
            with cf.ThreadPoolExecutor(max_workers=len(active)) as ex:
                futs = [(ex.submit(s.reader.decode, s.gofs[s.done]), s)
                        for s in active]
                for fu, s in futs:
                    try:
                        batch.append(fu.result())
                        round_sios.append(s)
                    except Exception as e:
                        s.skip_gof(s.done, e)
            if not round_sios:
                continue
            ids = [sios.index(s) for s in round_sios]
            try:
                mst.transcode_many(batch, stream_ids=ids)
                fallback = False
            except Exception as e:
                print(f"batched round failed, transcoding its "
                      f"{len(round_sios)} streams one by one: {e!r}",
                      file=sys.stderr)
                for s in round_sios:
                    s.batched_failures += 1
                fallback = True
            for s, ctx, sid in zip(round_sios, batch, ids):
                try:
                    if fallback:
                        # the failed batch may have mutated the context:
                        # decode it again from the original units
                        ctx = s.reader.decode(s.gofs[s.done])
                        tr = mst.single(sid)
                        for atlas in list(ctx.atlases):
                            tr.transcode(ctx, atlas.atlas_id)
                    s.write_gof(_encode_gof(ctx))
                except Exception as e:
                    s.skip_gof(s.done, e)
    finally:
        for sio in sios:
            sio.__exit__()
    return [s.result() for s in sios]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = StreamParams()
    reg = build_registry(params, extra={
        "device": ("cuda", "torch device: cuda (the GPU kernels) or cpu "
                           "(the plain PyTorch versions)"),
    })
    if parse_or_help(reg, argv, params, "rabbit-stream") is None:
        return 0
    if not params.compressedStreamPath:
        print("error: --compressedStreamPath is required", file=sys.stderr)
        return 1
    device = resolve(reg["device"])
    inputs = [p for p in params.compressedStreamPath.split(",") if p]
    outputs = (
        [p for p in params.outStreamPath.split(",") if p]
        if "," in params.outStreamPath
        else [
            params.outStreamPath
            if len(inputs) == 1
            else f"{os.path.splitext(params.outStreamPath)[0]}_{i}.bin"
            for i in range(len(inputs))
        ]
    )
    if len(outputs) != len(inputs):
        print("error: input/output stream count mismatch", file=sys.stderr)
        return 1

    tracer = None
    if params.trace:
        if len(inputs) != 1:
            print("warning: --trace supports a single input stream; ignored",
                  file=sys.stderr)
        else:
            # a resumed run APPENDS to the earlier run's enc_* logs, so the
            # conformance pair still covers every written GOF; duplicate
            # keys are harmless (same values, the last wins)
            resuming = params.resume and os.path.exists(
                _state_path(outputs[0]))
            tracer = Tracer(prefix="enc_", append=resuming).enable(
                *TraceCategory)

    sw = Stopwatch()
    sw.start()
    if len(inputs) == 1:
        results = [transcode_stream(inputs[0], outputs[0], params, device,
                                    tracer=tracer)]
        if tracer is not None:
            tracer.close()
    elif params.sharded:
        results = transcode_streams_sharded(inputs, outputs, params, device)
    else:
        # concurrent streams: threads overlap host entropy with device work
        with cf.ThreadPoolExecutor(max_workers=len(inputs)) as ex:
            futures = [ex.submit(transcode_stream, i, o, params, device)
                       for i, o in zip(inputs, outputs)]
            results = [fu.result() for fu in futures]
    sw.stop()
    total_failures = sum(r["failures"] for r in results)
    for r in results:
        print(
            f"{r['stream']}: {r['gofs']} GOFs -> {r['out_bytes']} bytes "
            f"in {r['seconds']:.2f}s ({r['failures']} failures, "
            f"{r['batched_failures']} batched-round failures) on {device}"
        )
    print_run_footer("rabbit-stream", sw)
    return 0 if total_failures == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
