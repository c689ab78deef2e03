"""Checks of the program's own spans in one traced window of a cell.

    python3 benchmark/span_checks.py --workload <cell> --seed <n>
                                     --seconds <s>

Runs from the root of a checkout, on its first CUDA card, the cell's
inputs, warm-up and a traced window as ``run.py --trace 1`` does, then
prints one JSON object:

- ``coverage``: for each ``transcode`` span, the share of its wall time
  that the union over threads of its work spans covers (median and least),
  and the uncovered ms per call by the stage open over them;
- ``one_clock``: the share of ``download`` spans that hold a device-to-host
  copy of the device trace to within 0.2 ms, on ``devtrace.Clock``; the
  move of the device's events that makes the most of them line up, the
  share then, and ``idle_submit_pct`` and ``idle_entropy_pct`` read on
  the events as traced and as moved;
- ``syncs``: two units of work under ``torch.cuda.set_sync_debug_mode
  ("warn")``: the synchronising calls it reports against the ``upload``
  and ``download`` spans, and the program's lines that made any call
  outside those spans.
"""

import argparse
import json
import os
import statistics
import sys
import time
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    threads = cells.pin_threads(cell.config)

    import torch

    torch.set_num_threads(threads["torch_intra_op"])
    torch.set_num_interop_threads(threads["torch_inter_op"])
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark import devtrace, harness
    from benchmark import program_spans as ps
    from rabbit_transcoding_tpu_torch.utils.timing import RECORDER

    device = torch.device("cuda", 0)
    frames = cell.config["atlas"]["frames"]
    mod = harness.protocol(cell)
    inputs = mod.inputs(cell, args.seed, device)
    proto = mod.Protocol(cell, inputs, device)
    proto.run(harness.Recorder(frames), count=cell.traffic["warm"])
    torch.cuda.synchronize(device)
    out: dict = {"cell": cell.name, "seed": args.seed, "card": harness.smi()}

    # one traced window, as run.py --trace 1 makes it
    rec = harness.Recorder(frames)
    RECORDER.clear()
    prof = devtrace.start()
    clock = devtrace.Clock()
    t0 = time.perf_counter()
    proto.run(rec, deadline=t0 + args.seconds)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    events = devtrace.stop(prof, clock)
    spans = RECORDER.between(t0, t1)
    out["gofs"] = len(rec.gofs)
    out["spans_per_gof"] = len(spans) / max(1, len(rec.gofs))

    covered = ps.coverage(spans)
    holes: dict[str, float] = {}
    for _, h in covered:
        for name, secs in h.items():
            holes[name] = holes.get(name, 0.0) + secs
    out["coverage"] = {
        "calls": len(covered),
        "median": statistics.median(c for c, _ in covered),
        "least": min(c for c, _ in covered),
        "holes_ms_per_call": {k: 1e3 * v / len(covered) for k, v in
                              sorted(holes.items(), key=lambda kv: -kv[1])}}

    downloads = [s for s in spans if s.name == "download"]
    d2h = [e for e in events if e.name.startswith("Memcpy DtoH")]
    offset, share = ps.best_offset(downloads, d2h)

    def idle(evs) -> dict:
        r = harness.Reading(cell, rec.spans, rec.gofs, t0, t1, evs)
        return {m: harness.read_metric(m, r)
                for m in ("idle_submit_pct", "idle_entropy_pct")}

    moved = [devtrace.Event(e.name, e.start + offset, e.end + offset)
             for e in events]
    out["one_clock"] = {
        "downloads": len(downloads), "d2h_copies": len(d2h),
        "share": ps.one_clock(downloads, d2h),
        "best_offset_ms": 1e3 * offset, "share_at_best": share,
        "idle_as_traced": idle(events), "idle_moved": idle(moved)}

    # the synchronising calls of a few units of work
    syncs = [0]
    outside: dict[str, int] = {}

    def show(message, *_args, **_kwargs):
        if "synchroniz" not in str(message):
            return
        syncs[0] += 1
        stack = traceback.extract_stack()
        if any(f.name in ("to_device", "to_host") for f in stack):
            return
        site = next((f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                     for f in reversed(stack)
                     if "rabbit_transcoding_tpu_torch" in f.filename), "?")
        outside[site] = outside.get(site, 0) + 1

    RECORDER.clear()
    rec = harness.Recorder(frames)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.simplefilter("always")
        warnings.showwarning = show
        prof = devtrace.start()
        proto.run(rec, count=2)
        devtrace.stop(prof, devtrace.Clock())
        torch.cuda.set_sync_debug_mode(0)
    out["syncs"] = {
        "gofs": len(rec.gofs), "reported": syncs[0],
        "copy_spans": sum(s.name in ps.COPIES for s in RECORDER.spans),
        "outside_copy_spans": outside}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
