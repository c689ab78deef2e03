"""Time the batched multi-stream transcode of this checkout against other
checkouts of the repo, on one card.

    python -m rabbit_transcoding_tpu_torch.apps.multistream_ab \\
        --other=OLD_CHECKOUT [--other=...] [--out=multistream_ab.txt]

The measurement is ``chip_smoke.py``'s phase 9: the main path's stream
(``testdata.make_stream(32, 1024, 1024)``, built on the card) requantised to
input QPs 16/18/20/22; S = 1, 2, 4 of them through one
``MultiStreamTranscoder(params, cuda:0)`` round (reencode to QP 32 / 42),
one warm-up and the median of 3 rounds, beside the same S streams through
``Transcoder`` one after another.  Two versions of one package cannot share
an interpreter, so each checkout runs in a process of its own, started from
its root (its kernels build into its own ``build/``), in turns: the others,
this, this, the others in reverse.  Prints one line per checkout, turn and
S, with a digest of the output bytes, which must be equal across every
process; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# run in each checkout's own process, with the checkout's root first on the
# path; names only what every checkout of the port has
_WORKER = r"""
import hashlib, json, statistics, sys, time
import torch
from rabbit_transcoding_tpu_torch.testdata import make_stream, with_input_qps
from rabbit_transcoding_tpu_torch.transcoder import (
    MultiStreamTranscoder, Transcoder, TranscoderParameters, V3CReader,
    V3CWriter)

dev = torch.device("cuda", 0)
params = TranscoderParameters(geometryQP=32, attributeQP=42, mode="reencode")
data = make_stream(32, 1024, 1024, device=dev)
streams = [with_input_qps(data, q, q + 6, dev) for q in (16, 18, 20, 22)]


def out_bytes(run, datas):
    reader, writer = V3CReader(), V3CWriter()
    contexts = [reader.decode(reader.read(d)[0]) for d in datas]
    run(contexts)
    torch.cuda.synchronize()
    return [writer.write(writer.encode(c)) for c in contexts]


def timed(fn):
    walls = []
    for i in range(4):
        t0 = time.perf_counter()
        out = fn()
        if i:
            walls.append(time.perf_counter() - t0)
    return out, walls


for s in (1, 2, 4):
    datas = streams[:s]
    mst = MultiStreamTranscoder(params, dev)
    outs, walls = timed(lambda: out_bytes(mst.transcode_many, datas))
    seq, seq_walls = timed(lambda: out_bytes(
        lambda cs: [Transcoder(params, dev).transcode(c) for c in cs], datas))
    digest = hashlib.sha256(b"".join(outs)).hexdigest()[:16]
    print(json.dumps({
        "streams": s, "wall_s": walls, "sequential_wall_s": seq_walls,
        "frames_per_s": 32 * s / statistics.median(walls),
        "sequential_frames_per_s": 32 * s / statistics.median(seq_walls),
        "bytes_equal_sequential": outs == seq, "digest": digest}))
"""


def run_checkout(root: Path) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})"
         f"\n{_WORKER}"], cwd=root, capture_output=True, text=True,
        timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n{proc.stderr}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="root of another checkout (repeatable)")
    ap.add_argument("--out", default="",
                    help="also write the lines to this file")
    args = ap.parse_args(argv)
    this = Path(__file__).resolve().parents[2]
    others = [Path(p).resolve() for p in args.other]
    names = {this: "this", **{p: p.name for p in others}}
    lines, digests, ok = [], set(), True
    for root in others + [this, this] + others[::-1]:
        for row in run_checkout(root):
            digests.add((row["streams"], row["digest"]))
            ok &= row["bytes_equal_sequential"]
            lines.append(f"{names[root]} " + " ".join(
                f"{k}={v!r}" for k, v in row.items()))
            print(lines[-1], flush=True)
    ok &= len(digests) == len({s for s, _ in digests})
    lines.append(f"bytes_equal_everywhere={ok}")
    print(lines[-1])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
