"""Time the fused GOP-transcode kernel of this checkout against builds of
other versions of its source, in one process on one card.

    python -m rabbit_transcoding_tpu_torch.apps.kernel_ab \\
        --other=OLD/transcode_gops.cu [--other=...] \\
        [--out=kernel_ab.txt]

Every library is built with the package's nvcc flags (``ops/_build.py``;
the others into ``build/kernel_ab/``) and launched through the same C
interface on the same inputs: the coefficients of the main path's stream
(``testdata.make_stream(32, 1024, 1024)``, built on the card), its luma
(32, 64, 64, 16, 16) and chroma (32, 32, 32, 16, 16) planes, and the
stream-axis launch over S = 4 luma stacks (the stream requantised to input
QPs 16/18/20/22) with per-stream steps.  The kernel's time depends on the
data (its division takes a slow path on some inputs), so random
coefficients are not a stand-in.  At each shape every output must equal
the plain PyTorch version bit for bit; then they are timed in turns (the
others, this, this, the others in reverse), each a median of 20 launches
after 3 warm-ups by CUDA events (``ops/events.py``), twice: around the
whole call (``ms``, as ``chip_smoke.py`` times it) and of the device work
alone (``device_ms``), beside the shape's bound and its dense count
(``ops.transcode.transcode_bound_ms``).  Prints one line per shape and
build, and for each build ptxas's report and the instruction mix of the
kernel's frame loop (``cuobjdump -sass``); needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import transcode as tc
from ..ops.events import median_ms
from ..testdata import make_stream, stream_coeffs, with_input_qps
from ..video import rbv

# (name, (video type, plane), input QPs, output QP, maxval): the main
# path's planes
PLANES = (
    ("luma", ("GEOMETRY", 0), (16,), 32, 1023.0),
    ("chroma", ("ATTRIBUTE", 1), (22,), 42, 255.0),
    ("luma_s4", ("GEOMETRY", 0), (16, 18, 20, 22), 32, 1023.0),
)


def _qs(qp: int) -> float:
    return float(np.float32(rbv.qstep_of(qp)))


def main_path_inputs(device) -> dict:
    """{name: coefficients} for PLANES, from the main path's stream."""
    data = make_stream(32, 1024, 1024, device=device)
    planes = stream_coeffs(data, device)
    streams = [stream_coeffs(with_input_qps(data, q, q + 6, device),
                             device)[("GEOMETRY", 0)]
               for q in PLANES[2][2]]
    return {"luma": planes[PLANES[0][1]], "chroma": planes[PLANES[1][1]],
            "luma_s4": torch.stack(streams)}


def _steps(c: torch.Tensor, qps_in, qp_out: int):
    """(qs_in, qs_out): floats for one stream, per-stream tensors for S."""
    if c.dim() == 5:
        return _qs(qps_in[0]), _qs(qp_out)
    return (torch.tensor([_qs(q) for q in qps_in], device=c.device),
            torch.full((c.shape[0],), _qs(qp_out), device=c.device))


def _launcher(lib, c: torch.Tensor, qps_in, qp_out: int, maxval: float):
    """A function that launches ``lib``'s kernel on ``c`` through
    ``ops.transcode.launch`` -> its output tensor."""
    out = torch.empty_like(c)
    qs_in, qs_out = _steps(c, qps_in, qp_out)

    def run() -> torch.Tensor:
        tc.launch(c, out, qs_in, qs_out, maxval, 2, 2, lib=lib)
        return out

    return run


def _plain(c: torch.Tensor, qps_in, qp_out: int, maxval: float):
    qs_in, qs_out = _steps(c, qps_in, qp_out)
    if c.dim() == 5:
        return tc.transcode_coeffs_ref(c, qs_in, qs_out, maxval, 2, 2)
    return tc.transcode_coeffs_batched_ref(c, qs_in, qs_out, maxval, 2, 2)


def sass_mix(library: Path) -> dict:
    """{opcode: count} over the frame loop of the kernel in ``library``
    (the span of its longest backward branch), from ``cuobjdump -sass``;
    empty when the toolkit has no cuobjdump."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ins, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = "transcode_gops" in line
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)"
                     r"[^;]*?(0x[0-9a-f]+)?\s*;", line)
        if keep and m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    loops = [(addr - int(target, 16), int(target, 16), addr)
             for addr, op, target in ins
             if op == "BRA" and target and int(target, 16) < addr]
    if not loops:
        return {}
    _, lo, hi = max(loops)
    return dict(collections.Counter(op for a, op, _ in ins
                                    if lo <= a <= hi).most_common())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", required=True,
                    help="another version of csrc/transcode_gops.cu "
                         "(repeatable; named by its parent directory)")
    ap.add_argument("--out", default="", help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    lines = []

    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(f"card {card}; torch {torch.__version__}")
    _build.build(force=True)
    libs = {"this": _build.library()}
    emit(f"ptxas this {_build.ptxas_report(_build.BUILD_LOG)}")
    emit(f"sass loop this {sass_mix(_build.LIBRARY)}")
    for src in map(Path, args.other):
        name = src.parent.name
        other_dir = _build.BUILD_DIR.parent / "kernel_ab" / name
        _build.compile_library([src], other_dir / "lib.so",
                               other_dir / "build.log")
        libs[name] = _build.bind(ctypes.CDLL(str(other_dir / "lib.so")))
        emit(f"ptxas {name} {_build.ptxas_report(other_dir / 'build.log')}")
        emit(f"sass loop {name} {sass_mix(other_dir / 'lib.so')}")
    others = [k for k in libs if k != "this"]

    inputs = main_path_inputs(dev)
    ok = True
    for name, _, qps_in, qp_out, maxval in PLANES:
        c = inputs[name]
        shape = tuple(c.shape)
        run = {k: _launcher(lib, c, qps_in, qp_out, maxval)
               for k, lib in libs.items()}
        want = _plain(c, qps_in, qp_out, maxval)
        equal = {k: bool(torch.equal(fn().clone(), want))
                 for k, fn in run.items()}
        ok &= all(equal.values())
        times = {k: [] for k in libs}
        device_times = {k: [] for k in libs}
        for k in others + ["this", "this"] + others[::-1]:
            times[k].append(median_ms(run[k]))
            device_times[k].append(median_ms(run[k], device_only=True))
        bound, by = tc.transcode_bound_ms(shape, 2)
        dense, _ = tc.transcode_bound_ms(shape, 2, dense=True)
        this_ms = statistics.mean(times["this"])
        this_dev = statistics.mean(device_times["this"])
        for k in libs:
            ms = statistics.mean(times[k])
            dev_ms = statistics.mean(device_times[k])
            emit(f"{name} {k} shape={shape} equal_to_plain={equal[k]} "
                 f"ms={times[k]!r} device_ms={device_times[k]!r} "
                 f"bound_ms={bound:.6f} bound_by={by} "
                 f"dense_bound_ms={dense:.6f} share={bound / ms:.4f} "
                 f"device_share={bound / dev_ms:.4f} "
                 f"dense_share={dense / ms:.4f} "
                 f"this_speedup={ms / this_ms:.3f} "
                 f"this_device_speedup={dev_ms / this_dev:.3f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
