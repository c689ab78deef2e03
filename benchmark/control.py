"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--units 2]

For each seed, in one process: the cell's inputs; the program driven
through the cell's own protocol for ``--units`` rounds or GOFs after its
warm-up, every output held against the float32 reference (the lower
readings); and the control, the reference computed with TF32 products put
in the program's place, held against the same reference (the upper
readings).  One JSON line per seed and side.  The benchmark's runs never
run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, units: int, device) -> tuple[dict, dict]:
    """-> (the program's worst numbers, the control's worst numbers)."""
    from benchmark import harness
    from benchmark.reference import chains, check

    proto_mod = harness.protocol(cell)
    inputs = proto_mod.inputs(cell, seed, device)
    proto = proto_mod.Protocol(cell, inputs, device)
    rec = harness.Recorder(cell.config["atlas"]["frames"])
    proto.run(rec, count=cell.traffic["warm"] + units)
    del proto
    program = {k: v for k, (v, _) in
               proto_mod.judge(cell, inputs, rec, device).items()}
    program["failed"] = rec.failed
    numbers = []
    for data in inputs:
        want = proto_mod.expected(cell, data, device)
        with chains.tf32_products():
            control = proto_mod.expected(cell, data, device)
        numbers.append(check.compare(want, control, device))
    return program, check.worst(numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    threads = cells.pin_threads(cell.config)
    import torch

    torch.set_num_threads(threads["torch_intra_op"])
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        program, control = readings(cell, seed, args.units, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
