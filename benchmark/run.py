"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Runs from the root of a checkout, on its first CUDA card.  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones, read under ``torch.profiler``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the plain reference beside its limit.  The run's conditions (host threads,
cores and load, the card's name, power limit and clocks around the window,
the inputs' digests, the link rate, the warm-up) go to standard error
before the checks, which end it.  Exits 2 without a card, or without the
program beside the benchmark; 3 if a JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the checkout's root, not this directory, on the path: the program and
    # the benchmark are packages of the checkout
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    threads = cells.pin_threads(cell.config)
    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, "build", "benchmark_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    if not os.path.isfile(os.path.join(ROOT, "rabbit_transcoding_tpu_torch",
                                       "__init__.py")):
        print("the program (rabbit_transcoding_tpu_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2

    import torch

    torch.set_num_threads(threads["torch_intra_op"])
    torch.set_num_interop_threads(threads["torch_inter_op"])
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    from benchmark import harness

    harness.conditions(threads)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX packages loaded in the benchmark's process: {loaded}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        harness.log(f"check {name}: {value!r} (limit {limit!r})")
    harness.log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
