"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``python3 -m benchmark.run`` works too). It
loads the cell named in ``BENCHMARK.json``, makes its inputs from the seed,
builds and warms up the port, runs the closed loop for ``--seconds``, reads
the peak memory, frees the port's state, judges a sample of the window's
outputs against the plain reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are the
last lines of standard error. Exits non-zero, printing no result, without
a CUDA device or with fewer than the cell asks for, or when JAX or the JAX
package was loaded. ``--control bfloat16`` puts the reference, computed in
bfloat16, in the port's place in the check: the control that every cell's
comparison has to fail; the benchmark's own runs never pass it.

Build caches stay inside the checkout: the port builds its kernels into
``build/tracer_torch/``, and ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` point under ``build/benchmark/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = CHECKOUT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if sys.path and Path(sys.path[0]).resolve() == CHECKOUT / "benchmark":
        sys.path[0] = str(CHECKOUT)
    elif str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))

    import torch

    from benchmark.harness import Bench, forbidden_modules, run_cell

    bench = Bench(CHECKOUT / "BENCHMARK.json")
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        line = run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda"), T_START,
                        control=args.control, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: JAX or the JAX package was loaded: {bad}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
