#!/usr/bin/env python3
"""Run one cell of the benchmark of ``audio_analysis_torch`` once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks for.
It makes its recordings and models from the seed, loads and warms the
program (set-up), measures for S seconds, with ``--trace 1`` profiles a
short stretch after the window, checks a seeded sample of what the window
produced against the plain reference, and prints the result as the last
line of standard output (the numbers it compared, beside their limits, as
the last lines of standard error). Without CUDA, or with fewer cards than
the cell asks for, it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, then the program under test


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchlib.harness import jax_modules, run_cell
    from benchlib.spec import load_cell

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, rows = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = jax_modules()
    if found:
        print(f"benchmark: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    from benchlib.check import print_compared

    print_compared(rows)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
