#!/usr/bin/env python3
"""The benchmark of fava_tpu_torch, one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Makes the cell's inputs on the card from the
seed, warms up, then runs the window (``--trace 0``: the cell's
end-to-end metrics) or the traced requests (``--trace 1``: its per-layer
metrics), compares every output with the plain reference, and prints one
JSON object as the last line of standard output. Exits non-zero, with no
result, without the CUDA devices the cell asks for, or when a module of
JAX or of fava_tpu was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import runner

    try:
        result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except runner.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
