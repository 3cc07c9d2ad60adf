#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... [--control-seeds 7,8,9]

For each of ``--seeds``: the cell's inputs from that seed, the program's
entry warmed and driven by one request at the cell's size, its state
freed, then every number the run compares against the float64 reference
(the lower readings). For each of ``--control-seeds``: the control, the
reference computed with its inputs, products and transforms in bfloat16
and float32 accumulation, put in the program's place and read against
the float64 reference (the upper readings). One JSON line a seed, then
the largest program reading and the smallest control reading of each
number. The benchmark's runs do not run this.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def readings(cell, seed, dev, control: bool):
    import torch

    from harness import entries, runner, spec

    inputs = entries.make_inputs(cell.config, cell.traffic, seed, dev)
    if control:
        reference = spec.load_module("reference", cell.traffic["reference"])
        batch = int(cell.traffic.get("batch", 1))
        outputs = [[reference.outputs(entries.snapshot(inputs, i), dtype=torch.float32,
                                      store=torch.bfloat16) for i in range(batch)]]
    else:
        entry = entries.Entry(cell.traffic, inputs, cell.config, dev)
        entry.request()
        outputs = [entry.request()]
        entry.release()
        del entry
    gc.collect()
    torch.cuda.empty_cache()
    numbers = {}
    failed = runner.judge(cell, inputs, outputs, numbers)
    del inputs, outputs
    gc.collect()
    torch.cuda.empty_cache()
    return numbers, failed


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    import torch

    from harness import spec
    from fava_tpu_torch.utils import enable_compilation_cache

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    enable_compilation_cache(spec.CACHE_DIR / "kernels")
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    worst, least = {}, {}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            numbers, failed = readings(cell, seed, dev, kind == "control")
            print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                              "failed_requests": failed, "numbers": numbers}), flush=True)
            for k, v in numbers.items():
                if kind == "program":
                    worst[k] = max(worst.get(k, 0.0), v)
                else:
                    least[k] = min(least.get(k, float("inf")), v)
    print(json.dumps({"workload": cell.name, "program_largest": worst, "control_smallest": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
