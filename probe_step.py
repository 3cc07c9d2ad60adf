#!/usr/bin/env python3
"""Times the 512^3 flagship step of this checkout against another one on
one NVIDIA GPU, in turns.

Run from the repository root:

    python3 probe_step.py DIR [--reps N]

DIR is a checkout of another commit (``git archive <commit> fava_tpu_torch
| tar -x -C DIR``). Each run is a fresh process that imports
``fava_tpu_torch`` from its checkout (building its kernels there), makes
``flagship.make_example_fields(512)`` on the card and times N warm calls
of ``flagship.uniform_analysis_step`` (host clock around synchronized
work, as chip_smoke.py phase 5 does), then one step's device time by
stage (CUDA events: transforms, powers, fold, binning, moments, centered
moments, assembly). The runs go DIR, this, this, DIR, so that both sides
see the card early and late. It prints the card's name and power limit,
a line per run, and last a JSON object with every run.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: str, reps: int) -> None:
    sys.path.insert(0, root)
    import torch

    import fava_tpu_torch
    from fava_tpu_torch import flagship

    if Path(fava_tpu_torch.__file__).resolve().parent.parent != Path(root).resolve():
        sys.exit(f"fava_tpu_torch came from {fava_tpu_torch.__file__}, not {root}")
    sys.path.insert(0, str(HERE))
    from chip_smoke import stage_ms

    fields = flagship.make_example_fields(512)
    flagship.uniform_analysis_step(*fields)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        flagship.uniform_analysis_step(*fields)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    stage_ms(torch, fields)
    print(json.dumps({"root": root, "step_s": walls, "median_s": statistics.median(walls),
                      "stage_ms": stage_ms(torch, fields)}), flush=True)


def main() -> None:
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        child(sys.argv[i + 1], int(sys.argv[i + 2]))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    other = str(Path(sys.argv[1]).resolve())
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 20
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for root in (other, str(HERE), str(HERE), other):
        res = subprocess.run([sys.executable, __file__, "--child", root, str(reps)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"run in {root} failed:\n{res.stdout}\n{res.stderr}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["checkout"] = "this" if root == str(HERE) else "other"
        runs.append(run)
        print(f"{run['checkout']}: median {run['median_s']!r} s, stages (ms) {json.dumps(run['stage_ms'])}",
              flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
