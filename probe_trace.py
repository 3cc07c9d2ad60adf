#!/usr/bin/env python3
"""What a device trace leaves behind, on one NVIDIA GPU.

Run from the repository root:

    python3 probe_trace.py

Each case runs in a process of its own: the host microseconds of three
small calls on the card (``torch.zeros(8)``, an add on 8 values, and the
one-channel folded shell binning, B4, on a 65^3 volume), each the mean
of a loop ended by one synchronize, measured twice before and four times
(2 s apart) after one step of ``flagship_analysis`` at 128^3:
- ``none``: nothing between the measurements;
- ``trace``: the step under ``utils.profiling.device_trace``, as it
  runs (torch leaves CUPTI attached after the trace);
- ``teardown``: the same with ``TEARDOWN_CUPTI=1`` in the environment
  (torch detaches CUPTI when the trace stops). A second trace in such a
  process recorded no device event (device_trace raised) or hung, so
  this case traces once;
- ``checks``: the step under ``utils.debug.enable_checks()``, then
  ``disable_checks()``.
The host shares its cores, so compare the cases' spreads, not one
sample. Its last line is all the results as one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CASES = {"none": {}, "trace": {}, "teardown": {"TEARDOWN_CUPTI": "1"}, "checks": {}}


def child(case: str) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import fava_tpu_torch
    from fava_tpu_torch import flagship
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.utils import debug, profiling, timing

    timing.VERBOSE = False
    fields = flagship.make_example_fields(128)
    model = fava_tpu_torch.from_arrays(dict(zip(("dens", "velx", "vely", "velz"), fields)))
    model.flagship_analysis()
    small = torch.ones(8, device="cuda")
    vol = torch.rand((65, 65, 65), device="cuda")

    def host_us(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / n

    def sample():
        return {"zeros_us": host_us(lambda: torch.zeros(8, device="cuda"), 3000),
                "add_us": host_us(lambda: small.add(1.0), 3000),
                "b4_1ch_us": host_us(lambda: ck.shell_bin_values_folded_1ch(vol, 63, 128, 128), 1000)}

    out = {"before": [sample(), sample()], "after": []}
    if case in ("trace", "teardown"):
        with tempfile.TemporaryDirectory() as tmp, profiling.device_trace(tmp):
            model.flagship_analysis()
    elif case == "checks":
        debug.enable_checks()
        model.flagship_analysis()
        debug.disable_checks()
    for _ in range(4):
        out["after"].append(sample())
        time.sleep(2)
    out["TEARDOWN_CUPTI"] = os.environ.get("TEARDOWN_CUPTI")
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from fava_tpu_torch.ops import _build

    _build.library()  # built once, before the cases load it
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    results = {"card": card}
    for case, env in CASES.items():
        run = subprocess.run([sys.executable, __file__, "--child", case], capture_output=True,
                             text=True, env={**os.environ, **env}, timeout=300)
        if run.returncode != 0:
            sys.exit(f"case {case} failed:\n{run.stderr[-4000:]}")
        results[case] = json.loads(run.stdout.strip().splitlines()[-1])
        med = {k: sorted(s[k] for s in results[case]["after"])[2] for k in results[case]["after"][0]}
        print(f"{case}: before {json.dumps(results[case]['before'])}; after, median {json.dumps(med)}",
              flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
