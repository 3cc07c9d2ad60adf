"""On the card: one short run of each cell through the command, correct."""

import json
import subprocess
import sys

import pytest

from harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rtflame512.series8", "turb1024.flagship"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cuda_device, workload, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          "2718281828", "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=1200, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    want = spec.load_cell(workload).per_layer if trace else spec.load_cell(workload).end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
