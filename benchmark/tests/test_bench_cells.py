"""Cells, mixes, metrics and roles are found by name; a cell added as
files alone runs."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from harness import runner, spec

BENCH = spec.load_benchmark()


def test_every_cell_resolves():
    assert {w["name"] for w in BENCH["workloads"]} >= {"rtflame512.series8", "turb1024.flagship"}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.traffic["fields"]) <= set(cell.config["fields"])
        spec.load_module("generators", cell.config["generator"]).fill
        spec.load_module("reference", cell.traffic["reference"]).outputs
        ref = spec.load_module("reference", cell.traffic["reference"])
        assert set(cell.limits) >= set(ref.EXACT)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_contract_shape_of_benchmark_json():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """Copy the benchmark, add a configuration, a mix, limits, an
    end-to-end metric and a kernel role as files and an entry in
    BENCHMARK.json, and run the new cell on the CPU from the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = root / "benchmark"
    config = json.loads((b / "configs" / "turb1024.json").read_text())
    config.update(name="dummy", shape=[16, 16, 16])
    (b / "configs" / "dummy.json").write_text(json.dumps(config))
    traffic = json.loads((b / "traffic" / "flagship.json").read_text())
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    shutil.copy(b / "limits" / "turb1024.flagship.json", b / "limits" / "dummy.cell.json")
    (b / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.walls)) if run.walls else None\n")
    (b / "kernels" / "dummy_role.py").write_text(textwrap.dedent('''
        ROLE = "dummy role"
        NAMES = (r"never_launched_kernel",)
        COUNTERS = ()
        def work(kernel, ctx):
            return None
        '''))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy", "source": "test", "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f'''
        import json, sys, time
        sys.path[:0] = [{str(b)!r}, {str(spec.ROOT)!r}]
        from harness import runner, spec
        assert spec.BENCH_DIR == __import__("pathlib").Path({str(b)!r})
        roles = [r.ROLE for r in spec.kernel_roles()]
        assert "dummy role" in roles, roles
        print(json.dumps(runner.run("dummy.cell", 5, 0.2, False, time.perf_counter(), device="cpu")))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["requests_done"]["value"] >= 1
    assert set(result["metrics"]) == {"snapshots_per_s", "request_p90_ms", "setup_s", "requests_done"}


def test_a_cell_on_more_than_one_chip_is_not_run():
    """The harness drives one device: a cell asking for four is refused,
    not run on one and reported as four."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["chips"] = 4
    with pytest.raises(runner.NoDevice, match="4 chips"):
        runner.run(bench["workloads"][0]["name"], 1, 0.01, False, 0.0, device="cpu",
                   shape=(8, 8, 8), bench=bench)
