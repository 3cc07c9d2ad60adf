"""Nothing the benchmark runs loads JAX or fava_tpu; without the card,
or without the program, a run prints no result."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from harness import guard, spec


def test_forbidden_by_whole_top_level_name():
    assert guard.forbidden_loaded(["fava_tpu_torch", "fava_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["fava_tpu.ops.spectra", "numpy"]) == ["fava_tpu"]
    assert guard.forbidden_loaded(["jax", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_cpu_run_loads_no_forbidden_module():
    code = textwrap.dedent(f'''
        import json, sys, time
        sys.path[:0] = [{str(spec.BENCH_DIR)!r}, {str(spec.ROOT)!r}]
        from harness import guard, runner
        r = runner.run("rtflame512.series8", 9, 0.1, False, time.perf_counter(), device="cpu",
                       shape=(16, 16, 16))
        import calibrate  # the calibration script's imports too
        print(json.dumps({{"bad": guard.forbidden_loaded(), "correct": r["correct"],
                          "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["correct"] is True
    assert "fava_tpu_torch" in res["loaded"]


def test_a_loaded_forbidden_module_refuses_the_result(monkeypatch):
    import time

    from harness import runner

    monkeypatch.setitem(sys.modules, "fava_tpu", type(sys)("fava_tpu"))
    with pytest.raises(guard.ForbiddenModules):
        runner.run("turb1024.flagship", 1, 0.05, False, time.perf_counter(), device="cpu",
                   shape=(16, 16, 16))


def test_no_result_without_the_card_or_the_program(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is here")
    run = [sys.executable, "benchmark/run.py", "--workload", "turb1024.flagship", "--seed",
           "3000000019", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(run, capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and "{" not in out.stdout
    bare = tmp_path / "bare"
    shutil.copytree(spec.BENCH_DIR, bare / "benchmark", ignore=shutil.ignore_patterns(".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", bare)
    out = subprocess.run(run, capture_output=True, text=True, timeout=300, cwd=bare)
    assert out.returncode != 0 and "{" not in out.stdout


def test_bare_checkout_without_the_program_fails(tmp_path):
    """Without fava_tpu_torch beside it the harness cannot import the program."""
    bare = tmp_path / "bare"
    shutil.copytree(spec.BENCH_DIR, bare / "benchmark", ignore=shutil.ignore_patterns(".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", bare)
    code = textwrap.dedent(f'''
        import sys, time
        sys.path[:0] = [{str(bare / "benchmark")!r}, {str(bare)!r}]
        from harness import runner
        runner.run("turb1024.flagship", 1, 0.05, False, time.perf_counter(), device="cpu", shape=(16, 16, 16))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=bare)
    assert out.returncode != 0 and "ModuleNotFoundError" in out.stderr
