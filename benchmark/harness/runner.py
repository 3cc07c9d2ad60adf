"""One run of one cell.

Set-up makes the inputs on the device from the seed, builds the entry
and runs ``WARMUP_REQUESTS`` requests (the kernels' build or load, the
cuFFT plans, the caching allocator's pools). Then either the window: a
closed loop, one client, requests back to back until ``seconds`` have
passed, the window ending with the last request; or, with ``trace``, the
traffic's ``trace_requests`` requests under torch.profiler. Once the
requests are done and the memory peak is read, the program's state is
freed and the reference works out every snapshot again from the same
inputs; every request's outputs are compared with it.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from harness import compare, entries, guard, spec
from harness import trace as tracing
from harness.roofline import Ctx, kernel_table, launch_check


WARMUP_REQUESTS = 1


class NoDevice(RuntimeError):
    """The run cannot be made: the machine lacks the devices the cell
    asks for, or the cell asks for more than one (this harness drives
    one device and launches no ranks)."""


@dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    snapshots: int
    walls: List[float] = field(default_factory=list)
    window_s: Optional[float] = None
    window_peak_bytes: Optional[int] = None
    trace: Optional[tracing.Trace] = None
    launches: Dict[str, int] = field(default_factory=dict)
    roles: list = field(default_factory=list)
    ctx: Optional[Ctx] = None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev: torch.device) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(dev)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(dev)


def _launch_counts() -> Dict[str, int]:
    from fava_tpu_torch.ops import cuda_kernels

    return cuda_kernels.launch_counts()


def _reset_launch_counts() -> None:
    from fava_tpu_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()


def _path_of(launches: Dict[str, int]) -> str:
    if launches.get("block_row_moments") or launches.get("shell_bin_values_rfft_chunk"):
        return "streamed"
    if launches.get("row_moments"):
        return "in core"
    return "unknown"


def _metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _fmt(x: float):
    return x if math.isfinite(x) else "inf"


def judge(cell: spec.Cell, inputs, outputs, numbers: Dict[str, float],
          reference_fn=None) -> int:
    """Compare every request's outputs with the reference of each
    snapshot (``reference_fn(snapshot)``, the traffic's reference module
    when None); merge the readings into ``numbers`` and return the count
    of requests with a reading over its limit."""
    reference = spec.load_module("reference", cell.traffic["reference"])
    reference_fn = reference.outputs if reference_fn is None else reference_fn
    per_request: List[Dict[str, float]] = [{} for _ in outputs]
    for i in range(int(cell.traffic.get("batch", 1))):
        snap = entries.snapshot(inputs, i)
        ref = reference_fn(snap)
        scales = reference.scales(ref, snap) if hasattr(reference, "scales") else {}
        for req, got in zip(per_request, outputs):
            compare.merge(req, compare.snapshot_numbers(got[i], ref, scales, reference.EXACT))
        del ref
    limits = {k: v for k, v in cell.limits.items() if k != compare.INPUTS_CHANGED}
    failed = 0
    for req in per_request:
        failed += not compare.passed(compare.verdict(req, limits))
        compare.merge(numbers, req)
    return failed


def _set_up(cell: spec.Cell, seed: int, dev: torch.device, shape, t_start: float):
    """The inputs, their fingerprints and the warmed entry."""
    stages = {}
    if dev.type == "cuda":
        from fava_tpu_torch.utils import enable_compilation_cache

        stages["imports"] = time.perf_counter() - t_start
        enable_compilation_cache(spec.CACHE_DIR / "kernels")
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        stages["CUDA context"] = time.perf_counter() - t_start
    inputs = entries.make_inputs(cell.config, cell.traffic, seed, dev, shape)
    _sync(dev)
    before = compare.fingerprints(inputs)
    stages["inputs"] = time.perf_counter() - t_start
    entry = entries.Entry(cell.traffic, inputs, cell.config, dev)
    _reset_launch_counts()
    for _ in range(WARMUP_REQUESTS):
        entry.request()
    _sync(dev)
    stages["warm-up"] = time.perf_counter() - t_start
    launched = {k: v for k, v in _launch_counts().items() if v}
    log(f"path: {_path_of(launched)} (launches of the warm-up: {launched})")
    log("set-up, seconds since the process started: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return inputs, before, entry


def _window(entry: entries.Entry, rec: Run, seconds: float, t_start: float) -> list:
    """Requests back to back until ``seconds`` have passed; the window
    ends with the last request."""
    outputs = []
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    while True:
        a = time.perf_counter()
        outputs.append(entry.request())
        b = time.perf_counter()
        rec.walls.append(b - a)
        if b - t0 >= seconds:
            break
    rec.window_s = b - t0
    w = sorted(rec.walls)
    log(f"request walls (ms): n {len(w)}, first {1e3 * rec.walls[0]:.3f}, min {1e3 * w[0]:.3f}, median {1e3 * w[len(w) // 2]:.3f}, "
        f"max {1e3 * w[-1]:.3f}; the ten longest {[round(1e3 * x, 3) for x in w[-10:]]}")
    return outputs


def _traced(entry: entries.Entry, rec: Run, requests: int, dev, t_start: float) -> list:
    """``requests`` requests under the profiler, each in a request span."""
    outputs = []
    path = spec.CACHE_DIR / "traces" / f"{rec.cell.name}.pt.trace.json"
    rec.setup_s = time.perf_counter() - t_start
    with tracing.device_trace(path, dev) as events:
        for _ in range(requests):
            with torch.profiler.record_function(tracing.REQUEST_SPAN):
                outputs.append(entry.request())
    rec.trace = tracing.parse(events, tracing.own_kernel_names())
    log(f"trace: {path} ({len(events)} events)")
    return outputs


def _log_kernels(rec: Run) -> None:
    """The launch counters against the trace, and each kernel against its least time."""
    own = [op for op in rec.trace.ops if op.cls == "own"]
    for role, traced, counted in launch_check(own, rec.roles, rec.launches):
        if traced or counted:
            log(f"launch check: {role}: {traced} in the trace, {counted} counted"
                + ("" if traced == counted else "  MISMATCH"))
    for row in kernel_table(own, rec.roles, rec.ctx):
        least = "n/a" if row.bound_us is None else f"{row.bound_us:.3f} us"
        log(f"kernel: {row.role}: {row.name[:100]} x{row.launches} traced "
            f"{row.traced_us / row.launches:.3f} us, least {least}")
    other = sorted({op.name[:100] for op in rec.trace.ops if op.cls == "other"})
    if other:
        log(f"unclassified device ops: {other}")


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", shape=None, bench: Optional[dict] = None) -> dict:
    """One run of ``workload``; the result line's object. ``t_start``
    is the process's start on ``time.perf_counter``'s clock; ``shape``
    and ``bench`` serve the tests (a small size; another BENCHMARK.json)."""
    cell = spec.load_cell(workload, bench)
    if cell.chips != 1:
        raise NoDevice(f"{workload} asks for {cell.chips} chips; this harness runs a cell on one")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{workload} needs {cell.chips} CUDA device(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        dev = torch.device("cuda", 0)
    inputs, before, entry = _set_up(cell, seed, dev, shape, t_start)
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    shape = tuple(int(s) for s in next(iter(inputs.values())).shape[1:])
    rec = Run(cell=cell, setup_s=0.0, snapshots=0, roles=spec.kernel_roles(),
              ctx=Ctx(shape))
    _reset_launch_counts()
    if trace:
        outputs = _traced(entry, rec, int(cell.traffic["trace_requests"]), dev, t_start)
    else:
        outputs = _window(entry, rec, seconds, t_start)
    rec.launches = _launch_counts()
    rec.snapshots = sum(len(o) for o in outputs)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": 0}
    if dev.type == "cuda":
        rec.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        device_info["memory_peak_bytes"] = max(setup_peak, rec.window_peak_bytes)
        log(f"card: {_card(dev)}")
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_us() / 1e6
        device_info["window_s"] = rec.trace.window_us / 1e6

    # The program's state goes before the reference runs beside the inputs.
    entry.release()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = {compare.INPUTS_CHANGED: compare.inputs_changed(before, compare.fingerprints(inputs))}
    failed = judge(cell, inputs, outputs, numbers)
    checks = compare.verdict(numbers, cell.limits)

    result = {"correct": failed == 0 and compare.passed(checks), "attempted": len(outputs),
              "failed": failed,
              "metrics": _metrics(rec, cell.per_layer if trace else cell.end_to_end),
              "device": device_info}
    if rec.trace is not None:
        _log_kernels(rec)
        result["breakdown"] = tracing.breakdown(rec.trace)
    bad = guard.forbidden_loaded()
    if bad:
        raise guard.ForbiddenModules(f"modules loaded that the benchmark may not load: {bad}")
    result["checks"] = {k: [_fmt(v), lim] for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return result
