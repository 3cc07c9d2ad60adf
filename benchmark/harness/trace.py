"""The device trace of a run: open it, read it, classify its operations.

The profiler runs with the settings of the port's
``utils.profiling.device_trace`` (host and CUDA activity, one recording
cycle) and its check that a region which put work on the card left
device events in the trace. The Chrome trace that torch.profiler writes
is read back; every device operation in the traced window is one of:

- ``copy``: a memcpy or memset;
- ``own``: one of the port's hand-written kernels (a ``__global__`` name
  in ``fava_tpu_torch/csrc``);
- ``torch``: a PyTorch kernel (``at::``, ``c10::`` or cub namespaces);
- ``cufft``: any other kernel whose name is cuFFT's (fft, radix, r2c,
  c2r, ...);
- ``other``: a kernel of none of these, reported by name.

The window runs from the start of the first ``request`` span the harness
records to the end of the last.
"""

from __future__ import annotations

import importlib.util
import json
import re
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

REQUEST_SPAN = "request"
DEVICE_CATS = {"kernel": None, "gpu_memcpy": "copy", "gpu_memset": "copy"}
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
_TORCH = re.compile(r"\bat::|\bat_cuda_detail\b|\bc10::|\bcub::|\bCUB_|\bcutlass\b")
_CUFFT = re.compile(r"fft|FFT|radix|Radix|r2c|c2r|R2C|C2R|postprocess|preprocess|bluestein")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
NAME_CHARS = 160


@lru_cache(maxsize=1)
def own_kernel_names() -> Tuple[str, ...]:
    """The ``__global__`` function names in the port's csrc/ sources."""
    spec = importlib.util.find_spec("fava_tpu_torch")
    if spec is None or spec.origin is None:
        raise ModuleNotFoundError("fava_tpu_torch is not importable")
    csrc = Path(spec.origin).parent / "csrc"
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return tuple(sorted(names))


def classify(name: str, cat: str, own: Iterable[str]) -> str:
    kind = DEVICE_CATS.get(cat)
    if kind is not None:
        return kind
    for k in own:
        if re.search(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])", name):
            return "own"
    if _TORCH.search(name):
        return "torch"
    if _CUFFT.search(name):
        return "cufft"
    return "other"


@dataclass
class Op:
    name: str
    cls: str
    ts: float  # microseconds
    dur: float


@dataclass
class Trace:
    lo: float
    hi: float
    ops: List[Op]
    host: List[dict] = field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the window."""
        merged: List[List[float]] = []
        for op in sorted(self.ops, key=lambda o: o.ts):
            a, b = max(op.ts, self.lo), min(op.ts + op.dur, self.hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the window, between busy intervals."""
        out, end = [], self.lo
        for a, b in self.busy_intervals():
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.hi > end:
            out.append((end, self.hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation in flight at ``t`` (the harness's
        request span when nothing inside it is)."""
        best: Optional[dict] = None
        for e in self.host:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
                best = e
        return "host idle" if best is None else best["name"][:NAME_CHARS]

    def total_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for op in self.ops:
            out[op.name] = out.get(op.name, 0.0) + op.dur
        return out


def parse(events: List[dict], own: Iterable[str]) -> Trace:
    """The traced window of a Chrome trace's events."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == REQUEST_SPAN]
    if not spans:
        raise ValueError(f"the trace holds no {REQUEST_SPAN!r} span")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    own = tuple(own)
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if ts + dur > lo and ts < hi:
                ops.append(Op(e["name"], classify(e["name"], cat, own), ts, dur))
        elif cat in HOST_CATS and ts + dur > lo and ts < hi:
            host.append({"name": e["name"], "ts": ts, "dur": dur})
    return Trace(lo, hi, ops, host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host operation in flight at their middle (seconds)."""
    totals = sorted(trace.total_by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:NAME_CHARS], us / 1e6] for name, us in totals],
        "idle_gaps": [[trace.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps],
    }


@contextmanager
def device_trace(path: Path, device: torch.device):
    """torch.profiler over the enclosed region, its Chrome trace written
    to ``path``; yields a list that holds the trace's events afterwards.
    Raises RuntimeError when a CUDA trace holds no device event."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    events: List[dict] = []
    # acc_events: one recording cycle, as utils.profiling.device_trace runs it
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    with prof:
        try:
            yield events
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events.extend(json.loads(path.read_text())["traceEvents"])
    if device.type == "cuda" and not any(e.get("cat") in DEVICE_CATS for e in events):
        raise RuntimeError(f"the trace {path} holds no device event (CUDA activity was not recorded)")
