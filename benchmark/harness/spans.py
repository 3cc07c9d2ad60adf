"""The port's own spans in a traced run: device time by stage, the host's
synchronisations in the traced window and the idle inside the step.

The port names the flagship step's stages and its synchronising copies
with ``fava.*`` spans (``fava_tpu_torch/utils/profiling.py``).
torch.profiler writes those spans, the host's CUDA calls and the
device's operations into one Chrome trace, and a launch call carries the
same ``args.correlation`` as the operation it started. A device
operation is credited to the innermost stage span that holds its launch,
both times of the host. Where the operation itself ran says nothing of
the stage that launched it: the device runs behind the host, and its
timestamps drift from the host's, by up to milliseconds in one trace.
A synchronisation is a CUDA call that blocks the host until the card has
drained (``SYNC_CALLS``: a ``.cpu()`` or a pageable copy to the card is a
``cudaMemcpyAsync`` and then a ``cudaStreamSynchronize``), counted
wherever it is made in the window, the harness's own copies included;
the innermost ``fava.*`` span holding it names its site.

The runner writes the trace to ``CACHE_DIR/traces/<cell>.pt.trace.json``;
it is read once per run. A trace whose traced window is not the run's
(a file left by another run) or that holds no ``fava.*`` span (a
program without them) gives None, and so does every reader.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from harness import spec
from harness.trace import DEVICE_CATS, REQUEST_SPAN

STAGES = ("fava.transforms", "fava.powers", "fava.binning", "fava.profiles")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                        "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
                        "cuEventSynchronize"})


@dataclass(frozen=True)
class Spans:
    """What the ``fava.*`` spans of a traced window hold."""

    window: Tuple[float, float]  # the request spans' extent, as harness.trace.parse takes it
    device_us: Dict[str, float]  # stage -> device time of the operations launched in it
    syncs: Dict[str, int]  # site (innermost fava.* span, "" for none) -> SYNC_CALLS in the window
    stages: Tuple[Tuple[float, float, str], ...]  # the stage spans in the window, on the host
    launched_at: Dict[float, float]  # a device operation's start -> its launch on the host

    def in_step(self, a: float, b: float) -> bool:
        """Whether the device's idle gap (a, b) falls in a stage on the
        host's clock. One stream: the device idles until the host launches
        the operation that ends the gap, so the gap's midpoint on the host's
        clock is that launch less half the gap; the device's own clock may
        stand milliseconds off. A gap that no launched operation ends (the
        window's last) is not the step's."""
        launch = self.launched_at.get(b)
        t = None if launch is None else launch - (b - a) / 2
        return t is not None and any(lo <= t <= hi for lo, hi, _ in self.stages)


def _innermost(spans, t: float) -> Optional[tuple]:
    holding = [s for s in spans if s[0] <= t <= s[1]]
    return min(holding, key=lambda s: s[1] - s[0]) if holding else None


def _correlation(e: dict) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


def credit(events: List[dict]) -> Optional[Spans]:
    """The spans of a Chrome trace's traced window; None when the trace
    holds no request span or no ``fava.*`` span."""
    x = [e for e in events if e.get("ph") == "X"]
    requests = [e for e in x if e.get("cat") == "user_annotation" and e.get("name") == REQUEST_SPAN]
    ours = [e for e in x if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("fava.")]
    if not requests or not ours:
        return None
    lo = min(float(e["ts"]) for e in requests)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in requests)
    named = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in ours]
    stages = [s for s in named if s[2] in STAGES]
    launches = {}
    for e in x:
        c = _correlation(e) if e.get("cat") in LAUNCH_CATS else None
        if c is not None:
            launches[c] = float(e["ts"])
    device_us = {s: 0.0 for s in STAGES}
    launched_at = {}
    for e in x:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        t = launches.get(_correlation(e))
        if t is None or not (ts + dur > lo and ts < hi):
            continue
        launched_at[ts] = t
        stage = _innermost(stages, t)
        if stage is not None:
            device_us[stage[2]] += dur
    syncs: Dict[str, int] = {}
    for e in x:
        t = float(e["ts"])
        if e.get("cat") in LAUNCH_CATS and e.get("name") in SYNC_CALLS and lo <= t < hi:
            site = _innermost(named, t)
            key = "" if site is None else site[2]
            syncs[key] = syncs.get(key, 0) + 1
    held = tuple(s for s in stages if s[1] > lo and s[0] < hi)
    return Spans((lo, hi), device_us, syncs, held, launched_at)


@lru_cache(maxsize=4)
def _read_file(path: str, mtime_ns: int, size: int):
    return credit(json.loads(Path(path).read_text())["traceEvents"])


def read(run) -> Optional[Spans]:
    """The spans of ``run``'s traced window, or None."""
    if run.trace is None:
        return None
    path = spec.CACHE_DIR / "traces" / f"{run.cell.name}.pt.trace.json"
    if not path.is_file():
        return None
    st = path.stat()
    spans = _read_file(str(path), st.st_mtime_ns, st.st_size)
    if spans is None or spans.window != (run.trace.lo, run.trace.hi):
        return None
    return spans


def stage_ms_per_snapshot(run, stage: str) -> Optional[float]:
    """Device time of the operations launched in ``stage``, per snapshot, in
    ms: 0 where the stage's span ran and launched nothing, None where the
    window holds no such span."""
    spans = read(run)
    if spans is None or not any(name == stage for _, _, name in spans.stages):
        return None
    return spans.device_us[stage] / 1e3 / run.snapshots
