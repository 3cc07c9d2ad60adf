"""Profiler integration.

Counterpart of fava_tpu/utils/profiling.py on ``torch.profiler``:
``device_trace`` records the enclosed region (the host's torch ops and,
on the card, the kernels and copies through CUPTI) and writes a
Chrome/Perfetto trace (``*.pt.trace.json``, as
``torch.profiler.tensorboard_trace_handler`` names it) under ``logdir``;
``annotate`` adds named spans, which the trace shows on the host
timeline and, projected, on the device timeline, so device timelines
attribute kernel time to specific analyses. With no profiler running a
span is a shared no-op: the spans below stay in the step at no cost.

The flagship step's stages and its synchronising copies carry the
``SPAN_*`` names. A trace records each span and the CUDA calls that
launch device work on one host clock, and every launch shares a
correlation id with the device operation it started, so a stage's device
time is the time of the operations whose launch falls inside its span.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

from fava_tpu_torch.utils.precision import resolve_device

# Host-side names of the CUDA API calls that put work on the card, as a
# CUDA trace records them.
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")

SPAN_TRANSFORMS = "fava.transforms"
"""sqrt(rho), the three products and rfftn; read by transforms_ms_per_snapshot."""
SPAN_POWERS = "fava.powers"
"""The total and longitudinal power volumes, or B9 (powers, fold and binning in
one pass); read by powers_ms_per_snapshot."""
SPAN_BINNING = "fava.binning"
"""Fold and K4 (or B10), the static counts and transverse, or B9's transverse
alone; read by binning_ms_per_snapshot."""
SPAN_PROFILES = "fava.profiles"
"""K1, K2 and the profiles' assembly; read by profiles_ms_per_snapshot."""
SPAN_SYNC_COUNTS = "fava.sync.counts"
"""The shell counts' copy to the card, a stream sync; its site in host_syncs_per_snapshot."""
SPAN_SYNC_INDEX = "fava.sync.index"
"""The covariance diagonal's index copy, a stream sync; its site in host_syncs_per_snapshot."""
SPAN_SYNC_OUTPUTS = "fava.sync.outputs"
"""The outputs' copies to the host, a sync each; their site in host_syncs_per_snapshot."""

_OFF = nullcontext()


@contextmanager
def device_trace(logdir: str | Path, device="cuda"):
    """Capture a torch.profiler trace of the enclosed region into ``logdir``.

    Records host activity, and on ``device`` "cuda" the card's activity
    too. The region's device work is waited for before the trace stops.
    A CUDA trace that holds no device event although the region launched
    work (a hand-written kernel, or a launch or copy call on the host
    timeline) raises RuntimeError: the trace is then written but empty on
    the device side, which is an error, not a degraded result. CUPTI stays
    attached after a CUDA trace, so the process's later CUDA calls cost a
    little more host time (probe_trace.py); with CUPTI torn down
    (``TEARDOWN_CUPTI=1``) the process's next trace recorded no device
    event, or hung.
    """
    from fava_tpu_torch.ops import cuda_kernels

    dev = resolve_device(device)
    logdir = str(logdir)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = sum(cuda_kernels.launch_counts().values())
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
        acc_events=True,  # one recording cycle; else torch warns that it clears events
    )
    with prof:
        try:
            yield logdir
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    if dev.type != "cuda":
        return
    events = prof.events()
    on_device = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    launched = sum(cuda_kernels.launch_counts().values()) - before
    launched += sum(1 for e in events if e.name.startswith(_LAUNCH_CALLS))
    if launched and not on_device:
        raise RuntimeError(
            f"device_trace({logdir!r}): the region put work on {dev} but the trace holds no "
            "device event (CUDA activity was not recorded)"
        )


def annotate(name: str):
    """Named trace span (context manager) for host and device timelines;
    with no profiler running, one shared no-op that records nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
