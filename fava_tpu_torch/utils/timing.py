"""Wall-clock timing of registered analyses.

Counterpart of fava_tpu/utils/timing.py: the decorator records per-name
wall-clock samples and prints one line per call; ``trace`` records a
region's sample inside a profiler span (utils/profiling.py). Device work
is asynchronous under PyTorch, so a sample covers the device only where
the timed code waits for its result (the analyses return host arrays,
which does).
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List

from fava_tpu_torch.utils.profiling import annotate

_TIMINGS: Dict[str, List[float]] = defaultdict(list)

# Emit "Timing: <name> --> <sec>" lines (disable for quiet runs).
VERBOSE: bool = True


def timings() -> Dict[str, List[float]]:
    """All recorded wall-clock samples, keyed by function name."""
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


@contextmanager
def trace(name: str):
    """Context manager: wall-clock a region into ``timings()`` under
    ``name``, inside an ``annotate(name)`` profiler span. It does not
    synchronize the device (nor does fava_tpu's): the sample covers the
    region's device work only where the region waits for it."""
    tbeg = time.perf_counter()
    with annotate(name):
        yield
    _TIMINGS[name].append(time.perf_counter() - tbeg)


def timer(func: Callable[..., Any]) -> Callable[..., Any]:
    """Decorator printing and recording the wall-clock time of each call."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        tbeg = time.perf_counter()
        result = func(*args, **kwargs)
        tend = time.perf_counter()
        _TIMINGS[func.__name__].append(tend - tbeg)
        if VERBOSE:
            print(f"Timing: {func.__name__} --> {tend - tbeg:2.4f}", flush=True)
        return result

    return wrapper
