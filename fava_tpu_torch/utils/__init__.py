"""Host utilities: type tables, exceptions, timing and trace spans,
device/dtype policy, interrupt handling, logging setup and the kernel
build cache (``profiling`` and ``debug`` are imported by name, as in
fava_tpu)."""

from fava_tpu_torch.utils._exceptions import (
    InvalidAnalysisError,
    InvalidMeshError,
    NotCallableError,
)
from fava_tpu_torch.utils._types import HID_T, NP_T
from fava_tpu_torch.utils.cache import enable_compilation_cache
from fava_tpu_torch.utils.interrupt import FAVAInterruptHandler, InterruptHandler
from fava_tpu_torch.utils.logging_config import configure as configure_logging
from fava_tpu_torch.utils.precision import (
    accum_dtype,
    asdevice,
    complex_dtype,
    compute_dtype,
    field_dtype,
    resolve_device,
    set_compute_dtype,
    to_device,
)
from fava_tpu_torch.utils.timing import reset_timings, timer, timings, trace

__all__ = [
    "HID_T",
    "NP_T",
    "FAVAInterruptHandler",
    "InterruptHandler",
    "InvalidAnalysisError",
    "InvalidMeshError",
    "NotCallableError",
    "accum_dtype",
    "asdevice",
    "complex_dtype",
    "compute_dtype",
    "configure_logging",
    "enable_compilation_cache",
    "field_dtype",
    "reset_timings",
    "resolve_device",
    "set_compute_dtype",
    "timer",
    "timings",
    "to_device",
    "trace",
]
