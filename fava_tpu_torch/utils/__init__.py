"""Host utilities: type tables, exceptions, timing, device/dtype policy,
interrupt handling and logging setup."""

from fava_tpu_torch.utils._exceptions import (
    InvalidAnalysisError,
    InvalidMeshError,
    NotCallableError,
)
from fava_tpu_torch.utils._types import HID_T, NP_T
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
from fava_tpu_torch.utils.timing import reset_timings, timer, timings

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
    "field_dtype",
    "reset_timings",
    "resolve_device",
    "set_compute_dtype",
    "timer",
    "timings",
    "to_device",
]
