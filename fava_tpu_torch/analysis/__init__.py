"""Analyses registered onto the port's Model (importing registers them)."""

from fava_tpu_torch.analysis import (  # noqa: F401
    favre_profiles,
    flagship_analysis,
    reynolds_stress,
    slice_average,
    slice_integration,
)

__all__ = [
    "favre_profiles",
    "flagship_analysis",
    "reynolds_stress",
    "slice_average",
    "slice_integration",
]
