"""Analyses registered onto the port's Model (importing registers them)."""

from fava_tpu_torch.analysis import (  # noqa: F401
    binned_statistic,
    density_pdf,
    favre_profiles,
    flagship_analysis,
    kinetic_energy_spectra,
    mass_sum,
    pdf1d,
    pdf2d,
    reynolds_stress,
    scalar_spectra,
    slice_average,
    slice_integration,
    time_series,
    volume_average,
    volume_integration,
)

__all__ = [
    "binned_statistic",
    "density_pdf",
    "favre_profiles",
    "flagship_analysis",
    "kinetic_energy_spectra",
    "mass_sum",
    "pdf1d",
    "pdf2d",
    "reynolds_stress",
    "scalar_spectra",
    "slice_average",
    "slice_integration",
    "time_series",
    "volume_average",
    "volume_integration",
]
