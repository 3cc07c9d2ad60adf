"""Analysis registry: importing this package registers every analysis
onto the port's Model and exports the analysis functions under
fava_tpu's names (fava_tpu/analysis/__init__.py). As there, a function
hides the module of the same name (``pdf1d``, ``reynolds_stress``, ...)
as an attribute of the package; ``importlib.import_module`` still
gives the module."""

from fava_tpu_torch.analysis.reynolds_stress import reynolds_stress
from fava_tpu_torch.analysis.slice_average import slice_average
from fava_tpu_torch.analysis.slice_integration import slice_integration
from fava_tpu_torch.analysis.volume_average import volume_average
from fava_tpu_torch.analysis.volume_integration import volume_integration
from fava_tpu_torch.analysis.favre_profiles import favre_profiles
from fava_tpu_torch.analysis.cross_correlation import cross_correlation
from fava_tpu_torch.analysis.auto_correlations import (
    eulerian_autocorrelation,
    lagrangian_autocorrelation,
)
from fava_tpu_torch.analysis.flame_surface import flame_surface
from fava_tpu_torch.analysis.fractal_dimension import fractal_dimension
from fava_tpu_torch.analysis.kinetic_energy_spectra import kinetic_energy_spectra
from fava_tpu_torch.analysis.scalar_spectra import scalar_spectra
from fava_tpu_torch.analysis.velocity_diagnostics import (
    anisotropic_kinetic_energy_spectra,
    decomposed_kinetic_energy_spectra,
    dilatation,
    enstrophy_spectra,
    helicity_spectra,
    helmholtz_decomposition,
    transfer_spectra,
    turbulence_summary,
    vorticity,
)
from fava_tpu_torch.analysis.filtered_ke_flux import (
    filtered_kinetic_energy_flux,
    structure_function_exponents,
)
from fava_tpu_torch.analysis.binned_statistic import binned_statistic
from fava_tpu_torch.analysis.dispersion import dispersion_statistics
from fava_tpu_torch.analysis.particle_structure import particle_structure_functions
from fava_tpu_torch.analysis.structure_functions import (
    structure_functions,
    velocity_increment_pdfs,
)
from fava_tpu_torch.analysis.two_point import (
    two_point_correlation,
    velocity_correlations,
)
from fava_tpu_torch.analysis.density_pdf import density_pdf
from fava_tpu_torch.analysis.pdf1d import pdf1d
from fava_tpu_torch.analysis.projection import projection
from fava_tpu_torch.analysis.pdf2d import pdf2d
from fava_tpu_torch.analysis.mass_sum import mass_sum
from fava_tpu_torch.analysis.flagship_analysis import flagship_analysis
from fava_tpu_torch.analysis.time_series import (
    favre_series,
    flagship_series,
    particle_series,
    reynolds_series,
    summary_series,
)

__all__ = [
    "reynolds_stress",
    "slice_average",
    "slice_integration",
    "volume_average",
    "volume_integration",
    "favre_profiles",
    "cross_correlation",
    "eulerian_autocorrelation",
    "lagrangian_autocorrelation",
    "fractal_dimension",
    "kinetic_energy_spectra",
    "scalar_spectra",
    "helmholtz_decomposition",
    "vorticity",
    "dilatation",
    "enstrophy_spectra",
    "helicity_spectra",
    "transfer_spectra",
    "decomposed_kinetic_energy_spectra",
    "anisotropic_kinetic_energy_spectra",
    "flame_surface",
    "turbulence_summary",
    "filtered_kinetic_energy_flux",
    "structure_function_exponents",
    "binned_statistic",
    "dispersion_statistics",
    "particle_structure_functions",
    "structure_functions",
    "velocity_increment_pdfs",
    "two_point_correlation",
    "velocity_correlations",
    "density_pdf",
    "pdf1d",
    "pdf2d",
    "projection",
    "mass_sum",
    "flagship_analysis",
    "favre_series",
    "flagship_series",
    "particle_series",
    "reynolds_series",
    "summary_series",
]
