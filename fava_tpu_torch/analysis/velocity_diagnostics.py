"""Registered velocity diagnostics and gradient statistics: forward to
the active mesh (counterpart of fava_tpu/analysis/velocity_diagnostics.py,
ops/velocity.py and ops/gradients.py)."""

from fava_tpu_torch.analysis.two_point import _uniform_mesh_method
from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def helmholtz_decomposition(self, *args, **kwargs):
    return self.mesh.helmholtz_decomposition(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def vorticity(self, *args, **kwargs):
    return self.mesh.vorticity(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def dilatation(self, *args, **kwargs):
    return self.mesh.dilatation(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def enstrophy_spectra(self, *args, **kwargs):
    return self.mesh.enstrophy_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def helicity_spectra(self, *args, **kwargs):
    return self.mesh.helicity_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def transfer_spectra(self, *args, **kwargs):
    return self.mesh.transfer_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def decomposed_kinetic_energy_spectra(self, *args, **kwargs):
    return self.mesh.decomposed_kinetic_energy_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def anisotropic_kinetic_energy_spectra(self, *args, **kwargs):
    return self.mesh.anisotropic_kinetic_energy_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def turbulence_summary(self, *args, **kwargs):
    return self.mesh.turbulence_summary(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def velocity_gradient_statistics(self, *args, **kwargs):
    return _uniform_mesh_method(self.mesh, "velocity_gradient_statistics")(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def gradient_invariant_pdfs(self, *args, **kwargs):
    return _uniform_mesh_method(self.mesh, "gradient_invariant_pdfs")(*args, **kwargs)
