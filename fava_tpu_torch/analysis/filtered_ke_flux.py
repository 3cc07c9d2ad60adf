"""Registered filtered (coarse-grained) SGS kinetic-energy flux and
structure-function exponents: forward to the active mesh (counterpart of
fava_tpu/analysis/filtered_ke_flux.py; the flux is ops/coarse_grain.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def filtered_kinetic_energy_flux(self, *args, **kwargs):
    return self.mesh.filtered_kinetic_energy_flux(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def structure_function_exponents(self, *args, **kwargs):
    return self.mesh.structure_function_exponents(*args, **kwargs)
