"""Registered structure_function_exponents analysis: forwards to the
active mesh (counterpart of fava_tpu/analysis/filtered_ke_flux.py, whose
``filtered_kinetic_energy_flux`` comes with ROADMAP A8)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def structure_function_exponents(self, *args, **kwargs):
    return self.mesh.structure_function_exponents(*args, **kwargs)
