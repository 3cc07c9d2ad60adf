"""Registered kinetic_energy_spectra analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/kinetic_energy_spectra.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def kinetic_energy_spectra(self, *args, **kwargs):
    return self.mesh.kinetic_energy_spectra(*args, **kwargs)
