"""Registered scalar_spectra analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/scalar_spectra.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def scalar_spectra(self, *args, **kwargs):
    return self.mesh.scalar_spectra(*args, **kwargs)
