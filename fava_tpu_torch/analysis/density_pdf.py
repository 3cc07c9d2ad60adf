"""Registered density_pdf analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/density_pdf.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def density_pdf(self, *args, **kwargs):
    return self.mesh.density_pdf(*args, **kwargs)
