"""Registered flagship_analysis: the fused spectra + Reynolds/Favre
profile step on a uniform mesh, as a model-level analysis."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def flagship_analysis(self, *args, **kwargs):
    return self.mesh.flagship_analysis(*args, **kwargs)
