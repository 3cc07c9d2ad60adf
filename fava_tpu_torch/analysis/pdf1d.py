"""Registered pdf1d analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/pdf1d.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def pdf1d(self, *args, **kwargs):
    return self.mesh.pdf1d(*args, **kwargs)
