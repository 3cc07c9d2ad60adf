"""Registered pdf2d analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/pdf2d.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def pdf2d(self, *args, **kwargs):
    return self.mesh.pdf2d(*args, **kwargs)
