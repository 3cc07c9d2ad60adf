"""Registered projection analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/projection.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def projection(self, *args, **kwargs):
    return self.mesh.projection(*args, **kwargs)
