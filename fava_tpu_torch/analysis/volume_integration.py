"""Registered volume_integration analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/volume_integration.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def volume_integration(self, *args, **kwargs):
    return self.mesh.volume_integration(*args, **kwargs)
