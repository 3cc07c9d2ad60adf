"""Registered flame_surface analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/flame_surface.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def flame_surface(self, *args, **kwargs):
    return self.mesh.flame_surface(*args, **kwargs)
