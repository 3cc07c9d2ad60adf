"""Registered volume_average analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/volume_average.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def volume_average(self, *args, **kwargs):
    return self.mesh.volume_average(*args, **kwargs)
