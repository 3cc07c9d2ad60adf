"""Registered slice_average analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/slice_average.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def slice_average(self, *args, **kwargs):
    return self.mesh.slice_average(*args, **kwargs)
