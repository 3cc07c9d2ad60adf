"""Registered slice_integration analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/slice_integration.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def slice_integration(self, *args, **kwargs):
    return self.mesh.slice_integration(*args, **kwargs)
