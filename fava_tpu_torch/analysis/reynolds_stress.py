"""Registered reynolds_stress analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/reynolds_stress.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def reynolds_stress(self, *args, **kwargs):
    return self.mesh.reynolds_stress(*args, **kwargs)
