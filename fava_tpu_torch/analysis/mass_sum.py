"""Registered mass_sum analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/mass_sum.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def mass_sum(self, *args, **kwargs):
    return self.mesh.mass_sum(*args, **kwargs)
