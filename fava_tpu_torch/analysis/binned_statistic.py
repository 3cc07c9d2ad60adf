"""Registered binned_statistic analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/binned_statistic.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def binned_statistic(self, *args, **kwargs):
    return self.mesh.binned_statistic(*args, **kwargs)
