"""Registered fractal_dimension analysis: forwards to the active mesh
(counterpart of fava_tpu/analysis/fractal_dimension.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def fractal_dimension(self, *args, **kwargs):
    return self.mesh.fractal_dimension(*args, **kwargs)
