"""Registered favre_profiles analysis: Favre (density-weighted) means and
mass-weighted RMS fluctuations (counterpart of
fava_tpu/analysis/favre_profiles.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def favre_profiles(self, *args, **kwargs):
    return self.mesh.favre_profiles(*args, **kwargs)
