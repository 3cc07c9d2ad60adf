"""Registered structure_functions and velocity_increment_pdfs analyses:
forward to the active mesh (counterpart of
fava_tpu/analysis/structure_functions.py)."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def structure_functions(self, *args, **kwargs):
    return self.mesh.structure_functions(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def velocity_increment_pdfs(self, *args, **kwargs):
    """Signed velocity-increment PDFs vs separation (beyond the reference;
    ops/structure.velocity_increment_pdfs)."""
    return self.mesh.velocity_increment_pdfs(*args, **kwargs)
