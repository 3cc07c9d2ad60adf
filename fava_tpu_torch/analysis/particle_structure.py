"""Registered particle-pair structure-function analysis
(fava_tpu/analysis/particle_structure.py): forwards to the loaded
particle table, which computes on its device."""

from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def particle_structure_functions(self, *args, **kwargs):
    if getattr(self, "particles", None) is None:
        raise AttributeError(
            "particle_structure_functions needs a loaded particle table: "
            "model.load(file_type='prt') first"
        )
    return self.particles.structure_functions(*args, **kwargs)
