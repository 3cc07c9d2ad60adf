"""Registered spatial two-point correlation analyses: forward to the
active mesh (counterpart of fava_tpu/analysis/two_point.py; the analyses
are ops/twopoint.py and, streamed, ops/outofcore.py)."""

from fava_tpu_torch.models.model import Model


def _uniform_mesh_method(mesh, name: str):
    """The uniform mesh's method ``name``; AMR meshes have none, and fail
    with a route forward instead of a bare AttributeError."""
    if mesh is None:
        raise AttributeError(f"{name} needs a loaded dataset — call model.load(...) first")
    method = getattr(mesh, name, None)
    if method is None:
        raise AttributeError(
            f"{name} needs a uniform-grid dataset ({type(mesh).__name__} has no "
            f"{name}); regrid AMR data first via mesh.from_amr(...) and load the "
            "resulting uniform file"
        )
    return method


@Model.register_analysis(use_timer=True)
def two_point_correlation(self, *args, **kwargs):
    return _uniform_mesh_method(self.mesh, "two_point_correlation")(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def velocity_correlations(self, *args, **kwargs):
    return _uniform_mesh_method(self.mesh, "velocity_correlations")(*args, **kwargs)
