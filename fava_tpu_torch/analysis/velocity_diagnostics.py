"""Registered velocity diagnostics and gradient statistics: forward to
the active mesh (counterpart of fava_tpu/analysis/velocity_diagnostics.py,
ops/velocity.py and ops/gradients.py)."""

from fava_tpu_torch.models.model import Model


def _uniform_mesh_method(mesh, name: str):
    """The uniform mesh's method ``name``; AMR meshes have none, and fail
    with a route forward instead of a bare AttributeError (jax-free copy
    of fava_tpu/analysis/two_point.py's helper)."""
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
def helmholtz_decomposition(self, *args, **kwargs):
    return self.mesh.helmholtz_decomposition(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def vorticity(self, *args, **kwargs):
    return self.mesh.vorticity(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def dilatation(self, *args, **kwargs):
    return self.mesh.dilatation(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def enstrophy_spectra(self, *args, **kwargs):
    return self.mesh.enstrophy_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def helicity_spectra(self, *args, **kwargs):
    return self.mesh.helicity_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def transfer_spectra(self, *args, **kwargs):
    return self.mesh.transfer_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def decomposed_kinetic_energy_spectra(self, *args, **kwargs):
    return self.mesh.decomposed_kinetic_energy_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def anisotropic_kinetic_energy_spectra(self, *args, **kwargs):
    return self.mesh.anisotropic_kinetic_energy_spectra(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def turbulence_summary(self, *args, **kwargs):
    return self.mesh.turbulence_summary(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def velocity_gradient_statistics(self, *args, **kwargs):
    return _uniform_mesh_method(self.mesh, "velocity_gradient_statistics")(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def gradient_invariant_pdfs(self, *args, **kwargs):
    return _uniform_mesh_method(self.mesh, "gradient_invariant_pdfs")(*args, **kwargs)
