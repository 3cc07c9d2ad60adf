"""Mesh base classes (counterpart of fava_tpu/mesh/base.py)."""

from __future__ import annotations

from abc import ABC

from fava_tpu_torch.models.model import Model


class Mesh(ABC):
    """Base class for grid meshes; subclasses sniff files via is_this_your_mesh."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)

    @classmethod
    def is_this_your_mesh(cls, *args, **kwargs) -> bool:
        return False

    @property
    def mesh_type(self) -> str:
        return self.__class__.__name__


@Model.register_mesh()
class Structured(Mesh):
    """Base implementation for structured meshes."""


@Model.register_mesh()
class Unstructured(Mesh):
    """Base implementation for unstructured meshes."""
