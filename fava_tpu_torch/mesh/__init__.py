"""Mesh classes: the FLASH AMR mesh and the uniform-grid mesh."""

from fava_tpu_torch.mesh.base import Mesh, Structured, Unstructured
from fava_tpu_torch.mesh.flash_amr import FLASH
from fava_tpu_torch.mesh.flash_uniform import FlashUniform

__all__ = ["FLASH", "FlashUniform", "Mesh", "Structured", "Unstructured"]
