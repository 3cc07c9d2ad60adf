"""Mesh classes: the FLASH AMR mesh, the uniform-grid mesh and the
tracer-particle table."""

from fava_tpu_torch.mesh.base import Mesh, Structured, Unstructured
from fava_tpu_torch.mesh.flash_amr import BLOCK_TYPE, FLASH
from fava_tpu_torch.mesh.flash_particles import FlashParticles
from fava_tpu_torch.mesh.flash_uniform import FlashUniform

__all__ = ["BLOCK_TYPE", "FLASH", "FlashParticles", "FlashUniform", "Mesh", "Structured", "Unstructured"]
