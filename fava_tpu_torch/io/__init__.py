"""FLASH HDF5 readers and writers, and synthetic FLASH files (``io.synthetic``)."""

from fava_tpu_torch.io import flash_file, synthetic
from fava_tpu_torch.io.flash_file import FIELD_MAPPING, MESH_MDIM, NGUARD

__all__ = ["flash_file", "synthetic", "FIELD_MAPPING", "MESH_MDIM", "NGUARD"]
