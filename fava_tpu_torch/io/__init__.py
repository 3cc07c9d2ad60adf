"""FLASH HDF5 readers."""

from fava_tpu_torch.io import flash_file

__all__ = ["flash_file"]
