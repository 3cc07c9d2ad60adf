"""FLASH HDF5 readers and writers, and synthetic FLASH files (``io.synthetic``)."""

from fava_tpu_torch.io import flash_file

__all__ = ["flash_file"]
