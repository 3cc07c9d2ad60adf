"""Model frontends: the registry base, FLASH directories, in-memory arrays."""

from fava_tpu_torch.models.model import Model
from fava_tpu_torch.models.flash import FLASH, FileSubStem, FileType
from fava_tpu_torch.models.arrays import InMemoryModel, from_arrays

__all__ = ["FLASH", "FileSubStem", "FileType", "InMemoryModel", "Model", "from_arrays"]
