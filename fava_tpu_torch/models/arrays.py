"""In-memory model handle: run the registered analyses on plain arrays.

Counterpart of fava_tpu/models/arrays.py: ``from_arrays({"dens": rho,
"velx": vx, ...}, device=...)`` returns a Model carrying an in-memory
FlashUniform mesh on ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from fava_tpu_torch.models.model import Model


class InMemoryModel(Model):
    """Model wrapper around an in-memory mesh (no directory catalog)."""

    def __init__(self, mesh, name: str = "in-memory"):
        # deliberately skip Model.__init__ (it validates a directory)
        self._directory = Path(".")
        self.files = []
        self._name = name
        self.mesh = mesh

    def load(self, *args, **kwargs):
        raise NotImplementedError(
            "InMemoryModel has no file catalog; construct it via fava_tpu_torch.from_arrays"
        )


def from_arrays(
    fields: Dict[str, np.ndarray],
    domain_bounds: Optional[np.ndarray] = None,
    time: float = 0.0,
    name: str = "in-memory",
    device="cuda",
) -> InMemoryModel:
    """Model handle over plain arrays or tensors, copied to ``device``."""
    from fava_tpu_torch.mesh.flash_uniform import FlashUniform

    return InMemoryModel(
        FlashUniform.from_arrays(fields, domain_bounds=domain_bounds, time=time, device=device),
        name=name,
    )
