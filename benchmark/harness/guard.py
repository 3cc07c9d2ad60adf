"""The modules a run may not load: JAX and the JAX package the port
comes from. Compared by whole top-level names (the part of a module's
name before the first dot): ``fava_tpu_torch`` is not ``fava_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "fava_tpu")


class ForbiddenModules(RuntimeError):
    pass


def forbidden_loaded(modules: Iterable[str] | None = None) -> List[str]:
    names = list(sys.modules) if modules is None else list(modules)
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
