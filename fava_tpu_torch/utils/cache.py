"""Persistent kernel-build cache helper.

Counterpart of fava_tpu/utils/cache.py. The port's compiled programs are
its hand-written CUDA kernels: ``ops/_build.py`` compiles them at first
use into one library keyed by a hash of the sources, headers and flags,
and every later process with the same sources loads it. A fresh checkout
builds into its own ``fava_tpu_torch/_build/``; pointing several
checkouts, or a script's subprocesses, at one directory lets them share
one build. Call :func:`enable_compilation_cache` once per process, before
the first kernel (the pipeline CLI does this).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def enable_compilation_cache(path: Optional[str | Path] = None) -> Path:
    """Build the kernels into, and load them from, ``path``.

    Resolution order: explicit ``path`` argument, then the
    ``FAVA_TPU_TORCH_CACHE_DIR`` environment variable (so a script can
    hand one warm cache to ``python -m fava_tpu_torch`` subprocesses),
    then ``fava_tpu_torch/_build/``. Creates the directory and returns it.
    Raises RuntimeError once this process has loaded the kernel library
    from another directory.
    """
    from fava_tpu_torch.ops import _build

    if path is None:
        path = os.environ.get("FAVA_TPU_TORCH_CACHE_DIR") or None
    cache_dir = Path(path) if path is not None else _build.DEFAULT_BUILD_DIR
    cache_dir.mkdir(parents=True, exist_ok=True)
    _build.set_build_dir(cache_dir)
    return cache_dir
