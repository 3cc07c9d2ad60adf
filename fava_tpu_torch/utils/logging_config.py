"""Logging configuration (copy of fava_tpu/utils/logging_config.py).

``configure()`` wires a default handler onto the package's root logger,
``fava_tpu_torch``; the pipeline CLI calls it on startup.
"""

from __future__ import annotations

import logging
import sys


def configure(level: int = logging.INFO, stream=None) -> None:
    root = logging.getLogger("fava_tpu_torch")
    if root.handlers:
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(asctime)s] %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    )
    root.addHandler(handler)
    root.setLevel(level)
