"""Analyses registered onto the port's Model (importing registers them)."""

from fava_tpu_torch.analysis import flagship_analysis  # noqa: F401

__all__ = ["flagship_analysis"]
