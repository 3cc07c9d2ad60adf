"""Geometry enumerations."""

from fava_tpu_torch.geometry._enums import (
    AXIS,
    CARTESIAN,
    CYLINDRICAL,
    EDGE,
    GEOMETRY,
    POLAR,
    SPHERICAL,
)

__all__ = ["AXIS", "CARTESIAN", "CYLINDRICAL", "EDGE", "GEOMETRY", "POLAR", "SPHERICAL"]
