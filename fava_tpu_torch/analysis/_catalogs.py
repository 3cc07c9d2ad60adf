"""File-catalog resolution of the series analyses
(fava_tpu/analysis/_catalogs.py): one place maps a ``file_type`` to the
FLASH model's catalog, one resolver for the mesh series and one for the
particle series."""

from __future__ import annotations

from typing import Optional, Sequence


def _type_key(file_type) -> str:
    # FileType enum members or their lowercase string names.
    return str(getattr(file_type, "name", file_type)).lower()


def mesh_series_paths(self, file_type, file_indices: Optional[Sequence[int]] = None):
    """(sorted indices, paths) for a mesh-file series analysis."""
    catalogs = {"plt": self.plt_files, "chk": self.chk_files, "uni": self.uni_files}
    key = _type_key(file_type)
    try:
        catalog = catalogs[key]
    except KeyError:
        raise ValueError(
            f"unknown file_type {key!r} for a mesh-series analysis; "
            f"expected one of {sorted(catalogs)}"
        ) from None
    indices = sorted(catalog["by index"].keys()) if file_indices is None else list(file_indices)
    return indices, [catalog["by index"][i] for i in indices]


def particle_series_indices(self, file_type, file_indices: Optional[Sequence[int]] = None):
    """Sorted file indices a particle-series analysis will load.

    ``load(file_type='chk_prt', file_index=i)`` resolves ``i`` against
    the CHK catalog (checkpoints carry the particle table themselves);
    plain ``prt`` and the ``plt_prt`` combination read particles from
    part files.
    """
    catalog_names = {"prt": "prt_files", "chk_prt": "chk_files", "plt_prt": "prt_files"}
    key = _type_key(file_type)
    try:
        catalog = getattr(self, catalog_names[key])
    except KeyError:
        raise ValueError(
            f"unknown file_type {key!r} for a particle-series analysis; "
            f"expected one of {sorted(catalog_names)}"
        ) from None
    return sorted(catalog["by index"].keys()) if file_indices is None else list(file_indices)
