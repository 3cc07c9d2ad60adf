"""File-catalog resolution of the series analyses
(fava_tpu/analysis/_catalogs.py; the particle resolver waits for ROADMAP
A9): one place maps a ``file_type`` to the FLASH model's catalog."""

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
