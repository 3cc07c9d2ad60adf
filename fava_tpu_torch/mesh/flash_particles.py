"""FLASH tracer-particle mesh.

Counterpart of fava_tpu/mesh/flash_particles.py: reads the ``tracer
particles`` table with field selection (long aliases accepted), sorts it
by tag, and keeps the columns as host numpy arrays, which the particle
analyses index on the host. ``device_column`` puts a column on the
mesh's device as float64, and ``statistics`` reduces the columns there
in float64 with one fetch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.io import flash_file, h5lite
from fava_tpu_torch.mesh.base import Unstructured
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.utils import resolve_device

# Short particle-column names (as stored in the file) -> long aliases
# accepted in ``fields=`` selections: the mesh-field alias table plus the
# particle-only 'id' -> 'tag'.
_field_mapping = {"tag": "id", **{v: k for k, v in flash_file.FIELD_MAPPING.items()}}
_long_to_short = {v: k for k, v in _field_mapping.items()}


def rows_for_tags(table_tags: np.ndarray, requested: np.ndarray, *, label: str = "tag") -> np.ndarray:
    """Particle-table row indices of the requested tag values.

    Hard error on duplicate or missing tags: a clipped searchsorted
    would silently return an arbitrary particle's row. Shared by
    select_by_tags and the tag-tracking loops of the particle analyses.
    """
    table_tags = np.asarray(table_tags)
    requested = np.asarray(requested)
    order = np.argsort(table_tags, kind="stable")
    st = table_tags[order]
    if st.size > 1 and np.any(st[1:] == st[:-1]):
        raise ValueError(f"duplicate particle tags in field {label!r}")
    pos = np.clip(np.searchsorted(st, requested), 0, max(st.size - 1, 0))
    rows = order[pos] if st.size else np.zeros(0, dtype=np.int64)
    missing = st.size == 0 or np.any(table_tags[rows] != requested)
    if missing:
        bad = requested if st.size == 0 else requested[table_tags[rows] != requested]
        raise ValueError(f"particle tags {bad[:5]!r}... not found in {label!r}")
    return rows


def _is_particle_file(fn: Path) -> bool:
    return fn.match("*hdf5_part_*") or fn.match("*hdf5_chk_*")


@Model.register_mesh()
class FlashParticles(Unstructured):
    """The tracer particles of a FLASH part or checkpoint file, reduced on ``device``."""

    _filename: Optional[Path] = None

    def __init__(self, filename: Optional[str | Path] = None, *args, device="cuda", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self._fields: List[str] = []
        self._metadata_loaded = False
        self.data: Dict[str, np.ndarray] = {}
        self.filename = filename

    @classmethod
    def is_this_your_mesh(cls, filename: str | Path, *args, **kwargs) -> bool:
        return _is_particle_file(Path(str(filename)))

    @property
    def filename(self) -> Optional[Path]:
        return self._filename

    @filename.setter
    def filename(self, filename: Optional[str | Path]) -> None:
        if filename is None:
            return
        fn = Path(filename)
        if not _is_particle_file(fn):
            raise ValueError(
                f"FLASH particle files typically have 'hdf5_chk_' or 'hdf5_part_' in the filename: {fn}"
            )
        if fn != self._filename or not self._metadata_loaded:
            # Commit the new path only after its metadata loads: if
            # _load_metadata raises (a file mid-write), a retry with the
            # same path re-reads it instead of keeping the previous
            # file's field list, time and counts.
            self._metadata_loaded = False
            prev = self._filename
            self._filename = fn
            try:
                self._load_metadata()
            except Exception:
                self._filename = prev
                raise

    # ------------------------------------------------------------------
    def _load_metadata(self) -> None:
        with h5lite.File(self._filename, "r") as f:
            meta = flash_file.read_particle_metadata(f)
        self._intscalars = meta["integer scalars"]
        self._realscalars = meta["real scalars"]
        self.localnp = meta["localnp"]
        # chk files without the scalar still carry per-rank counts.
        self.nParticles = int(
            self._intscalars.get("globalnumparticles", int(np.sum(self.localnp)))
        )
        self._fields = meta["particle names"]
        self.ndim = int(self._intscalars["dimensionality"])
        self.dt = float(self._realscalars.get("dt", 0.0))
        self.dtold = float(self._realscalars.get("dtold", 0.0))
        self.time = float(self._realscalars.get("time", 0.0))
        self._metadata_loaded = True

    @property
    def fields(self) -> List[str]:
        return list(self._fields)

    def load(self) -> None:
        self._load_particles()

    def _load_particles(
        self, fields: Optional[Sequence[str]] = None, ordered: bool = True, **kwargs
    ) -> None:
        fields = self._fields if fields is None else fields

        # Long aliases ("density", "velocity-x") resolve to the file's
        # short column names; names the file does not carry are skipped
        # with a warning.
        resolved = []
        for name in fields:
            short = name if name in self._fields else _long_to_short.get(name, name)
            if short not in self._fields:
                print(f"[WARNING] {name} particle field variable does not exist in dataset")
                continue
            resolved.append(short)

        with h5lite.File(self._filename, "r") as f:
            self.data = flash_file.read_particles(f, self._fields, select=resolved)

        if ordered and "tag" in self.data:
            tidx = np.argsort(self.data["tag"])
            for field in self.data:
                self.data[field] = self.data[field][tidx]

    def get_coords(self) -> np.ndarray:
        coords = np.empty((len(self.data["posx"]), self.ndim))
        coords[:, 0] = self.data["posx"]
        if self.ndim > 1:
            coords[:, 1] = self.data["posy"]
        if self.ndim > 2:
            coords[:, 2] = self.data["posz"]
        return coords

    # ------------------------------------------------------------------
    def device_column(self, field: str) -> torch.Tensor:
        """One column as a float64 tensor on the mesh's device."""
        return torch.as_tensor(np.asarray(self.data[field], dtype=np.float64), device=self.device)

    def statistics(self, fields: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
        """Per-field mean / RMS / min / max over all particles, in float64
        on the device (the columns stacked once, one fetch).

        Unknown fields are skipped with a warning."""
        fields = list(fields) if fields is not None else [f for f in self.data if f != "tag"]
        present = []
        for f in fields:
            if f not in self.data:
                print(f"[WARNING] {f} particle field variable does not exist in dataset")
                continue
            present.append(f)
        if not present:
            return {}
        cols = torch.stack([self.device_column(f) for f in present])
        mean = cols.mean(dim=1)
        rms = torch.sqrt(((cols - mean[:, None]) ** 2).mean(dim=1))
        vals = torch.stack([mean, rms, cols.amin(dim=1), cols.amax(dim=1)]).cpu().numpy()
        return {
            f: {
                "mean": float(vals[0, i]),
                "rms": float(vals[1, i]),
                "min": float(vals[2, i]),
                "max": float(vals[3, i]),
            }
            for i, f in enumerate(present)
        }

    def structure_functions(self, **kwargs) -> Dict[str, Any]:
        """Velocity structure functions from tracer pairs
        (``ops/structure.pair_structure_functions`` on the mesh's device).
        Keyword arguments pass through (num_pairs, nbins, sep_bounds,
        orders, lengths, log_bins, seed)."""
        from fava_tpu_torch.ops.structure import pair_structure_functions

        coords = self.get_coords()
        vels = np.stack([self.data[f"vel{a}"] for a in "xyz"[: self.ndim]], axis=-1)
        return pair_structure_functions(coords, vels, device=self.device, **kwargs)

    def select_by_tags(self, tags: np.ndarray) -> Dict[str, np.ndarray]:
        """Rows whose tag matches each requested tag; raises on tags absent
        from the file (e.g. a particle that left the domain)."""
        idx = rows_for_tags(self.data["tag"], tags, label=f"tag ({self._filename})")
        return {f: v[idx] for f, v in self.data.items()}
