"""Model base class: the port's own mesh and analysis registries.

Counterpart of fava_tpu/models/model.py. The port keeps registries of
its own on purpose (not fava_tpu's): ``register_analysis`` skips names the class
already has, so a shared Model would keep whichever package registered
first. The HDF5 result writers (``save_to_hdf5`` and its helpers) go
through the port's own codec, ``io/h5lite.py``. ``load`` sniffs a file
with every registered mesh and loads it on the model's device; FLASH's
typed ``load`` is the usual entry point.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from fava_tpu_torch.io import h5lite
from fava_tpu_torch.utils import NotCallableError, resolve_device, timer
from fava_tpu_torch.utils._exceptions import InvalidMeshError


class Model:
    """A directory of simulation output plus registered meshes/analyses,
    computing on ``device``."""

    _meshes: Dict[str, Any] = {}

    def __init__(self, directory: str | Path, name: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.directory = Path(directory)
        self.name = name

    # ------------------------------------------------------------------
    # Directory / file catalog
    @property
    def directory(self) -> Path:
        return self._directory

    @directory.setter
    def directory(self, directory: str | Path) -> None:
        self._directory = Path(directory)
        if not self._directory.is_dir():
            raise FileNotFoundError(f"Cannot find model directory: {self._directory}")
        self.files = sorted(fn for fn in self._directory.glob("*") if fn.is_file())
        if len(self.files) == 0:
            raise FileNotFoundError(f"The model directory is empty: {self._directory}")
        self._directory_changed()

    def _directory_changed(self) -> None:
        """Called after ``self.files`` is re-globbed; subclasses rebuild
        directory-derived state here."""

    @property
    def name(self) -> str:
        return self._name

    @name.setter
    def name(self, name: Optional[str]) -> None:
        self._name = self._directory.name if name is None else name

    def _filter_files(self, pattern: str) -> List[Path]:
        return [file for file in self.files if file.match(pattern)]

    def nfiles(self) -> int:
        return len(self.files)

    # ------------------------------------------------------------------
    # Mesh registry
    @classmethod
    def register_mesh(cls):
        def decorator(mesh_cls):
            cls._meshes[mesh_cls.__name__] = mesh_cls
            return mesh_cls

        return decorator

    @classmethod
    def mesh_names(cls) -> list:
        return sorted(cls._meshes)

    @classmethod
    def get_mesh_class(cls, name: str):
        mesh_cls = cls._meshes.get(name)
        if mesh_cls is None:
            raise InvalidMeshError(name)
        return mesh_cls

    def _load_mesh(self, filename: str | Path, fields: Optional[List[str]] = None) -> None:
        """Sniff the file with every registered mesh class and load it."""
        filename = str(filename)
        for mesh_cls in self._meshes.values():
            if mesh_cls.is_this_your_mesh(filename):
                self.mesh = None  # the old mesh's device fields go before the new ones come
                self.mesh = mesh_cls(filename, device=self.device)
                self.mesh.load()
                if fields:
                    self.mesh.load_data(names=fields)
                return
        raise InvalidMeshError(filename)

    def load(self, filenumber: int = 0) -> None:
        """Load the ``filenumber``-th file of the sorted directory listing
        with the mesh class that recognises it."""
        if len(self.files) <= filenumber:
            raise IndexError(
                f"Filenumber {filenumber} is out of bounds for filelist of length {len(self.files)}"
            )
        self._load_mesh(self.files[filenumber])

    # ------------------------------------------------------------------
    # Analysis registry
    @classmethod
    def register_analysis(cls, overwrite: bool = False, use_timer: Optional[bool] = None):
        def decorator(analysis_func):
            if not callable(analysis_func):
                raise NotCallableError(analysis_func)
            name = analysis_func.__name__
            if not hasattr(cls, name) or overwrite:
                setattr(cls, name, timer(analysis_func) if use_timer else analysis_func)
            return analysis_func

        return decorator

    # ------------------------------------------------------------------
    # HDF5 result output
    def save_to_hdf5(self, data: dict, filename: Path | str) -> None:
        """Write a nested dict of results as HDF5 groups/datasets
        (appending: an existing file keeps its other keys)."""
        _filename = Path(filename)
        mode = "a" if _filename.is_file() else "w"
        with h5lite.File(_filename, mode) as f:
            self.write_to_hdf5(f, data)

    def write_to_hdf5(self, handle, data: dict) -> None:
        """Write ``data`` under ``handle``: a dict becomes a group (merged
        into an existing one), anything else a dataset replacing any
        object of that name; unicode strings are stored as bytes."""
        for key, values in data.items():
            if isinstance(values, dict):
                if key in handle and not isinstance(handle[key], h5lite.WritableGroup):
                    del handle[key]
                group = handle[key] if key in handle else handle.create_group(key)
                self.write_to_hdf5(group, values)
            else:
                if key in handle:
                    del handle[key]
                arr = np.asarray(values)
                if arr.dtype.kind == "U":
                    arr = arr.astype("S")
                handle.create_dataset(key, data=arr)

    def hdf5_key_exists(self, key: str, filename: str | Path) -> bool:
        """Whether ``key`` (a name or a "group/name" path) is in the file."""
        _filename = Path(filename)
        if not _filename.is_file():
            return False
        with h5lite.File(_filename, "r") as f:
            return key in f
