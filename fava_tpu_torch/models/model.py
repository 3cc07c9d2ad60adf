"""Model base class: the port's own mesh and analysis registries.

Counterpart of fava_tpu/models/model.py. The registries are separate
from fava_tpu's on purpose: ``register_analysis`` skips names the class
already has, so a shared Model would keep whichever package registered
first. The HDF5 result writers and the generic sniffing ``load`` are
not part of this slice (ROADMAP A3).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from fava_tpu_torch.utils import NotCallableError, timer
from fava_tpu_torch.utils._exceptions import InvalidMeshError


class Model:
    """A directory of simulation output plus registered meshes/analyses."""

    _meshes: Dict[str, Any] = {}

    def __init__(self, directory: str | Path, name: Optional[str] = None):
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
