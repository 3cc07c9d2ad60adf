"""FLASH mesh metadata: the part of fava_tpu/mesh/flash_amr.py
(:54-270) that FlashUniform inherits — scalars and runtime parameters,
the synced integer/real attributes, lazy field reads onto the device,
and the domain bounds. The AMR analyses wait for ROADMAP A4.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.io import flash_file
from fava_tpu_torch.io.flash_file import FIELD_MAPPING
from fava_tpu_torch.mesh.base import Structured
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.utils import field_dtype, numpy_dtype, resolve_device

logger = logging.getLogger(__name__)


class _SyncedInt:
    """Attribute kept in sync with the scalars/runtime-parameter dicts."""

    def __init__(self, key: Optional[str] = None, kind: str = "integer", aliases: tuple = ()):
        self.key = key
        self.kind = kind
        self.aliases = aliases

    def __set_name__(self, owner, name):
        self.name = name
        if self.key is None:
            self.key = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[f"_{self.name}"]
        except KeyError:
            raise AttributeError(
                f"{type(obj).__name__}.{self.name} is unset (load() the mesh first)"
            ) from None

    def __set__(self, obj, value):
        for d in (getattr(obj, "scalars", None), getattr(obj, "runtime_parameters", None)):
            if d is None:
                continue
            for key in (self.key, *self.aliases):
                if key in d.get(self.kind, {}):
                    d[self.kind][key] = value
        obj.__dict__[f"_{self.name}"] = value


@Model.register_mesh()
class FLASH(Structured):
    """FLASH (Paramesh) file mesh: metadata and device-resident fields."""

    nxb = _SyncedInt()
    nyb = _SyncedInt()
    nzb = _SyncedInt()
    nblockx = _SyncedInt()
    nblocky = _SyncedInt()
    nblockz = _SyncedInt()
    nblocks = _SyncedInt(key="globalnumblocks", aliases=("total blocks",))
    xmin = _SyncedInt(kind="real")
    xmax = _SyncedInt(kind="real")
    ymin = _SyncedInt(kind="real")
    ymax = _SyncedInt(kind="real")
    zmin = _SyncedInt(kind="real")
    zmax = _SyncedInt(kind="real")

    def __init__(self, filename: Optional[str | Path] = None, *args, device="cuda", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self._filename: Optional[Path] = None
        self._loaded = False
        self._data: Dict[str, torch.Tensor] = {}
        self.fields: List[str] = []
        self.filename = filename

    # ------------------------------------------------------------------
    @property
    def filename(self) -> Optional[Path]:
        return self._filename

    @filename.setter
    def filename(self, filename: Optional[str | Path]) -> None:
        if filename is None:
            return
        if not isinstance(filename, (str, Path)):
            logger.error("Filename must be a str or Path, not %s", type(filename))
            return
        self._filename = Path(filename)

    # ------------------------------------------------------------------
    # Loading
    def load(self) -> None:
        """Read scalars, runtime parameters, and block metadata (not UNK data)."""
        import h5py

        if self._filename is None or not self._filename.is_file():
            raise FileNotFoundError(f"FLASH file does not exist: {self._filename}")

        self._data = {}
        with h5py.File(self._filename, "r") as f:
            self.scalars = flash_file.read_scalars(f)
            self.runtime_parameters = flash_file.read_runtime_parameters(f)
            self._set_integers()
            self._set_reals()
            self.fields = flash_file.read_unknown_names(f)
            meta = flash_file.read_block_metadata(f)
        self.coordinates = meta.get("coordinates")
        self.block_size = meta.get("block size")
        self.block_bounds = meta.get("bounding box")
        self.node_type = meta.get("node type", np.ones(self.nblocks, dtype=np.int64))
        self.refine_level = meta.get("refine level")
        self.gid = meta.get("gid")
        self.which_child = meta.get("which child")
        self.processors = meta.get("processor number")
        self.bflags = meta.get("bflags")
        self._loaded = True

    def _set_integers(self) -> None:
        ints = self.scalars["integer"]
        rints = self.runtime_parameters["integer"]
        self.ndim = int(ints.get("dimensionality"))
        self.nxb = int(ints.get("nxb"))
        self.nyb = int(ints.get("nyb"))
        self.nzb = int(ints.get("nzb"))
        self.iprocs = int(ints.get("iprocs", 1))
        self.jprocs = int(ints.get("jprocs", 1))
        self.kprocs = int(ints.get("kprocs", 1))
        self.nblockx = int(rints.get("nblockx", 1))
        self.nblocky = int(rints.get("nblocky", 1))
        self.nblockz = int(rints.get("nblockz", 1))
        self.nblocks = int(ints.get("total blocks", ints.get("globalnumblocks", 1)))

    def _set_reals(self) -> None:
        reals = self.runtime_parameters["real"]
        self.time = float(self.scalars["real"].get("time", 0.0))
        self.xmin = float(reals.get("xmin", 0.0))
        self.xmax = float(reals.get("xmax", 1.0))
        self.ymin = float(reals.get("ymin", 0.0))
        self.ymax = float(reals.get("ymax", 1.0))
        self.zmin = float(reals.get("zmin", 0.0))
        self.zmax = float(reals.get("zmax", 1.0))

    def load_data(self, names: Optional[Sequence[str]] = None) -> None:
        import h5py

        fields = list(names) if names is not None else list(self.fields)
        with h5py.File(self._filename, "r") as f:
            for field in fields:
                self._read_field(f, field)

    def _read_field(self, handle, name: str) -> None:
        dtype = field_dtype(self.device)
        host = flash_file.read_field(handle, name, dtype=numpy_dtype(dtype))
        self._data[name] = torch.from_numpy(host).to(self.device)

    def data(self, name: str) -> Optional[torch.Tensor]:
        """Lazy device-resident access to a UNK field (long names mapped)."""
        field = name
        if field not in self.fields:
            field = FIELD_MAPPING.get(name)
        if field is None or field not in self.fields:
            logger.warning("Cannot find %s in dataset", name)
            return None
        if field not in self._data:
            import h5py

            with h5py.File(self._filename, "r") as f:
                self._read_field(f, field)
        return self._data[field]

    @property
    def domain_bounds(self) -> np.ndarray:
        return np.array(
            [[self.xmin, self.xmax], [self.ymin, self.ymax], [self.zmin, self.zmax]],
            dtype=np.float64,
        )
