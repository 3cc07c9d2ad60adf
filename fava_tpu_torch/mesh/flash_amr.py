"""FLASH AMR mesh: reader, geometry queries, and device-resident analyses.

Counterpart of fava_tpu/mesh/flash_amr.py. Field data lives as tensors
of shape (nblocks, nxb, nyb, nzb) on ``device`` (float32 on CUDA,
float64 on the CPU); block bookkeeping stays as small host numpy arrays;
the profile analyses and the regrid dispatch to ``fava_tpu_torch.ops``,
as do the volume sums, PDFs and conditional statistics over the leaf
cells, the line-of-sight projection (``ops/projection.py``) and the
flame-window fit (``ops/flame.py``).

Under an active device mesh (``parallel/``) the profiles split the leaf
blocks over every rank (``ops/profiles.py``), and ``from_amr`` shards
its output along x over the space axis when the output's nx and ny
divide it (the placement rule, ``parallel.runtime.shards_volume``):
each rank regrids its x-slab from only the source blocks that slab
reads (``ops/regrid.regrid_fields_sharded``), and the collapsed mesh
holds that slab (``_dmesh``). On a sharded mesh the profiles
(``reynolds_stress``, ``favre_profiles``, the slice profiles along
every axis) and the volume sums (``volume_integration``,
``volume_average``, ``mass_sum``) are rank-local (ROADMAP A11d): they
read the rank's slab (``_local_stack``) and join by collectives of row
statistics or packed sums (``ops/profiles.py``, ``ops/volume.py``). So
are the PDFs and ``binned_statistic`` (B8 on the slab; A11f.2), the
projection (the collapsed mesh's one block through
``ops/projection.project_uniform`` with ``mesh=``) and the point
sampling (``sample_fields``, ``get_point_data``: each rank takes the
points its rows hold, one SUM). Only ``data()`` answers with the volume
gathered over the space group, and ``save`` writes the gathered volume
from rank 0 alone. A uniform mesh runs its further rank-local analyses
on the slab (``mesh/flash_uniform.py``).
"""

from __future__ import annotations

import logging
from enum import Enum
from functools import cached_property
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fava_tpu_torch.geometry import AXIS, EDGE, GEOMETRY
from fava_tpu_torch.io import flash_file, h5lite
from fava_tpu_torch.io.flash_file import FIELD_MAPPING, NGUARD
from fava_tpu_torch.mesh.base import Structured
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.ops import flame as flame_ops
from fava_tpu_torch.ops import profiles as profile_ops
from fava_tpu_torch.ops import projection as projection_ops
from fava_tpu_torch.ops import regrid as regrid_ops
from fava_tpu_torch.ops import volume as volume_ops
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import field_dtype, resolve_device, timer

logger = logging.getLogger(__name__)


class BLOCK_TYPE(Enum):
    LEAF = 1
    PARENT = 2
    ANCESTOR = 3
    IBDRY = 200
    JBDRY = 201
    KBDRY = 202
    ANY_BDRY = 203
    ACTIVE = 204
    ALL = 205
    TRAVERSED = 254
    REFINEMENT = 321
    TRAVERSED_AND_ACTIVE = 278


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
    """FLASH AMR (Paramesh) plt/chk file mesh on ``device``."""

    nxb = _SyncedInt()
    nyb = _SyncedInt()
    nzb = _SyncedInt()
    nblockx = _SyncedInt()
    nblocky = _SyncedInt()
    nblockz = _SyncedInt()
    # Both spellings appear in FLASH files; from_amr's collapse to one
    # block must reach whichever the source carried, or save() writes a
    # stale block count next to 1-entry block metadata.
    nblocks = _SyncedInt(key="globalnumblocks", aliases=("total blocks",))
    xmin = _SyncedInt(kind="real")
    xmax = _SyncedInt(kind="real")
    ymin = _SyncedInt(kind="real")
    ymax = _SyncedInt(kind="real")
    zmin = _SyncedInt(kind="real")
    zmax = _SyncedInt(kind="real")

    # The mesh whose space axis the field volumes are slab-sharded over
    # (each rank holds its x-slab), or None.
    _dmesh = None

    def __init__(self, filename: Optional[str | Path] = None, *args, device="cuda", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self._filename: Optional[Path] = None
        self._chk_file = False
        self._loaded = False
        self._data: Dict[str, torch.Tensor] = {}
        self.fields: List[str] = []
        self.filename = filename

    @classmethod
    def is_this_your_mesh(cls, filename: str | Path, *args, **kwargs) -> bool:
        return any(fn in str(filename) for fn in ("hdf5_chk_", "hdf5_plt_cnt_"))

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
        fn = Path(filename)
        if fn == self._filename:
            return
        self._filename = fn
        # The checkpoint file-type marker, not a bare substring, and reset
        # when the mesh moves from a chk file to a plt file: _chk_file
        # picks the float64 (chk) or float32 write format.
        self._chk_file = "hdf5_chk_" in fn.name

    # ------------------------------------------------------------------
    # Loading
    def load(self) -> None:
        """Read scalars, runtime parameters, and block metadata (not UNK data)."""
        if self._filename is None or not self._filename.is_file():
            raise FileNotFoundError(f"FLASH file does not exist: {self._filename}")

        self._data = {}
        self._dmesh = None
        self._delete_cached_properties()
        with h5lite.File(self._filename, "r") as f:
            self.scalars = flash_file.read_scalars(f)
            self.runtime_parameters = flash_file.read_runtime_parameters(f)
            self._set_integers()
            self._set_reals()
            self.fields = flash_file.read_unknown_names(f)
            meta = flash_file.read_block_metadata(f)
        self.coordinates = meta.get("coordinates")
        self.block_size = meta.get("block size")
        self.block_bounds = meta.get("bounding box")
        # Uniform files may carry no node types: one leaf.
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
        fields = list(names) if names is not None else list(self.fields)
        with h5lite.File(self._filename, "r") as f:
            for field in fields:
                self._read_field(f, field)

    def _read_field(self, handle, name: str) -> None:
        self._data[name] = flash_file.read_field(handle, name, self.device, field_dtype(self.device))

    def _field_name(self, name: str) -> Optional[str]:
        """The UNK name of a field (long names mapped), None if absent."""
        field = name if name in self.fields else FIELD_MAPPING.get(name)
        return field if field is not None and field in self.fields else None

    def _local_data(self, name: str) -> Optional[torch.Tensor]:
        """A UNK field as this rank holds it: its x-slab when the volume
        is sharded, else the whole field (read on first use)."""
        field = self._field_name(name)
        if field is None:
            logger.warning("Cannot find %s in dataset", name)
            return None
        if field not in self._data:
            with h5lite.File(self._filename, "r") as f:
                self._read_field(f, field)
        return self._data[field]

    def data(self, name: str) -> Optional[torch.Tensor]:
        """Lazy device-resident access to a UNK field (long names
        mapped): under a sharding mesh, the ranks' x-slabs gathered (one
        all_gather on the space group)."""
        d = self._local_data(name)
        if d is None or self._dmesh is None:
            return d
        return runtime.gather_slabs(d, self._dmesh)

    def _slab(self, name: str) -> torch.Tensor:
        """This rank's x-slab of a field of a sharded volume."""
        d = self._local_data(name)
        if d is None:
            raise KeyError(name)
        return d

    def host_data(self, name: str) -> Optional[np.ndarray]:
        d = self.data(name)
        return None if d is None else d.cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------------
    # Cached / derived geometry
    def _delete_cached_properties(self) -> None:
        for key in ("geometry", "domain_volume", "cell_volume_min", "cell_volume_max",
                    "refine_level_max"):
            self.__dict__.pop(key, None)

    @cached_property
    def geometry(self) -> GEOMETRY:
        return GEOMETRY(self.scalars["string"].get("geometry", "cartesian").lower())

    @cached_property
    def refine_level_max(self) -> int:
        return int(np.asarray(self.refine_level).max())

    @cached_property
    def domain_volume(self) -> float:
        if self.geometry != GEOMETRY.CARTESIAN:
            raise NotImplementedError(f"Domain volume not implemented for {self.geometry}")
        return float(np.prod(np.diff(self.domain_bounds)))

    @cached_property
    def cell_volume_max(self) -> float:
        return self.get_cell_volume_from_refinement()

    @cached_property
    def cell_volume_min(self) -> float:
        return self.get_cell_volume_from_refinement(self.refine_level_max)

    @property
    def domain_bounds(self) -> np.ndarray:
        return np.array(
            [[self.xmin, self.xmax], [self.ymin, self.ymax], [self.zmin, self.zmax]],
            dtype=np.float64,
        )

    @property
    def ncells(self) -> int:
        return self.nxb * self.nyb * self.nzb

    @property
    def nCellsVec(self) -> np.ndarray:
        return np.array([self.nxb, self.nyb, self.nzb], dtype=np.int64)

    @property
    def nBlksVec(self) -> np.ndarray:
        return np.array([self.nblockx, self.nblocky, self.nblockz], dtype=np.int64)

    @property
    def blk_beg(self) -> int:
        """First locally-owned block: this process owns every block."""
        return 0

    @property
    def blk_end(self) -> int:
        """One past the last locally-owned block."""
        return int(self.nblocks)

    # ------------------------------------------------------------------
    # Block queries
    def get_blocklist(self, block_type: str | BLOCK_TYPE = "LEAF") -> np.ndarray:
        btype = block_type if isinstance(block_type, BLOCK_TYPE) else BLOCK_TYPE[block_type]
        if btype == BLOCK_TYPE.LEAF:
            return np.nonzero(np.asarray(self.node_type) == BLOCK_TYPE.LEAF.value)[0].astype(np.int64)
        if btype == BLOCK_TYPE.ALL:
            return np.arange(self.nblocks, dtype=np.int64)
        raise ValueError(f"Do not recognize BLOCK TYPE {btype}")

    def get_cell_volumes(self, block_type: str = "LEAF") -> np.ndarray:
        blocklist = self.get_blocklist(block_type)
        levels = np.asarray(self.refine_level)[blocklist]
        return self._cell_volumes_for_levels(levels)

    def _cell_volumes_for_levels(self, levels: np.ndarray) -> np.ndarray:
        cells = np.ones_like(levels, dtype=np.float64)
        nb = [self.nblockx, self.nblocky, self.nblockz]
        nc = [self.nxb, self.nyb, self.nzb]
        for a in range(self.ndim):
            cells *= nc[a] * nb[a] * 2.0 ** (levels - 1)
        return self.domain_volume / cells

    def get_cell_volume_from_refinement(self, refine_level: int = 1) -> float:
        return float(self._cell_volumes_for_levels(np.asarray([refine_level]))[0])

    def get_minimum_deltas(self, axis: int) -> float:
        return float(
            (self.domain_bounds[axis, 1] - self.domain_bounds[axis, 0])
            / (self.nCellsVec[axis] * self.nBlksVec[axis] * 2 ** (self.refine_level_max - 1))
        )

    def get_maximum_deltas(self, axis: int) -> float:
        lmin = int(np.asarray(self.refine_level).min())
        return float(
            (self.domain_bounds[axis, 1] - self.domain_bounds[axis, 0])
            / (self.nCellsVec[axis] * self.nBlksVec[axis] * 2 ** (lmin - 1))
        )

    def get_delta_from_refine_level(self, axis: int, refine_level) -> Any:
        return (self.domain_bounds[axis, 1] - self.domain_bounds[axis, 0]) / (
            self.nCellsVec[axis] * self.nBlksVec[axis] * 2.0 ** (np.asarray(refine_level) - 1)
        )

    def get_deltas_from_refine_level(self, refine_level: int) -> List[float]:
        return [float(self.get_delta_from_refine_level(a, refine_level)) for a in range(self.ndim)]

    def get_block_delta(self, axis: int, blockID: int) -> float:
        return float(
            (self.block_bounds[blockID, axis, 1] - self.block_bounds[blockID, axis, 0])
            / self.nCellsVec[axis]
        )

    def get_block_deltas(self, blockID: int) -> List[float]:
        return [self.get_block_delta(a, blockID) for a in range(self.ndim)]

    # ------------------------------------------------------------------
    # Point / coordinate queries
    def get_cell_coords(
        self, axis: int, blockID: int = 0, edge: str = "CENTER", guardcell: bool = False
    ) -> np.ndarray:
        """Cell coordinates of a block along ``axis`` (cell width (ub-lb)/n)."""
        n = int(self.nCellsVec[axis])
        lb, ub = self.block_bounds[blockID, axis, :]
        dx = (ub - lb) / float(n)
        m = n
        if guardcell:
            lb = lb - NGUARD * dx
            m += NGUARD
        match EDGE[edge]:
            case EDGE.CENTER:
                return lb + (np.arange(m) + 0.5) * dx
            case EDGE.LEFT:
                return lb + np.arange(m) * dx
            case EDGE.RIGHT:
                return lb + (np.arange(m) + 1.0) * dx

    def is_point_in_block(self, point, blockID: int) -> bool:
        box = self.block_bounds[blockID]
        ok = box[0, 0] <= point[0] < box[0, 1]
        if self.ndim > 1:
            ok = ok and (box[1, 0] <= point[1] < box[1, 1])
        if self.ndim > 2:
            ok = ok and (box[2, 0] <= point[2] < box[2, 1])
        return bool(ok)

    def points_within_block(self, points, axis: int, blockID: int, return_indices: bool = False):
        box = self.block_bounds[blockID, axis, :]
        pts = np.asarray(points)
        cond = (pts >= box[0]) & (pts <= box[1])
        if return_indices:
            return pts[cond], np.nonzero(cond)[0]
        return pts[cond]

    def locate_points(self, points: np.ndarray, block_list: Optional[np.ndarray] = None):
        """Vectorized point -> (block, cell index, found) lookup over the
        candidate blocks (leaves by default). Blocks are half-open, but
        inclusive on the domain's max face."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))  # (P, ndim)
        blocks = self.get_blocklist("LEAF") if block_list is None else np.asarray(block_list)
        bounds = np.asarray(self.block_bounds)[blocks]  # (B, 3, 2)

        inside = np.ones((pts.shape[0], blocks.size), dtype=bool)
        dom_hi = np.asarray(self.domain_bounds, dtype=np.float64)[:, 1]
        for a in range(self.ndim):
            hi_b = bounds[None, :, a, 1]
            upper = np.where(hi_b == dom_hi[a], pts[:, a, None] <= hi_b, pts[:, a, None] < hi_b)
            inside &= (bounds[None, :, a, 0] <= pts[:, a, None]) & upper
        hit = inside.argmax(axis=1)
        found = inside.any(axis=1)

        blk = blocks[hit]
        cells = np.zeros((pts.shape[0], self.ndim), dtype=np.int64)
        nvec = self.nCellsVec
        for a in range(self.ndim):
            lo = np.asarray(self.block_bounds)[blk, a, 0]
            hi = np.asarray(self.block_bounds)[blk, a, 1]
            dx = (hi - lo) / nvec[a]
            cells[:, a] = np.clip(((pts[:, a] - lo) / dx).astype(np.int64), 0, nvec[a] - 1)
        return blk, cells, found

    def get_coord_index(self, point, block_list) -> Tuple[List[int], int]:
        blk, cells, found = self.locate_points(np.asarray(point)[None, :], block_list)
        if not bool(found[0]):
            raise ValueError(f"point {np.asarray(point)!r} is not inside any listed block")
        idx = [int(c) for c in cells[0][: self.ndim]]
        return idx, int(blk[0])

    def get_point_data(self, blockID: int, point: List[int], field: str) -> float:
        cells = np.asarray(point[: self.ndim], dtype=np.int64)[None]
        return float(self._sample_cells(np.array([blockID]), cells, [field])[0, 0])

    def sample_fields(self, points: np.ndarray, fields: Sequence[str], block_list=None):
        """Vectorized point sampling: {field: values}, per-point volume
        fraction and found flags. The gather runs on the device
        (``torch.take``) and only the sampled values come to the host;
        under a sharding mesh each rank samples its own points from its
        x-slab (``_sample_cells``)."""
        blk, cells, found = self.locate_points(points, block_list)
        levels = np.asarray(self.refine_level)[blk]
        vol_frac = self._cell_volumes_for_levels(levels) / self.cell_volume_min
        values = self._sample_cells(blk, cells, fields)
        return dict(zip(fields, values)), vol_frac, found

    def _sample_cells(self, blk, cells, fields: Sequence[str]) -> np.ndarray:
        """(fields, points) float64 values of ``fields`` at the cells
        ``cells`` of blocks ``blk`` (``ops/volume.sample_points_ranked``
        on the stacks as this rank holds them)."""
        if not fields:
            return np.zeros((0, len(blk)))
        stacks = [[self._local_stack(f)] for f in fields]
        return volume_ops.sample_points_ranked(stacks, runtime.SpaceRanks(self._dmesh), blk,
                                               cells).cpu().numpy()

    # ------------------------------------------------------------------
    # Analyses
    def _profile_geometry(self, raxis: int) -> profile_ops.ProfileGeometry:
        return profile_ops.ProfileGeometry(
            block_bounds=self.block_bounds,
            refine_level=np.asarray(self.refine_level),
            blocklist=self.get_blocklist("LEAF"),
            domain_bounds=self.domain_bounds,
            ncells_vec=self.nCellsVec,
            nblks_vec=self.nBlksVec,
            ndim=self.ndim,
            raxis=raxis,
        )

    def _field_stack(self, name: str) -> torch.Tensor:
        d = self.data(name)
        if d is None:
            raise KeyError(name)
        if d.ndim == 3:
            d = d[None]
        return d

    def _local_stack(self, name: str) -> torch.Tensor:
        """A field's block stack as this rank holds it: under a sharding
        mesh its x-slab as one block (1, nx/d, ny, nz), else the whole
        stack (``_field_stack``). The rank-local analyses read it."""
        if self._dmesh is None:
            return self._field_stack(name)
        d = self._slab(name)
        return d if d.ndim == 4 else d[None]

    def _host_field_stack(self, name: str):
        """A field's whole block stack without a copy on the card: the
        stack already on the device (gathered when the volume is
        sharded), or else the file's values as a host array in grid
        order (a swapped view of the stored layout)."""
        field = self._field_name(name)
        if field is None:
            raise KeyError(name)
        if field in self._data:
            return self._field_stack(field)
        with h5lite.File(self._filename, "r") as f:
            host = flash_file.read_field_blocks(f, field)
        return host[None] if host.ndim == 3 else host

    def _profile_fields(self) -> Dict[str, torch.Tensor]:
        data = {"dens": self._local_stack("dens")}
        for a in "xyz"[: self.ndim]:
            data[f"vel{a}"] = self._local_stack(f"vel{a}")
        return data

    @timer
    def reynolds_stress(self, raxis: int = 0):
        """Reynolds stress profiles along ``raxis``: (span, stress, means)."""
        return profile_ops.reynolds_stress(self._profile_fields(), self._profile_geometry(raxis),
                                           mesh=self._dmesh)

    @timer
    def favre_profiles(self, raxis: int = 0):
        """Favre means + mass-weighted RMS along ``raxis``."""
        return profile_ops.favre_profiles(self._profile_fields(), self._profile_geometry(raxis),
                                          mesh=self._dmesh)

    def slice_integral(self, field: str, axis: int = 0):
        geom = self._profile_geometry(int(AXIS(axis)))
        return profile_ops.slice_integral(self._local_stack(field), geom, mesh=self._dmesh)

    # The analysis is registered as "slice_integration" but the mesh
    # method of the reference is "slice_integral": provide both.
    def slice_integration(self, field: str, axis: int = 0):
        return self.slice_integral(field, axis=axis)

    def slice_average(self, field: str, axis: int = 0):
        geom = self._profile_geometry(int(AXIS(axis)))
        return profile_ops.slice_average(self._local_stack(field), geom, mesh=self._dmesh)

    def _leaf_stack(self, field: str) -> torch.Tensor:
        stack = self._field_stack(field)
        blocklist = self.get_blocklist("LEAF")
        if stack.shape[0] != blocklist.size:
            stack = torch.index_select(stack, 0, torch.as_tensor(blocklist, device=stack.device))
        return stack

    def volume_integration(self, field: str) -> float:
        blocklist = self.get_blocklist("LEAF")
        return volume_ops.volume_integration(
            self._local_stack(field), self.get_cell_volumes(), blocklist, mesh=self._dmesh
        )

    def volume_average(self, field: str) -> float:
        blocklist = self.get_blocklist("LEAF")
        return volume_ops.volume_average(
            self._local_stack(field), self.get_cell_volumes(), self.domain_volume, blocklist,
            mesh=self._dmesh,
        )

    def mass_sum(self, masks: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """Total (and per-mask) mass over the leaf cells (under a sharding
        mesh, over the rank's x-slab, the masks cut to its rows)."""
        dens = self._leaf_values("dens")
        cv = np.asarray(self.get_cell_volumes("LEAF")).reshape((-1,) + (1,) * (dens.ndim - 1))
        return volume_ops.mass_sum(dens, cv, masks, mesh=self._dmesh)

    def _leaf_values(self, field: str) -> torch.Tensor:
        """A field's leaf cells as this rank holds them: the leaf stack,
        or under a sharding mesh the rank's x-slab as one block."""
        return self._leaf_stack(field) if self._dmesh is None else self._local_stack(field)

    def pdf1d(self, field: str, weight: Optional[str] = "volume", **kwargs):
        vals = self._leaf_values(field)
        return volume_ops.pdf1d(vals, weights=self._pdf_weights(weight, vals.shape),
                                mesh=self._dmesh, **kwargs)

    def pdf2d(self, field1: str, field2: str, weight: Optional[str] = "volume", **kwargs):
        vals1 = self._leaf_values(field1)
        vals2 = self._leaf_values(field2)
        return volume_ops.pdf2d(
            vals1, vals2, weights=self._pdf_weights(weight, vals1.shape), mesh=self._dmesh,
            **kwargs
        )

    def binned_statistic(self, xfield: str, yfield: str, weight: Optional[str] = "volume", **kwargs):
        """Conditional bin statistics over the leaf cells: per-bin raw
        counts + volume- (or mass-) weighted mean/std of yfield given
        xfield (weight=None for unweighted)."""
        xv = self._leaf_values(xfield)
        yv = self._leaf_values(yfield)
        return volume_ops.binned_statistic(
            xv, yv, weights=self._pdf_weights(weight, xv.shape), mesh=self._dmesh, **kwargs
        )

    def density_pdf(self, weight: Optional[str] = "volume", **kwargs):
        """Lognormality diagnostics of s = ln(rho/<rho>) over the leaf
        cells, per-level cell volumes weighting the mean and the s-PDF."""
        vals = self._leaf_values("dens")
        return volume_ops.density_pdf(
            vals, weights=self._pdf_weights(weight, vals.shape), mesh=self._dmesh, **kwargs
        )

    def _pdf_weights(self, weight: Optional[str], shape):
        """Per-cell PDF weights in the field dtype, of the ``shape`` that
        ``_leaf_values`` gives: the leaf cell volume, optionally times
        density (contiguous, as the pdf2d kernel takes them)."""
        if weight is None:
            return None
        if weight not in ("volume", "mass"):
            raise ValueError(f"Unknown pdf weight {weight}")
        cv = torch.as_tensor(
            self.get_cell_volumes("LEAF"), dtype=field_dtype(self.device), device=self.device
        )
        w = cv.reshape((-1,) + (1,) * (len(shape) - 1)).expand(shape)
        if weight == "mass":
            return w * self._leaf_values("dens")
        return w.contiguous()

    def projection(
        self,
        field: str = "dens",
        axis: int = 0,
        weight: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Line-of-sight projection map integral(field dl) along
        ``axis`` (column density for field="dens"), exact on the AMR
        tree via per-level scatter + piecewise-constant upsampling; no
        uniform regrid volume is materialized
        (ops/projection.project_amr). ``weight`` switches to the
        w-weighted line average. Returns the map over the two kept axes
        plus their cell-center coordinates. Under a sharding mesh the
        collapsed mesh is one block at the finest scale: the uniform
        projection of the rank's x-slab (ops/projection.project_uniform
        with ``mesh=``)."""
        plan = regrid_ops.RegridPlan(
            block_bounds=self.block_bounds,
            node_type=np.asarray(self.node_type),
            refine_level=np.asarray(self.refine_level),
            ncells_vec=self.nCellsVec,
            nblks_vec=self.nBlksVec,
            ndim=self.ndim,
        )
        if self._dmesh is not None:
            w = self._local_stack(weight)[0] if weight is not None else None
            m = projection_ops.project_uniform(self._local_stack(field)[0], plan.grid_delta,
                                               axis=axis, weight=w, mesh=self._dmesh)
            coords = projection_ops.amr_coords(plan, axis)
            return {"map": m, "coord1": coords[0], "coord2": coords[1]}
        w = self._field_stack(weight) if weight is not None else None
        maps, coords = projection_ops.project_amr(
            plan, {field: self._field_stack(field)}, axis=axis, weight=w
        )
        return {"map": maps[field], "coord1": coords[0], "coord2": coords[1]}

    @timer
    def flame_window(self, radius, stress, mask=None) -> float:
        """Flame centroid from a super-Gaussian fit of the transverse
        stress Ryy + Rzz over ``radius`` (ops/flame.flame_window)."""
        return flame_ops.flame_window(np.asarray(radius), stress, mask)

    # ------------------------------------------------------------------
    # Regrid
    def from_amr(
        self,
        subdomain_coords: Optional[np.ndarray] = None,
        refine_level: int = -1,
        fields: Optional[List[str]] = None,
        filename: Optional[Path] = None,
        save_file: bool = True,
        sharding=None,
    ) -> None:
        """Regrid AMR data to a uniform grid (injection prolongation).

        Collapses this mesh into a single uniform block in place and
        (optionally) writes the ``hdf5_uniform_`` file. A subdomain that
        exceeds the domain is a no-op, with a warning.

        Under an active mesh whose space axis shards the output (nx and
        ny multiples of it), each rank regrids its x-slab from only the
        blocks that slab reads and keeps it (module docstring); other
        output extents fall back, with a warning, to the whole output
        on every rank. ``sharding``, kept for fava_tpu's signature, may
        only name that placement (``parallel.runtime.space_placement()``)
        of an output that shards, and takes the same path; any other
        value raises. A source volume that is itself sharded is gathered
        first.
        """
        if subdomain_coords is not None:
            sc = np.asarray(subdomain_coords, dtype=np.float64)
            oob = sc[0, 0] < self.xmin or self.xmax < sc[0, 1]
            if self.ndim > 1:
                oob = oob or sc[1, 0] < self.ymin or self.ymax < sc[1, 1]
            if self.ndim > 2:
                oob = oob or sc[2, 0] < self.zmin or self.zmax < sc[2, 1]
            if oob:
                logger.warning(
                    "from_amr: subdomain %s exceeds the domain %s; nothing regridded",
                    sc.tolist(),
                    self.domain_bounds.tolist(),
                )
                return

        plan = regrid_ops.RegridPlan(
            block_bounds=self.block_bounds,
            node_type=np.asarray(self.node_type),
            refine_level=np.asarray(self.refine_level),
            ncells_vec=self.nCellsVec,
            nblks_vec=self.nBlksVec,
            ndim=self.ndim,
            refine_to=refine_level,
            subdomain_coords=subdomain_coords,
        )
        _fields = list(fields) if fields is not None else list(self.fields)

        regridded, dmesh = self._regrid(plan, _fields, sharding)
        total_cells = plan.total_cells
        refdom = plan.domain_box

        # Collapse to a single-block uniform mesh.
        self._data = regridded
        self._dmesh = dmesh
        self.fields = list(_fields)
        self.gid = -np.ones((1, int(2 * self.ndim + 1 + 2**self.ndim)), dtype=np.int32)
        self.refine_level = np.ones(1, dtype=np.int64)
        self.node_type = np.ones(1, dtype=np.int64)
        self.bflags = -np.ones((1, 1), dtype=np.int32)
        self.which_child = -np.ones(1, dtype=np.int32)
        if self.processors is not None:
            self.processors = np.zeros(1, dtype=np.int32)
        self.nblockx = 1
        self.nblocky = 1
        self.nblockz = 1
        self.nblocks = 1
        self.nxb = int(total_cells[0])
        self.nyb = int(total_cells[1])
        self.nzb = int(total_cells[2])
        self.block_size = (total_cells * plan.grid_delta)[None, ...]
        self.block_bounds = refdom[None, ...]
        self.coordinates = (0.5 * np.sum(refdom, axis=1))[None, ...]
        self.xmin, self.xmax = float(refdom[0, 0]), float(refdom[0, 1])
        self.ymin, self.ymax = float(refdom[1, 0]), float(refdom[1, 1])
        self.zmin, self.zmax = float(refdom[2, 0]), float(refdom[2, 1])
        self._delete_cached_properties()

        if save_file:
            if filename is None:
                # The FLASH file-type markers, not bare substrings.
                stem = self.filename.stem.replace("hdf5_plt_cnt_", "hdf5_uniform_").replace(
                    "hdf5_chk_", "hdf5_uniform_"
                )
                filename = self.filename.with_stem(stem)
            self.save(filename=filename, names=_fields)

    def _regrid(self, plan, fields: List[str], sharding):
        """(regridded fields, the mesh they are slab-sharded over or
        None): from_amr's choice of path under the active mesh."""
        mesh = runtime.get_mesh()
        shards = self.ndim == 3 and runtime.shards_volume(plan.out_shape, mesh)
        if sharding is not None and (not shards or sharding != runtime.space_placement(mesh)):
            raise ValueError(
                f"from_amr: sharding {sharding} is not the x placement of an output of "
                f"{plan.out_shape} over the active mesh's space axis"
            )
        if shards:
            stacks = {key: self._host_field_stack(key) for key in fields}
            return regrid_ops.regrid_fields_sharded(
                plan, stacks, fields, mesh, device=self.device, dtype=field_dtype(self.device)
            ), mesh
        n_space = runtime.space_axis_size(mesh)
        if n_space > 1:
            logger.warning(
                "from_amr: output extents %s do not divide the space axis %d (or ndim != 3); "
                "falling back to the whole output on every rank",
                plan.out_shape,
                n_space,
            )
        data = {key: self._field_stack(key) for key in fields}
        return regrid_ops.regrid_fields(plan, data, fields), None

    def save(self, filename: Optional[str | Path] = None, names: Optional[List[str]] = None) -> None:
        """Write this mesh as a FLASH-layout file (float64 fields and
        bounds for a chk mesh, float32 otherwise). Under a mesh of more
        than one rank, the fields are gathered (when sharded), rank 0
        alone writes the file, and every rank waits at a barrier, so no
        rank reads the file back before it is whole."""
        target = Path(filename) if filename is not None else self._filename
        names_ = [n for n in (names if names is not None else self._data) if n in self._data]
        fields = {n: self.data(n) for n in names_}
        mesh = self._dmesh if self._dmesh is not None else runtime.get_mesh()
        writer = runtime.device_axis_total(mesh) == 1 or runtime.flat_index(mesh) == 0
        if writer:
            flash_file.write_mesh_file(
                target,
                scalars=self.scalars,
                runtime_parameters=self.runtime_parameters,
                metadata={
                    "coordinates": np.asarray(self.coordinates),
                    "block size": np.asarray(self.block_size),
                    "bounding box": np.asarray(self.block_bounds),
                    "node type": np.asarray(self.node_type),
                    "refine level": np.asarray(self.refine_level),
                    "gid": np.asarray(self.gid),
                    "which child": np.asarray(self.which_child),
                    "bflags": np.asarray(self.bflags),
                    "processor number": None if self.processors is None else np.asarray(self.processors),
                },
                fields=fields,
                chk_file=self._chk_file,
            )
        if runtime.device_axis_total(mesh) > 1:
            dist.barrier()
