"""Synthetic FLASH files: AMR plt/chk trees, uniform-grid files and
tracer-particle files.

Jax-free copy of fava_tpu/io/synthetic.py (:25-350) that writes the same
arrays (a particle file from the same seed holds the same table). One change of method: fava_tpu fills each AMR field one block
per Python iteration; here every field is computed over many blocks at
once (chunks of ``_CHUNK_CELLS`` cells) straight in the file's
(nblocks, nz, ny, nx) order and written before the next field is
computed, so the host holds one field at a time and at most a chunk of
float64 temporaries. The values are the same: each cell goes through the
same float64 operations, and the file's float32 (plt) or float64 (chk)
rounding happens once.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.io import flash_file, h5lite

DEFAULT_FIELDS = ("dens", "velx", "vely", "velz", "flam")
_CHUNK_CELLS = 1 << 22


def default_field_fn(name: str) -> Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]:
    """Smooth analytic fields so regrid/analysis results are predictable."""

    def dens(x, y, z):
        return 1.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) + 0.1 * z

    def velx(x, y, z):
        return np.sin(2 * np.pi * y) + 0.3 * np.cos(4 * np.pi * z)

    def vely(x, y, z):
        return np.cos(2 * np.pi * x) * np.sin(2 * np.pi * z)

    def velz(x, y, z):
        return 0.25 * np.sin(4 * np.pi * x) + 0.5 * np.cos(2 * np.pi * y)

    def flam(x, y, z):
        return 1.0 / (1.0 + np.exp((x - 0.5) * 20.0))

    def pres(x, y, z):
        return 2.0 + 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * z)

    def gamc(x, y, z):
        return 1.4 + 0.1 * np.cos(2 * np.pi * y)

    def other(x, y, z):
        return np.sin(2 * np.pi * (x + y + z))

    return {
        "dens": dens,
        "velx": velx,
        "vely": vely,
        "velz": velz,
        "flam": flam,
        "pres": pres,
        "gamc": gamc,
    }.get(name, other)


@dataclass
class AmrBlock:
    level: int
    bounds: np.ndarray  # (3, 2)
    node_type: int  # 1 leaf, 2 parent


def build_amr_tree(
    nblks: Tuple[int, int, int],
    domain: np.ndarray,
    refine: Optional[Dict[int, int]] = None,
    refine_fn: Optional[Callable[[np.ndarray, int], int]] = None,
) -> List[AmrBlock]:
    """Build a block tree: root grid at level 1, selected roots refined.

    ``refine`` maps a root block's linear index -> target depth (2 means
    the root is split once into 8 level-2 leaves; 3 additionally splits
    the first child, producing mixed-resolution neighbors).

    ``refine_fn(bounds, level) -> target_level`` refines regions the way
    a production AMR run does: every leaf whose target exceeds its level
    is split into all 8 children, re-evaluated recursively.
    """
    refine = refine or {}
    blocks: List[AmrBlock] = []
    widths = (domain[:, 1] - domain[:, 0]) / np.asarray(nblks, dtype=np.float64)

    def split_all(block: AmrBlock) -> List[AmrBlock]:
        block.node_type = 2
        half = (block.bounds[:, 1] - block.bounds[:, 0]) / 2.0
        children = []
        for ck in range(2):
            for cj in range(2):
                for ci in range(2):
                    lb = block.bounds[:, 0] + half * np.array([ci, cj, ck], dtype=np.float64)
                    child = AmrBlock(
                        level=block.level + 1,
                        bounds=np.stack([lb, lb + half], axis=1),
                        node_type=1,
                    )
                    blocks.append(child)
                    children.append(child)
        return children

    def split(block: AmrBlock, depth_left: int) -> None:
        first_child = split_all(block)[0]
        if depth_left > 1:
            split(first_child, depth_left - 1)

    roots: List[AmrBlock] = []
    for bk in range(nblks[2]):
        for bj in range(nblks[1]):
            for bi in range(nblks[0]):
                lb = domain[:, 0] + widths * np.array([bi, bj, bk], dtype=np.float64)
                root = AmrBlock(level=1, bounds=np.stack([lb, lb + widths], axis=1), node_type=1)
                blocks.append(root)
                roots.append(root)

    for root_idx, depth in refine.items():
        if depth >= 2:
            split(roots[root_idx], depth - 1)

    if refine_fn is not None:
        queue = [b for b in blocks if b.node_type == 1]
        while queue:
            b = queue.pop()
            if b.level < int(refine_fn(b.bounds, b.level)):
                queue.extend(split_all(b))

    return blocks


def _cell_centers(bounds: np.ndarray, ncells: Tuple[int, int, int]):
    coords = []
    for axis in range(3):
        lo, hi = bounds[axis]
        dx = (hi - lo) / ncells[axis]
        coords.append(lo + (np.arange(ncells[axis]) + 0.5) * dx)
    return np.meshgrid(*coords, indexing="ij")


def _block_cell_centers_file_order(bounds: np.ndarray, ncells: Tuple[int, int, int]):
    """Cell centres of many blocks, (nb, nz, ny, nx) each, contiguous.

    Per block and axis the same ``lo + (arange(n) + 0.5) * dx`` as
    ``_cell_centers``, so every coordinate is bit-identical.
    """
    nb = bounds.shape[0]
    shape = (nb, ncells[2], ncells[1], ncells[0])
    out = []
    for axis in range(3):
        lo = bounds[:, axis, 0][:, None]
        dx = (bounds[:, axis, 1][:, None] - lo) / ncells[axis]
        c = lo + (np.arange(ncells[axis]) + 0.5) * dx  # (nb, n)
        view = [nb, 1, 1, 1]
        view[3 - axis] = ncells[axis]
        out.append(np.ascontiguousarray(np.broadcast_to(c.reshape(view), shape)))
    return out


def _scalars_and_params(
    *,
    ncells: Tuple[int, int, int],
    nblks: Tuple[int, int, int],
    nblocks: int,
    domain: np.ndarray,
    time: float,
    ndim: int = 3,
) -> Tuple[dict, dict]:
    scalars = {
        "real": {"time": float(time), "dt": 1.0e-3},
        "integer": {
            "dimensionality": int(ndim),
            "nxb": ncells[0],
            "nyb": ncells[1],
            "nzb": ncells[2],
            "iprocs": 1,
            "jprocs": 1,
            "kprocs": 1,
            "globalnumblocks": nblocks,
        },
        "logical": {},
        "string": {"geometry": "cartesian"},
    }
    runtime = {
        "real": {
            "xmin": float(domain[0, 0]),
            "xmax": float(domain[0, 1]),
            "ymin": float(domain[1, 0]),
            "ymax": float(domain[1, 1]),
            "zmin": float(domain[2, 0]),
            "zmax": float(domain[2, 1]),
        },
        "integer": {"nblockx": nblks[0], "nblocky": nblks[1], "nblockz": nblks[2]},
        "logical": {},
        "string": {},
    }
    return scalars, runtime


def _unit_domain(domain: Optional[np.ndarray]) -> np.ndarray:
    if domain is None:
        return np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]], dtype=np.float64)
    return np.asarray(domain, dtype=np.float64)


def make_amr_file(
    path: str | Path,
    *,
    ncells: Tuple[int, int, int] = (8, 8, 8),
    nblks: Tuple[int, int, int] = (2, 2, 2),
    domain: Optional[np.ndarray] = None,
    refine: Optional[Dict[int, int]] = None,
    refine_fn: Optional[Callable[[np.ndarray, int], int]] = None,
    fields: Sequence[str] = DEFAULT_FIELDS,
    field_fns: Optional[Dict[str, Callable]] = None,
    time: float = 0.0,
    chk_file: Optional[bool] = None,
) -> Path:
    """Write a synthetic FLASH AMR plt/chk file with analytic field data.

    ``refine_fn`` region-refines the tree (see :func:`build_amr_tree`);
    ``field_fns`` overrides :func:`default_field_fn` per field name.
    Fields are computed and written one at a time.
    """
    path = Path(path)
    domain = _unit_domain(domain)
    if chk_file is None:
        chk_file = "chk" in path.stem
    ncells = tuple(int(c) for c in ncells)

    blocks = build_amr_tree(tuple(nblks), domain, refine, refine_fn=refine_fn)
    nblocks = len(blocks)

    bounding_box = np.stack([b.bounds for b in blocks])  # (nB, 3, 2)
    metadata = {
        "coordinates": bounding_box.mean(axis=2),
        "block size": bounding_box[..., 1] - bounding_box[..., 0],
        "bounding box": bounding_box,
        "node type": np.array([b.node_type for b in blocks], dtype=np.int32),
        "refine level": np.array([b.level for b in blocks], dtype=np.int32),
        "gid": -np.ones((nblocks, 15), dtype=np.int32),
        "which child": -np.ones(nblocks, dtype=np.int32),
        "bflags": -np.ones((nblocks, 1), dtype=np.int32),
        "processor number": np.zeros(nblocks, dtype=np.int32),
    }
    scalars, runtime = _scalars_and_params(
        ncells=ncells, nblks=tuple(nblks), nblocks=nblocks, domain=domain, time=time
    )

    file_dtype = np.float64 if chk_file else np.float32
    per_chunk = max(1, _CHUNK_CELLS // int(np.prod(ncells)))
    with h5lite.File(path, "w") as f:
        flash_file.write_parameters(f, scalars, runtime)
        flash_file.write_metadata_dict(f, metadata, chk_file)
        flash_file.write_unknown_names(f, list(fields))
        for name in fields:
            fn = (field_fns or {}).get(name) or default_field_fn(name)
            data = np.empty((nblocks, ncells[2], ncells[1], ncells[0]), dtype=file_dtype)
            for b0 in range(0, nblocks, per_chunk):
                b1 = min(nblocks, b0 + per_chunk)
                X, Y, Z = _block_cell_centers_file_order(bounding_box[b0:b1], ncells)
                data[b0:b1] = fn(X, Y, Z)
                del X, Y, Z
            f.create_dataset(name, data=data, dtype=file_dtype)
            del data
    return path


def make_uniform_file(
    path: str | Path,
    *,
    ncells: Tuple[int, int, int] = (16, 16, 16),
    domain: Optional[np.ndarray] = None,
    fields: Sequence[str] = DEFAULT_FIELDS,
    field_data: Optional[Dict[str, np.ndarray]] = None,
    time: float = 0.0,
    seed: Optional[int] = None,
    ndim: int = 3,
) -> Path:
    """Write a synthetic single-block FLASH uniform-grid file.

    ``field_data`` (numpy arrays or tensors in grid order) overrides the
    analytic fields; with ``seed`` set, a
    reproducible random perturbation is added. 2D datasets use
    ncells=(nx, ny, 1) with ndim=2.
    """
    path = Path(path)
    domain = _unit_domain(domain)
    ncells = tuple(ncells)

    bounds = domain.copy()
    if field_data is None:
        rng = np.random.default_rng(seed) if seed is not None else None
        X, Y, Z = _cell_centers(bounds, ncells)
        field_data = {}
        for name in fields:
            data = default_field_fn(name)(X, Y, Z)
            if rng is not None:
                data = data + 0.05 * rng.standard_normal(size=data.shape)
            if name == "dens":
                data = np.abs(data) + 0.1
            field_data[name] = data
    else:
        # Tensors go to the writer as they are: it swaps them on their device.
        field_data = {
            k: v if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.float64)
            for k, v in field_data.items()
        }

    scalars, runtime = _scalars_and_params(
        ncells=ncells, nblks=(1, 1, 1), nblocks=1, domain=domain, time=time, ndim=ndim
    )

    bounding_box = bounds[None, ...]
    flash_file.write_mesh_file(
        path,
        scalars=scalars,
        runtime_parameters=runtime,
        metadata={
            "coordinates": bounding_box.mean(axis=2),
            "block size": (bounding_box[..., 1] - bounding_box[..., 0]),
            "bounding box": bounding_box,
            "node type": np.ones(1, dtype=np.int32),
            "refine level": np.ones(1, dtype=np.int32),
            "gid": -np.ones((1, 15), dtype=np.int32),
            "which child": -np.ones(1, dtype=np.int32),
            "bflags": -np.ones((1, 1), dtype=np.int32),
        },
        fields=field_data,
        chk_file=False,
    )
    return path


def make_particle_file(
    path: str | Path,
    *,
    nparticles: int = 64,
    fields: Sequence[str] = ("tag", "posx", "posy", "posz", "velx", "vely", "velz", "dens"),
    time: float = 0.0,
    seed: int = 0,
) -> Path:
    """Write a synthetic FLASH tracer-particle file."""
    path = Path(path)
    rng = np.random.default_rng(seed)
    particles: Dict[str, np.ndarray] = {}
    tags = rng.permutation(nparticles).astype(np.float64) + 1.0
    for name in fields:
        if name == "tag":
            particles[name] = tags
        elif name.startswith("pos"):
            particles[name] = rng.uniform(0.0, 1.0, nparticles)
        else:
            particles[name] = rng.standard_normal(nparticles)

    flash_file.write_particle_file(
        path,
        int_scalars={"dimensionality": 3, "globalnumparticles": nparticles},
        real_scalars={"time": float(time), "dt": 1.0e-3, "dtold": 1.0e-3},
        particles=particles,
    )
    return path
