"""Device-mesh runtime on ``torch.distributed``.

Counterpart of fava_tpu/parallel/runtime.py. There one controller drives
every device and a volume is one ``jax.Array`` sharded over a
``jax.sharding.Mesh``. Here each rank of a ``torch.distributed`` world is
one "device" and runs the same program (SPMD): a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
fava_tpu's axis names, "space" (the volume's slab axis) and "snap" (the
snapshot batch axis of the pod series), and a sharded volume is the
rank's own x-slab, a plain tensor of the rows ``[r*nx/d, (r+1)*nx/d)``
of the space axis's rank r of d. fava_tpu's ``psum`` and
``all_to_all`` over a named axis become collectives on the process group
of that mesh dimension.

Placement rule (a deviation from fava_tpu, which shards on nx alone,
mesh/flash_uniform.py:117, :164, and lets the partitioner gather what
the sharded paths cannot take): a 3D volume is sharded only when both
nx and ny divide the space axis, the eligibility of fava_tpu's sharded
spectra (ops/spectra.py:281-288). Any other volume is held whole on
every rank and takes the single-device paths. This moves data, not
numbers.

Block and ingest placement (fava_tpu's ``block_sharding``,
``ingest_volume_sharding`` and ``ingest_sharding_fn``): a
``Placement`` takes the place of a ``NamedSharding``. It names the split
axis and this rank's part by its flat index in the mesh (row-major over
the mesh's dimensions, fava_tpu's device order), so an AMR leaf stack or
an ingested array splits over every rank of a snap x space pod, as
fava_tpu splits it over all devices.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fava_tpu_torch.utils import resolve_device

SPACE_AXIS = "space"
SNAP_AXIS = "snap"

# A hung collective raises after this long instead of blocking forever.
COLLECTIVE_TIMEOUT = timedelta(minutes=10)

_MESH = None


def device_count() -> int:
    """The world size, or 1 when no process group is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def make_device_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (SPACE_AXIS,),
    device="cuda",
):
    """A DeviceMesh of ``shape`` over the ranks of the world (all of them
    on one "space" axis when ``shape`` is None).

    The backend is NCCL on CUDA, with each rank on ``cuda:<local rank>``
    (``LOCAL_RANK``, else the global rank), and gloo only when
    ``device="cpu"`` is asked for. A world started by the caller
    (``torch.distributed.init_process_group``) must use that backend.
    With no process group, this starts a one-rank world itself on an
    in-process store, so a single card needs nothing more than fava_tpu
    needs. The mesh must cover the whole world: every rank runs the same
    program, so a rank outside the mesh would have nothing to run.
    """
    dev = resolve_device(device)
    if shape is None:
        shape = (device_count(),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"mesh shape {shape} and axis names {tuple(axis_names)} differ in length")
    need = int(np.prod(shape))
    avail = device_count()
    if need > avail:
        raise ValueError(
            f"mesh shape {shape} needs {need} devices but only {avail} are available"
        )
    if need < avail:
        raise ValueError(
            f"mesh shape {shape} covers {need} of the world's {avail} ranks; "
            "every rank must be in the mesh"
        )
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank())
    if not dist.is_initialized():
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT
        )
    elif dist.get_backend() != backend:
        raise ValueError(
            f"the world's backend is {dist.get_backend()!r}; a {dev.type} mesh needs {backend!r}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_size(mesh, axis: str) -> int:
    """Ranks on the mesh's ``axis`` (1 with no mesh or no such axis)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def space_axis_size(mesh=None) -> int:
    """Ranks on the mesh's "space" axis (1 with no mesh)."""
    return axis_size(mesh, SPACE_AXIS)


def snap_axis_size(mesh=None) -> int:
    """Ranks on the mesh's "snap" axis (1 with no mesh)."""
    return axis_size(mesh, SNAP_AXIS)


def device_axis_total(mesh=None) -> int:
    """Total rank count of the active mesh (1 with no mesh)."""
    mesh = mesh if mesh is not None else _MESH
    return 1 if mesh is None else int(np.prod(mesh.shape))


def is_pod_mesh(mesh=None) -> bool:
    """True for a 2-axis snap x space mesh (the pod series topology)."""
    mesh = mesh if mesh is not None else _MESH
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return SNAP_AXIS in names and SPACE_AXIS in names


def space_group(mesh):
    """The process group of the mesh's "space" axis: this rank's row."""
    return mesh.get_group(SPACE_AXIS)


def volume_sharding(mesh=None, axis: int = 0, ndim: int = 3):
    """The DTensor placements (one per mesh dimension) of a volume
    slab-sharded along ``axis`` over the "space" axis and replicated over
    any other: fava_tpu's ``NamedSharding``. None with no mesh or no
    space axis. The port's sharded paths hold the slab as a plain tensor
    (``shard_volume``); the placements name the layout."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SPACE_AXIS not in (mesh.mesh_dim_names or ()):
        return None
    if not 0 <= axis < ndim:
        raise ValueError(f"axis {axis} outside a {ndim}D volume")
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(axis) if n == SPACE_AXIS else Replicate() for n in mesh.mesh_dim_names]


def replicated(mesh=None):
    """The DTensor placements of a value every rank holds whole (None
    with no mesh)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def shards_volume(shape, mesh=None) -> bool:
    """The placement rule: whether a volume of ``shape`` is slab-sharded
    over the mesh's space axis (3D, space axis larger than 1, and both nx
    and ny multiples of it)."""
    mesh = mesh if mesh is not None else _MESH
    d = space_axis_size(mesh)
    return mesh is not None and len(shape) == 3 and d > 1 and shape[0] % d == 0 and shape[1] % d == 0


def slab_rows(n: int, mesh=None) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of an axis of length ``n`` split
    evenly over the mesh's space axis (all of them with no mesh)."""
    mesh = mesh if mesh is not None else _MESH
    d = space_axis_size(mesh)
    if n % d:
        raise ValueError(f"an axis of {n} does not split evenly over {d} space ranks")
    r = int(mesh.get_local_rank(SPACE_AXIS)) if d > 1 else 0
    return r * (n // d), (r + 1) * (n // d)


def shard_volume(x, mesh=None, axis: int = 0) -> torch.Tensor:
    """This rank's slab along ``axis`` of a whole array ``x`` (the whole
    of it with no mesh or a one-rank space axis). ``x`` stays where it is
    (a host array comes back as a CPU tensor)."""
    x = torch.as_tensor(x)
    lo, hi = slab_rows(int(x.shape[axis]), mesh)
    return x.narrow(axis, lo, hi - lo)


def gather_slabs(slab: torch.Tensor, mesh=None, dim: int = 0) -> torch.Tensor:
    """The whole tensor from every space rank's slab along ``dim`` (a
    volume's x-slabs, or per-row statistics with ``dim=1``): one
    all_gather on the space group, concatenated in rank order."""
    mesh = mesh if mesh is not None else _MESH
    parts = [torch.empty_like(slab) for _ in range(space_axis_size(mesh))]
    dist.all_gather(parts, slab.contiguous(), group=space_group(mesh))
    return torch.cat(parts, dim=dim)


@dataclass(frozen=True)
class Placement:
    """An array split evenly along ``axis`` into ``parts`` parts, of which
    this rank holds part ``index``: the rows ``bounds(n)`` of an axis of
    length ``n``."""

    axis: int
    index: int
    parts: int

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of an axis of length ``n``."""
        if n % self.parts:
            raise ValueError(f"an axis of {n} does not split evenly into {self.parts} parts")
        rows = n // self.parts
        return self.index * rows, (self.index + 1) * rows


def flat_ranks(mesh) -> Tuple[int, ...]:
    """The world ranks of the mesh's devices in flat (row-major) order."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def flat_index(mesh=None) -> int:
    """This rank's flat index in the mesh (0 with no mesh)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return 0
    return flat_ranks(mesh).index(dist.get_rank())


def space_placement(mesh=None, axis: int = 0) -> Optional[Placement]:
    """The placement of a volume slab-sharded along ``axis`` over the
    mesh's space axis: this rank's part is its space rank (None with no
    mesh or no space axis)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SPACE_AXIS not in (mesh.mesh_dim_names or ()):
        return None
    d = space_axis_size(mesh)
    return Placement(axis, int(mesh.get_local_rank(SPACE_AXIS)) if d > 1 else 0, d)


def _flat_placement(mesh, axis: int) -> Placement:
    return Placement(axis, flat_index(mesh), device_axis_total(mesh))


def block_sharding(mesh=None, ndim: int = 4) -> Optional[Placement]:
    """The placement of an (nblocks, nx, ny, nz) stack split along blocks
    over ALL mesh axes (blocks are independent, so a snap x space pod
    uses every rank instead of replicating the stack over snap rows).
    None with no mesh or no space axis. ``ndim`` is kept for fava_tpu's
    signature only: a placement names its axis, not the rank of the
    array."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or SPACE_AXIS not in (mesh.mesh_dim_names or ()):
        return None
    return _flat_placement(mesh, 0)


def ingest_volume_sharding(mesh=None, ndim: int = 3) -> Optional[Placement]:
    """The placement of one prefetched snapshot volume: its leading axis
    split over ALL mesh axes, so each byte is read by one rank only. None
    with no mesh. ``ndim`` is kept for fava_tpu's signature only, as in
    ``block_sharding``."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return None
    return _flat_placement(mesh, 0)


def ingest_sharding_fn(mesh=None):
    """The shape-aware placement callback of ``SnapshotPrefetcher``:
    ``fn(name, shape) -> Placement | None`` on grid-order shapes, with
    fava_tpu's rules. A 3D volume splits on x when nx divides the rank
    total and ny the space axis (the eligibility of the sharded
    analysis paths); a ``(1, nx, ny, nz)`` single block likewise on its
    second axis; a 4D block stack splits on blocks when the block count
    divides the rank total (above 1); anything else is read whole. None
    with no mesh."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return None
    total = device_axis_total(mesh)
    n_space = max(space_axis_size(mesh), 1)

    def fn(name, shape):
        shape = tuple(int(s) for s in shape)
        if len(shape) == 3 and shape[0] % total == 0 and shape[1] % n_space == 0:
            return ingest_volume_sharding(mesh)
        if len(shape) == 4 and shape[0] == 1 and shape[1] % total == 0 and shape[2] % n_space == 0:
            return _flat_placement(mesh, 1)
        if len(shape) == 4 and total > 1 and shape[0] % total == 0:
            return block_sharding(mesh)
        return None

    return fn


def gather_flat(part: torch.Tensor, mesh=None, dim: int = 0) -> torch.Tensor:
    """The whole tensor from every rank's equal part along ``dim``,
    concatenated in the mesh's flat order: one all_gather over the world,
    which the mesh covers (``make_device_mesh``)."""
    mesh = mesh if mesh is not None else _MESH
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, part.contiguous())
    return torch.cat([parts[r] for r in flat_ranks(mesh)], dim=dim)
