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

Rank-local analyses (ROADMAP A11d, A11e, A11f): every analysis of a
sharded volume runs a body on the rank's x-slab and joins the bodies'
contributions with a ``SpaceRanks``: the halo planes of a neighbour
(``halo_x``), a packed all_reduce (``all_reduce_packed``), an all_gather
of per-row statistics, or the pencil transform and its inverse (the
spectra, filtering, correlations and the Helmholtz fields), never of a
whole field on the device. The analyses that return whole fields build
them on the host one slab at a time (``SpaceRanks.host_volume``).
``gather_slabs`` gathers a whole volume, only for ``data()``, ``save``
and ``from_amr``, which gather by design: rank 0 writes, and a source
that is itself sharded is gathered before the regrid.

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
    """The whole volume from every space rank's x-slab along ``dim``: one
    all_gather on the space group, concatenated in rank order. Only
    ``data()``, ``save`` and ``from_amr`` call it; every analysis joins
    with ``SpaceRanks``."""
    mesh = mesh if mesh is not None else _MESH
    return _all_gather(slab, mesh, dim)


def _all_gather(part: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(part) for _ in range(space_axis_size(mesh))]
    dist.all_gather(parts, part.contiguous(), group=space_group(mesh))
    return torch.cat(parts, dim=dim)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce_packed(vec: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``vec`` reduced by ``op`` ("sum", "min" or "max") over the mesh's
    space group, in place, and returned: one all_reduce of a packed
    vector (float64 for the analyses' sums; the structure functions'
    samples travel in the field dtype)."""
    dist.all_reduce(vec, op=_OPS[op], group=space_group(mesh))
    return vec


def halo_x(slab: torch.Tensor, mesh, width: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(below, above): the ``width`` x-planes just below and just above
    this rank's x-slab, with the periodic wrap across ranks 0 and d-1:
    the last planes of rank r-1 and the first planes of rank r+1. One
    ``batch_isend_irecv`` on the space group; on a one-rank space axis,
    the slab's own wrapped planes."""
    width = int(width)
    if not 0 < width <= slab.shape[0]:
        raise ValueError(f"a halo of {width} planes from a slab of {slab.shape[0]}")
    d = space_axis_size(mesh)
    if d == 1:
        return slab[-width:], slab[:width]
    group = space_group(mesh)
    r = int(mesh.get_local_rank(SPACE_AXIS))
    prev, nxt = (dist.get_global_rank(group, (r + s) % d) for s in (-1, 1))
    below = torch.empty_like(slab[:width])
    above = torch.empty_like(slab[:width])
    # The same order of posting on every rank: a pair of ranks (d = 2)
    # exchanges two messages each way, matched in order (and by tag).
    ops = [
        dist.P2POp(dist.isend, slab[-width:].contiguous(), nxt, group, 0),
        dist.P2POp(dist.isend, slab[:width].contiguous(), prev, group, 1),
        dist.P2POp(dist.irecv, below, prev, group, 0),
        dist.P2POp(dist.irecv, above, nxt, group, 1),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return below, above


class SpaceRanks:
    """The ranks of a space axis that this process plays, and the joins
    of their contributions: what the rank-local analyses run on.

    ``SpaceRanks(mesh)``: this rank of the mesh's space axis; each join
    is one collective on the space group. ``SpaceRanks(d=d)``: every rank
    0 .. d-1 of a virtual axis in turn, in this process (the virtual-rank
    checks), and a join reduces or joins the list; ``SpaceRanks()`` is
    the one rank of a single device. A rank-local body runs once for each
    rank in ``ranks`` on that rank's x-slab (``slabs`` below are in that
    order), and a join takes the list of the bodies' contributions and
    returns the whole axis's, the same on every rank. Nothing here is
    sized by the whole volume."""

    def __init__(self, mesh=None, d: Optional[int] = None):
        self.mesh = mesh
        if mesh is not None:
            self.d = space_axis_size(mesh)
            self.ranks = (int(mesh.get_local_rank(SPACE_AXIS)) if self.d > 1 else 0,)
        else:
            self.d = 1 if d is None else int(d)
            self.ranks = tuple(range(self.d))

    def reduce(self, parts, op: str = "sum") -> torch.Tensor:
        """The contributions reduced by ``op`` over the axis."""
        if self.mesh is not None:
            return all_reduce_packed(parts[0].clone(), self.mesh, op)
        fn = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}[op]
        out = parts[0]
        for p in parts[1:]:
            out = fn(out, p)
        return out

    def gather(self, parts, dim: int = 0) -> torch.Tensor:
        """The contributions joined along ``dim`` in rank order."""
        if self.mesh is not None:
            return _all_gather(parts[0], self.mesh, dim)
        return torch.cat(list(parts), dim=dim)

    def halos(self, slabs, width: int = 1):
        """(below, above) of each slab: ``halo_x`` under a mesh, else cut
        from the neighbouring slabs of the list (periodic)."""
        if self.mesh is not None:
            return [halo_x(slabs[0], self.mesh, width)]
        n = len(slabs)
        return [(slabs[i - 1][-width:], slabs[(i + 1) % n][:width]) for i in range(n)]

    def pencil_rfft(self, slabs):
        """The y-slab (nx, ny/d, nz//2+1) of the normalized real transform
        of the volume for each x-slab: under a mesh the pencil transform
        (``parallel.fft.pencil_rfft``), else the whole volume's transform
        cut into y-slabs."""
        from fava_tpu_torch.parallel.fft import pencil_rfft

        if self.mesh is not None:
            return [pencil_rfft(slabs[0], self.mesh)]
        whole = slabs[0] if len(slabs) == 1 else torch.cat(list(slabs))
        w = torch.fft.rfftn(whole, norm="forward")
        cols = int(w.shape[1]) // self.d
        return [w[:, r * cols : (r + 1) * cols] for r in self.ranks]

    def pencil_irfft(self, slabs_hat, full_shape):
        """The x-slab (nx/d, ny, nz) for each y-slab (nx, ny/d, nz//2+1) of
        a normalized half-spectrum, the inverse of ``pencil_rfft``: under
        a mesh the inverse pencil transform (``parallel.fft.pencil_irfft``),
        else the y-slabs joined, the whole volume's inverse cut into
        x-slabs."""
        from fava_tpu_torch.parallel.fft import pencil_irfft

        full_shape = tuple(int(s) for s in full_shape)
        if self.mesh is not None:
            return [pencil_irfft(slabs_hat[0], full_shape, self.mesh)]
        whole = slabs_hat[0] if len(slabs_hat) == 1 else torch.cat(list(slabs_hat), dim=1)
        v = torch.fft.irfftn(whole, s=full_shape, norm="forward")
        rows = full_shape[0] // self.d
        return [v[r * rows : (r + 1) * rows] for r in self.ranks]

    def host_volume(self, slabs) -> np.ndarray:
        """The whole volume on the host, in numpy, from the x-slabs (of
        equal shape) that the axis's ranks hold. A host array is
        allocated whole and filled slab by slab: under a mesh the rank's
        own slab is copied, then each rank's slab in turn is broadcast
        on the space group through one slab-sized device buffer, so the
        device holds the rank's slab and one more; every rank gets the
        same array. The host holds the whole volume on every rank."""
        first = slabs[0]
        rows = int(first.shape[0])
        out = torch.empty((rows * self.d,) + tuple(first.shape[1:]), dtype=first.dtype)
        if self.mesh is None:
            for r, slab in zip(self.ranks, slabs):
                out[r * rows : (r + 1) * rows].copy_(slab)
            return out.numpy()
        mine = self.ranks[0]
        out[mine * rows : (mine + 1) * rows].copy_(first)
        if self.d > 1:
            group = space_group(self.mesh)
            buf = torch.empty_like(first, memory_format=torch.contiguous_format)
            for r in range(self.d):
                src = first.contiguous() if r == mine else buf
                dist.broadcast(src, dist.get_global_rank(group, r), group=group)
                if r != mine:
                    out[r * rows : (r + 1) * rows].copy_(buf)
        return out.numpy()


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
