"""AMR -> uniform regridding through one kernel launch per 8 fields.

Counterpart of fava_tpu/ops/regrid.py, the sharded plan and regrid
included. The mapping is closed-form:

  output fine cell g (global fine-index space at the target level)
   -> block = leaf_table[g // ncells_per_block]   (small int32 table)
   -> source cell c = (g - block_offset) // 2**(lmax - block_level)

``RegridPlan`` builds the tables on the host exactly as fava_tpu does
(truncating float math, the subdomain sentinel, the scale clip);
``regrid_fields`` hands them to K7 (``cuda_kernels.regrid_fields``),
whose plain twin is the same closed form with ``torch.take``.

Under a device mesh the output is slab-sharded along x over the space
axis, and ``ShardedRegridPlan`` gives each space rank only the source
blocks its slab reads (``block_ids``, padded to the largest count
``bmax``): the rank builds its own tables on the host (the leaf table
with block ids remapped to positions in its local stack, -1 kept, and
the offsets and scales of its local blocks), and K7 runs unchanged on
the slab's box, ``out_shape=(nx/d, ny, nz)`` at ``origin=(ox + r*nx/d,
oy, oz)``. No collective: the block distribution is worked out on the
host. fava_tpu refuses a local stack whose flat index space
``bmax*bx*by*bz`` passes int32 (its gather index is int32); K7's source
offsets are 64-bit (csrc/amr_kernels.cu), so the port needs no such
bound, as its single-device regrid needs none.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.io.flash_file import MESH_MDIM
from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import resolve_device


class RegridPlan:
    """Host-precomputed tables mapping the fine grid onto source blocks."""

    def __init__(
        self,
        *,
        block_bounds: np.ndarray,  # (nB, 3, 2)
        node_type: np.ndarray,
        refine_level: np.ndarray,
        ncells_vec: np.ndarray,  # (3,)
        nblks_vec: np.ndarray,  # (3,)
        ndim: int,
        refine_to: int = -1,
        subdomain_coords: Optional[np.ndarray] = None,
    ) -> None:
        block_bounds = np.asarray(block_bounds, dtype=np.float64)
        node_type = np.asarray(node_type)
        refine_level = np.asarray(refine_level).astype(np.int64)
        ncells_vec = np.asarray(ncells_vec, dtype=np.int64)
        nblks_vec = np.asarray(nblks_vec, dtype=np.int64)
        self.ndim = int(ndim)

        lmax_global = int(refine_level.max())
        ref_lev = min(int(refine_to), lmax_global)
        lmax = ref_lev if ref_lev > 0 else lmax_global
        self.lref_max = lmax

        # Global grid bounding box from block extents.
        grid_box = np.zeros((MESH_MDIM, 2), dtype=np.float64)
        grid_box[:, 0] = block_bounds[..., 0].min(axis=0)
        grid_box[:, 1] = block_bounds[..., 1].max(axis=0)
        self.grid_box = grid_box

        cellfac = 2 ** (lmax - 1)
        self.grid_delta = (grid_box[:, 1] - grid_box[:, 0]) / (ncells_vec * nblks_vec * cellfac)

        # Per-block fine-cell index boxes, truncating the float math to
        # int32 as the reference does.
        half = 0.5 * self.grid_delta
        bcids = (
            (block_bounds - grid_box[:, 0, None] + half[None, :, None])
            / self.grid_delta[None, :, None]
        ).astype(np.int32)
        self.block_offsets = bcids[:, :, 0].astype(np.int64)
        # Exponent clipped at 0: blocks finer than the target level are
        # never selected by the lookup table.
        self.block_scales = 2 ** np.maximum(lmax - refine_level, 0)

        # Reference sentinel: the subdomain is active if ANY axis row
        # contains no zero; only a box whose every row touches zero reads
        # as "the whole domain" (a transverse crop [0, 1] still crops).
        subdomain_flag = subdomain_coords is not None and any(
            0 not in np.asarray(sdc) for sdc in np.asarray(subdomain_coords)
        )
        self.subdomain_flag = subdomain_flag

        sub_bcids = np.zeros((MESH_MDIM, 2), dtype=np.int32)
        if subdomain_flag:
            sc = np.asarray(subdomain_coords, dtype=np.float64)
            sub_bcids[:] = (0.5 + (sc - grid_box[:, :1]) / self.grid_delta[:, None]).astype(np.int32)
        self.sub_bcids = sub_bcids

        fine_blks = cellfac * nblks_vec
        total_cells = np.ones(MESH_MDIM, dtype=np.int64)
        if subdomain_flag:
            total_cells[:ndim] = np.diff(sub_bcids[:ndim]).ravel()
            self.out_origin = sub_bcids[:, 0].astype(np.int64)
            self.domain_box = grid_box[:, :1] + sub_bcids * self.grid_delta[:, None]
        else:
            total_cells[:ndim] = fine_blks[:ndim] * ncells_vec[:ndim]
            self.out_origin = np.zeros(MESH_MDIM, dtype=np.int64)
            self.domain_box = grid_box.copy()
        self.total_cells = total_cells

        # Source-block selection: with a target level, leaves above it
        # plus any block exactly at it; otherwise plain leaves. Optionally
        # restricted to the subdomain intersection.
        is_leaf = node_type == 1
        if ref_lev > 0:
            maybe = (is_leaf & (refine_level < ref_lev)) | (refine_level == ref_lev)
        else:
            maybe = is_leaf

        if subdomain_flag:
            for n in range(ndim):
                maybe &= (sub_bcids[n, 0] <= bcids[:, n, 1]) & (bcids[:, n, 0] <= sub_bcids[n, 1])

        self.source_ids = np.nonzero(maybe)[0].astype(np.int64)

        # Lookup table at finest-block granularity: which block covers
        # each (ncells-sized) tile of the fine grid. Its size bounds host
        # memory, so very deep trees are refused.
        self.ncells_vec = ncells_vec
        tbl_shape = tuple(int(fine_blks[a]) if a < ndim else 1 for a in range(MESH_MDIM))
        tbl_cells = int(np.prod(tbl_shape))
        if tbl_cells > 512**3:
            raise MemoryError(
                f"Regrid lookup table would need {tbl_cells} entries "
                f"({tbl_shape} fine-block tiles). Crop with subdomain_coords "
                f"or truncate with refine_level for very deep AMR trees."
            )
        table = -np.ones(tbl_shape, dtype=np.int32)
        for b in self.source_ids:
            s = int(self.block_scales[b])
            o = self.block_offsets[b]
            sl = []
            for a in range(MESH_MDIM):
                if a < ndim:
                    b0 = int(o[a]) // int(ncells_vec[a])
                    sl.append(slice(b0, b0 + s))
                else:
                    sl.append(slice(0, 1))
            table[tuple(sl)] = b
        self.leaf_table = table

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        return tuple(int(c) for c in self.total_cells)

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(leaf_table int32, block_offsets int64, block_scales int64) on ``device``."""
        return (
            torch.as_tensor(self.leaf_table, dtype=torch.int32, device=device),
            torch.as_tensor(self.block_offsets, dtype=torch.int64, device=device).contiguous(),
            torch.as_tensor(self.block_scales, dtype=torch.int64, device=device),
        )


class ShardedRegridPlan:
    """Host-side block distribution of a regrid whose output is
    slab-sharded along x over ``n_space`` ranks: ``block_ids[r]`` are
    the source blocks rank r's slab reads (padded with block 0 to
    ``bmax``), ``remap[r]`` each global block's position in that local
    stack (-1 where the block is not local)."""

    def __init__(self, plan: RegridPlan, n_space: int) -> None:
        nx = plan.out_shape[0]
        if nx % n_space != 0:
            raise ValueError(
                f"sharded regrid: the space axis ({n_space}) must evenly divide the output x "
                f"extent ({nx}); crop or pad the subdomain, or use the unsharded regrid_fields"
            )
        self.plan = plan
        self.n_space = int(n_space)
        self.nxs = nx // self.n_space
        ncx = int(plan.ncells_vec[0])
        ox = int(plan.out_origin[0])
        table = plan.leaf_table
        nb_total = len(plan.block_scales)
        dev_ids = []
        for d in range(self.n_space):
            r0 = (d * self.nxs + ox) // ncx
            r1 = ((d + 1) * self.nxs - 1 + ox) // ncx
            sub = table[r0 : r1 + 1]
            dev_ids.append(np.unique(sub[sub >= 0]).astype(np.int64))
        self.bmax = max(1, max(ids.size for ids in dev_ids))
        self.block_counts = tuple(int(ids.size) for ids in dev_ids)
        self.block_ids = np.zeros((self.n_space, self.bmax), dtype=np.int64)
        self.remap = -np.ones((self.n_space, max(1, nb_total)), dtype=np.int32)
        for d, ids in enumerate(dev_ids):
            self.block_ids[d, : ids.size] = ids
            self.remap[d, ids] = np.arange(ids.size, dtype=np.int32)

    @property
    def slab_shape(self) -> Tuple[int, int, int]:
        _nx, ny, nz = self.plan.out_shape
        return self.nxs, ny, nz

    def slab_origin(self, r: int) -> Tuple[int, int, int]:
        """The first fine cell of rank r's slab."""
        ox, oy, oz = (int(o) for o in self.plan.out_origin)
        return ox + r * self.nxs, oy, oz

    def local_tables(self, r: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Rank r's (leaf table of local block positions, int32; offsets
        (bmax, 3) and scales (bmax,), int64) on ``device``."""
        table = self.plan.leaf_table
        local = np.where(table >= 0, self.remap[r][np.maximum(table, 0)], -1).astype(np.int32)
        ids = self.block_ids[r]
        return (
            torch.as_tensor(local, device=device),
            torch.as_tensor(self.plan.block_offsets[ids], dtype=torch.int64, device=device),
            torch.as_tensor(self.plan.block_scales[ids], dtype=torch.int64, device=device),
        )

    def local_stack(self, r: int, stack, device, dtype=None) -> torch.Tensor:
        """Rank r's (bmax, bx, by, bz) block stack on ``device`` (as
        ``dtype``), taken from a whole stack (a host array, possibly a
        swapped view of the stored layout, or a tensor) by its block ids:
        only those blocks are copied, in the stack's memory order, and
        put in grid order on ``device``."""
        ids = self.block_ids[r]
        if isinstance(stack, torch.Tensor):
            local = torch.index_select(stack, 0, torch.as_tensor(ids, device=stack.device))
        else:
            local = torch.as_tensor(np.asarray(stack)[ids])
        return local.to(device=device, dtype=dtype or local.dtype).contiguous()


def regrid_fields_slab(
    splan: ShardedRegridPlan,
    r: int,
    stacks: Dict[str, object],
    fields: Sequence[str],
    device="cuda",
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """Rank r's (nx/d, ny, nz) output slab of each field: only the
    blocks that slab reads are copied from the field's whole (nB, bx,
    by, bz) stack in ``stacks`` (a host array or a tensor) to ``device``
    as ``dtype`` (default: the stack's own), and K7 runs on the slab's
    box with the rank's tables."""
    device = resolve_device(device)
    local = [splan.local_stack(r, stacks[name], device, dtype) for name in fields]
    outs = cuda_kernels.regrid_fields(
        local,
        *splan.local_tables(r, device),
        splan.slab_shape,
        splan.slab_origin(r),
        tuple(int(c) for c in splan.plan.ncells_vec),
    )
    return dict(zip(fields, outs))


def regrid_fields_sharded(
    plan: RegridPlan,
    host_stacks: Dict[str, object],
    fields: Sequence[str],
    mesh,
    axis_name: str = runtime.SPACE_AXIS,
    device="cuda",
    dtype=None,
) -> Dict[str, torch.Tensor]:
    """Sharded regrid: this rank's x-slab over the mesh's ``axis_name``
    axis of each field, regridded on ``device`` from only the source
    blocks that slab reads (``ShardedRegridPlan``,
    ``regrid_fields_slab``)."""
    splan = ShardedRegridPlan(plan, runtime.axis_size(mesh, axis_name))
    r = int(mesh.get_local_rank(axis_name))
    return regrid_fields_slab(splan, r, host_stacks, fields, device, dtype)


def regrid_fields(
    plan: RegridPlan,
    data: Dict[str, torch.Tensor],
    fields: Sequence[str],
    sharding=None,
) -> Dict[str, torch.Tensor]:
    """Regrid each field's (nblocks, nx, ny, nz) stack to the uniform grid.

    The source index of each output cell is worked out once per launch
    and copied for every field of that launch. With ``sharding`` (a
    ``parallel.runtime.Placement`` of the output's x axis) the result is
    that part's x-slab, from the blocks it reads (``regrid_fields_slab``).
    """
    first = data[fields[0]]
    if first.ndim != 4:
        raise ValueError("regrid expects (nblocks, ncx, ncy, ncz) stacks")
    if sharding is not None:
        if sharding.axis != 0:
            raise ValueError(f"regrid output is sharded along x, not axis {sharding.axis}")
        splan = ShardedRegridPlan(plan, sharding.parts)
        return regrid_fields_slab(splan, sharding.index, data, fields, first.device)
    outs = cuda_kernels.regrid_fields(
        [data[name] for name in fields],
        *plan.device_tables(first.device),
        plan.out_shape,
        tuple(int(o) for o in plan.out_origin),
        tuple(int(c) for c in plan.ncells_vec),
    )
    return dict(zip(fields, outs))
