"""AMR -> uniform regridding through one kernel launch per 8 fields.

Counterpart of fava_tpu/ops/regrid.py (single device; the sharded plan
and regrid are ROADMAP A11b). The mapping is closed-form:

  output fine cell g (global fine-index space at the target level)
   -> block = leaf_table[g // ncells_per_block]   (small int32 table)
   -> source cell c = (g - block_offset) // 2**(lmax - block_level)

``RegridPlan`` builds the tables on the host exactly as fava_tpu does
(truncating float math, the subdomain sentinel, the scale clip);
``regrid_fields`` hands them to K7 (``cuda_kernels.regrid_fields``),
whose plain twin is the same closed form with ``torch.take``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.io.flash_file import MESH_MDIM
from fava_tpu_torch.ops import cuda_kernels


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


def regrid_fields(
    plan: RegridPlan,
    data: Dict[str, torch.Tensor],
    fields: Sequence[str],
) -> Dict[str, torch.Tensor]:
    """Regrid each field's (nblocks, nx, ny, nz) stack to the uniform grid.

    The source index of each output cell is worked out once per launch
    and copied for every field of that launch.
    """
    first = data[fields[0]]
    if first.ndim != 4:
        raise ValueError("regrid expects (nblocks, ncx, ncy, ncz) stacks")
    outs = cuda_kernels.regrid_fields(
        [data[name] for name in fields],
        *plan.device_tables(first.device),
        plan.out_shape,
        tuple(int(o) for o in plan.out_origin),
        tuple(int(c) for c in plan.ncells_vec),
    )
    return dict(zip(fields, outs))
