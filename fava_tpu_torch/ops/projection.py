"""Line-of-sight projections (column-density-style maps).

Counterpart of fava_tpu/ops/projection.py. P(y, z) = integral f dl
along ``axis``, the column map of FLASH post-processing (column density
for f = dens). Exact on the AMR tree without regridding: the line
integral of a piecewise-constant field is a per-cell sum of
f * dx_level, so each refinement level is scatter-added (``index_add_``)
into a map at its own resolution, using the integer block origins of
``ops/regrid.RegridPlan``, and then upsampled to the finest grid by
replication (``repeat_interleave``), which is exact for a
piecewise-constant integrand. No uniform volume is materialized.

Weighted projections P = integral w f dl / integral w dl project the
numerator and the denominator separately: both are linear along the
line of sight, so per-level contributions add exactly.

Plain torch on the stacks' device with float64 sums: fava_tpu has no
Pallas kernel here (XLA fuses it), so neither does the port. The uniform
projection is one body over the x-slabs that a ``parallel.SpaceRanks``
plays (``project_uniform_ranked``), so a volume slab-sharded over a
device mesh projects without gathering: along x one SUM of the partial
line sums, along y or z the map's rows joined.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype


def project_uniform(
    vol: torch.Tensor,
    deltas: Sequence[float],
    axis: int = 0,
    weight: Optional[torch.Tensor] = None,
    mesh=None,
) -> np.ndarray:
    """Projection of one uniform volume: integral f dl (or the
    w-weighted line average when ``weight`` is given). 2D volumes
    project to 1D column profiles. With ``mesh``, ``vol`` (and
    ``weight``) are the rank's x-slab of a 3D volume slab-sharded over
    the mesh's space axis (:func:`project_uniform_ranked`); every rank
    gets the whole map."""
    nd = vol.dim()
    if nd not in (2, 3):
        raise ValueError(f"projection requires a 2D or 3D volume, got {nd}D")
    if not 0 <= axis < nd:
        raise ValueError(f"axis must be in [0, {nd}), got {axis}")
    if mesh is not None and nd != 3:
        raise ValueError("the sharded projection needs a 3D volume")
    return project_uniform_ranked([vol], runtime.SpaceRanks(mesh), deltas, axis,
                                  None if weight is None else [weight]).cpu().numpy()


def _line_sums(vol: torch.Tensor, weight: Optional[torch.Tensor], axis: int) -> torch.Tensor:
    """A slab's float64 sums along ``axis``: of f, or the stacked
    numerator and denominator (integral w f, integral w) when weighted."""
    adt = accum_dtype()
    if weight is None:
        return torch.sum(vol, dim=axis, dtype=adt)
    wa = weight.to(adt)
    return torch.stack([torch.sum(vol.to(adt) * wa, dim=axis), torch.sum(wa, dim=axis)])


def _line_map(sums: torch.Tensor, weighted: bool, dx: float) -> torch.Tensor:
    """The map from ``_line_sums``: times dl, or the numerator over the
    denominator (a zero denominator divides by one)."""
    if not weighted:
        return sums * dx
    num, den = sums[0], sums[1]
    return num / torch.where(den != 0, den, torch.ones_like(den))


def project_uniform_ranked(slabs, ranks: runtime.SpaceRanks, deltas: Sequence[float],
                           axis: int = 0, weight_slabs=None) -> torch.Tensor:
    """:func:`project_uniform` of the volume whose x-slabs ``ranks`` plays
    (``weight_slabs`` in the same order), as a tensor. Along x every line
    crosses every slab: each slab's float64 partial line sums (the
    numerator and denominator packed when weighted), one SUM join, then
    the map. Along y or z each line lies in one slab: each slab's rows of
    the map, joined along x in rank order."""
    weighted = weight_slabs is not None
    weights = list(weight_slabs) if weighted else [None] * len(slabs)
    dx = float(deltas[axis])
    parts = [_line_sums(v, w, axis) for v, w in zip(slabs, weights)]
    if axis == 0:
        return _line_map(ranks.reduce(parts), weighted, dx)
    return ranks.gather([_line_map(p, weighted, dx) for p in parts])


def amr_coords(plan, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """The cell-center coordinates of the finest grid along the two axes
    that a projection along ``axis`` keeps."""
    keep = tuple(a for a in range(3) if a != axis)
    return tuple(
        (np.arange(int(plan.total_cells[a])) + 0.5) * float(plan.grid_delta[a])
        + float(plan.domain_box[a, 0])
        for a in keep
    )


def project_amr(
    plan,
    stacks: Dict[str, torch.Tensor],
    axis: int = 0,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Exact per-level AMR projection along ``axis``.

    ``plan`` is an ops/regrid.RegridPlan at full depth (it provides the
    integer fine-grid block origins and per-block scales); ``stacks``
    maps field name -> FULL block stack (nB, ncx, ncy, ncz). Returns
    ({field: (n1, n2) map}, (coords1, coords2)) over the two kept axes.
    With ``weight`` (a full block stack of the weight field; it may
    also appear in ``stacks``, e.g. density-weighted density), maps are
    the w-weighted line averages integral(w f dl) / integral(w dl).
    """
    if plan.ndim != 3:
        raise ValueError(f"projection requires a 3D AMR tree, got {plan.ndim}D")
    if not 0 <= axis < 3:
        raise ValueError(f"axis must be in [0, 3), got {axis}")
    if plan.subdomain_flag:
        raise ValueError("projection does not support subdomain crops; project the full domain")

    keep = tuple(a for a in range(3) if a != axis)
    out_cells = tuple(int(plan.total_cells[a]) for a in keep)
    nc = tuple(int(plan.ncells_vec[a]) for a in keep)
    dx_fine = float(plan.grid_delta[axis])
    adt = accum_dtype()
    device = next(iter(stacks.values())).device

    ids = plan.source_ids
    scales = plan.block_scales[ids]
    offsets = plan.block_offsets[ids]

    def level_project(sel, idx_flat, s, pq_shape):
        # integrand: f * dx at this level, summed along the line of sight
        plane = torch.sum(sel, dim=1 + axis, dtype=adt) * (dx_fine * s)
        level = torch.zeros(pq_shape[0] * pq_shape[1], dtype=adt, device=device)
        level.index_add_(0, idx_flat, plane.reshape(-1))
        level = level.reshape(pq_shape)
        # piecewise-constant upsample to the finest grid (exact)
        return torch.repeat_interleave(torch.repeat_interleave(level, s, dim=0), s, dim=1)

    # Numerator maps per requested field (integral f dl, or integral
    # w*f dl when weighted, field == weight included) plus one
    # denominator map (integral w dl), accumulated separately.
    maps: Dict[str, torch.Tensor] = {}
    den = None
    for s in sorted(set(int(v) for v in scales)):
        sel_np = np.nonzero(scales == s)[0]
        sel_ids = torch.as_tensor(ids[sel_np], device=device)
        nb = sel_np.size
        P, Q = out_cells[0] // s, out_cells[1] // s
        o1 = offsets[sel_np, keep[0]] // s
        o2 = offsets[sel_np, keep[1]] // s
        i1 = o1[:, None, None] + np.arange(nc[0])[None, :, None]
        i2 = o2[:, None, None] + np.arange(nc[1])[None, None, :]
        idx_flat = torch.as_tensor((i1 * Q + i2).reshape(nb, -1).ravel(), device=device)
        w_sel = None
        if weight is not None:
            w_sel = torch.index_select(weight, 0, sel_ids).to(adt)
            contrib = level_project(w_sel, idx_flat, s, (P, Q))
            den = contrib if den is None else den + contrib
        for name, stack in stacks.items():
            sel = torch.index_select(stack, 0, sel_ids)
            if w_sel is not None:
                sel = sel.to(adt) * w_sel
            contrib = level_project(sel, idx_flat, s, (P, Q))
            maps[name] = contrib if name not in maps else maps[name] + contrib
            del sel
        del w_sel

    if weight is not None:
        den_safe = torch.where(den != 0, den, torch.ones_like(den))
        out = {name: (m / den_safe).cpu().numpy() for name, m in maps.items()}
    else:
        out = {name: m.cpu().numpy() for name, m in maps.items()}

    return out, amr_coords(plan, axis)
