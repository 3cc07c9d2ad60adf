"""Fractal (box-counting) dimension of a contour surface.

Counterpart of fava_tpu/ops/fractal.py (reference:
fava/mesh/FLASH/FlashUniform.py:85-227), plain torch: fava_tpu leaves it
to XLA. A cell is on the surface when it lies below the contour with any
of its 4 (2D) or 6 neighbours above it, inside the interior, or when it
equals the contour; the filled boxes of every dyadic level come from one
cascade of 2x2x2 (2x2x1) any-pools over the mask padded once to the
largest box; the mean-log2-ratio dimension and the regression statistics
use the reference's formulas on the host, in float64.

A volume slab-sharded over a device mesh (``mesh=``, ROADMAP A11d) is
analysed rank-locally: each rank detects the edges of its x-slab with
one halo plane from each neighbour (the interior in global x), pools
while the box side divides its slab, and joins the rest by one
all_gather of a coarse uint8 mask and one all_reduce of the counts,
which equal the single device's exactly.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Union

import numpy as np
import torch

from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype


def edge_detect(data: torch.Tensor, contour, halo=None, x0: int = 0, full_nx=None) -> torch.Tensor:
    """int8 mask of contour-surface cells of an (h, w, d) volume
    (6-neighbour threshold crossings; 4 when d == 1), the x neighbours
    across the periodic wrap. With ``halo``, ``data`` is the x-slab of
    rows x0 .. x0+h-1 of a volume of ``full_nx`` rows and ``halo`` its
    (below, above) x-planes (``parallel.runtime.halo_x``): the crossings
    read them, and the interior is the whole volume's."""
    h, w, d = data.shape
    if halo is None:
        halo, full_nx = (data[-1:], data[:1]), h
    # Threshold the 1-byte mask (halo planes and slab), not the volume.
    gt = torch.cat([halo[0] > contour, data > contour, halo[1] > contour])
    crossing = gt[2:] | gt[:-2]
    inner = gt[1:-1]
    for shift, axis in [(1, 1), (-1, 1)] + ([(1, 2), (-1, 2)] if d > 1 else []):
        crossing |= torch.roll(inner, -shift, dims=axis)
    dev = data.device

    def inside(lo, n, full):
        i = torch.arange(lo, lo + n, device=dev)
        return (i >= 1) & (i <= full - 2)

    interior = inside(x0, h, full_nx)[:, None, None] & inside(0, w, w)[None, :, None]
    if d > 1:
        interior = interior & inside(0, d, d)[None, None, :]
    return ((data < contour) & crossing & interior | (data == contour)).to(torch.int8)


def _pool(m: torch.Tensor, kz: int) -> torch.Tensor:
    """One 2x2x2 (2x2x1) any-pool of a uint8 box mask."""
    a, b, c = m.shape
    return m.reshape(a // 2, 2, b // 2, 2, c // kz, kz).amax(dim=(1, 3, 5))


def box_counts(edata: torch.Tensor, flength: int) -> np.ndarray:
    """Filled boxes of side 2^level, level = 0 .. flength-1 (boxes of one
    cell along z when d == 1), partial edge boxes included: int64 host
    array. The mask is padded to a multiple of the largest box and each
    level is a 2x2x2 any-pool of the last, so the mask is read once."""
    return box_counts_ranked([edata], runtime.SpaceRanks(), tuple(edata.shape), flength)


def box_counts_ranked(masks, ranks: runtime.SpaceRanks, full_shape, flength: int) -> np.ndarray:
    """``box_counts`` of a volume of ``full_shape`` from the x-slabs of its
    edge mask that ``ranks`` plays (``masks``). Each slab runs the any-pool
    cascade while the box side divides its x extent (and so its offset);
    at the first level where it does not, one all_gather joins that
    level's coarse uint8 masks (one byte a box) and the cascade ends on
    the whole coarse mask, padded in x to the largest box. One all_reduce
    sums the slabs' counts of the levels before: every count is exact."""
    h, w, d = (int(s) for s in full_shape)
    top = 2 ** (flength - 1)

    def pad(n):
        return -(-n // top) * top

    kz = 1 if d == 1 else 2
    rows = int(masks[0].shape[0])
    local = 1
    while local < flength and rows % 2**local == 0:
        local += 1
    parts, coarse = [], []
    for e in masks:
        m = torch.zeros((rows, pad(w), d if d == 1 else pad(d)), dtype=torch.uint8, device=e.device)
        m[:, :w, :d] = e > 0
        counts = [m.sum()]
        for _ in range(1, local):
            m = _pool(m, kz)
            counts.append(m.sum())
        parts.append(torch.stack(counts).to(torch.float64))
        coarse.append(m)
    counts = ranks.reduce(parts)
    if local < flength:
        m = ranks.gather(coarse, dim=0)
        extra = (pad(h) >> (local - 1)) - int(m.shape[0])
        if extra:
            m = torch.cat([m, m.new_zeros((extra,) + tuple(m.shape[1:]))])
        rest = []
        for _ in range(local, flength):
            m = _pool(m, kz)
            rest.append(m.sum())
        counts = torch.cat([counts, torch.stack(rest).to(torch.float64)])
    return counts.to(torch.int64).cpu().numpy()


def _contours(contours) -> List:
    if contours is None:
        return [None]
    if isinstance(contours, (int, float, np.number)) and not isinstance(contours, bool):
        return [contours]
    if isinstance(contours, (list, tuple)):
        return list(contours)
    raise ValueError("Contours must be either a float, list of floats, or None")


def _statistics(nfilled: np.ndarray) -> Dict[str, float]:
    """The reference's dimension and regression statistics of the box
    counts (largest boxes last). An empty level has log2 count -inf and
    the statistics degrade to NaN, as the reference's do; numpy's warnings
    are silenced for that case only."""
    flength = nfilled.size
    result = np.zeros((flength, 2))
    result[:, 0] = flength - np.arange(flength) - 1
    empty = nfilled == 0
    result[:, 1] = np.where(empty, -np.inf, np.log2(np.where(empty, 1, nfilled)))
    quiet = np.errstate(invalid="ignore", divide="ignore") if empty.any() else contextlib.nullcontext()
    with quiet:
        filled_boxes = 2.0 ** result[:, 1]
        cum = np.sum(np.log2(filled_boxes[:-1] / filled_boxes[1:]))
        avg_frac_dim = cum / (filled_boxes.size - 1.0)
        mean = np.mean(result, axis=0)
        std = np.std(result, axis=0)
        rval = np.sum((result[:, 0] - mean[0]) * (result[:, 1] - mean[1])) / (
            np.prod(std) * result.shape[0]
        )
        slope = rval * std[1] / std[0]
    return {
        "average fractal dimension": float(avg_frac_dim),
        "slope": float(slope),
        "R2": float(rval**2),
        "curve": float(mean[1] - slope * mean[0]),
    }


def fractal_dimension(
    data: torch.Tensor, contours: Union[float, List[float], None] = 0.5, mesh=None
) -> Dict[str, Dict[str, float]]:
    """Box-counting dimension of an (h, w, d) volume for each contour
    level: {contour: {"average fractal dimension", "slope", "R2",
    "curve"}}. ``contours=None`` takes the volume's mean (in the
    accumulation dtype, then in the data's). With ``mesh``, ``data`` is
    the rank's x-slab of a volume slab-sharded over the mesh's space
    axis: ``fractal_dimension_ranked`` on it, the halo planes from the
    neighbours; every rank gets the whole volume's result."""
    return fractal_dimension_ranked([data], runtime.SpaceRanks(mesh), contours)


def fractal_dimension_ranked(slabs, ranks: runtime.SpaceRanks,
                             contours: Union[float, List[float], None] = 0.5):
    """``fractal_dimension`` of the volume whose x-slabs ``ranks`` plays
    (``slabs``, in that order; the whole volume on a single device): one
    halo plane on each side of each slab, the edge masks on the slabs,
    ``box_counts_ranked``, and for ``contours=None`` the mean by one
    all_reduce of the slabs' float64 sums."""
    contour_list = _contours(contours)
    rows, w, d = (int(s) for s in slabs[0].shape)
    h = rows * ranks.d
    largest = min(h, w) if d == 1 else min(h, w, d)
    flength = int(np.log2(largest)) + 1
    halos = ranks.halos(slabs, 1)
    out: Dict[str, Dict[str, float]] = {}
    for contour in contour_list:
        ref = slabs[0]
        if contour is None:
            total = ranks.reduce([s.to(accum_dtype()).sum()[None] for s in slabs])[0]
            c = (total / (h * w * d)).to(ref.dtype)
        else:
            c = torch.tensor(float(contour), dtype=ref.dtype, device=ref.device)
        masks = [edge_detect(s, c, halo, r * rows, h)
                 for s, halo, r in zip(slabs, halos, ranks.ranks)]
        out[f"{contour}"] = _statistics(box_counts_ranked(masks, ranks, (h, w, d), flength))
    return out
