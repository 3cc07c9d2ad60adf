"""Fractal (box-counting) dimension of a contour surface.

Counterpart of fava_tpu/ops/fractal.py (reference:
fava/mesh/FLASH/FlashUniform.py:85-227), plain torch: fava_tpu leaves it
to XLA. A cell is on the surface when it lies below the contour with any
of its 4 (2D) or 6 neighbours above it, inside the interior, or when it
equals the contour; the filled boxes of every dyadic level come from one
cascade of 2x2x2 (2x2x1) any-pools over the mask padded once to the
largest box; the mean-log2-ratio dimension and the regression statistics
use the reference's formulas on the host, in float64.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Union

import numpy as np
import torch

from fava_tpu_torch.utils import accum_dtype


def edge_detect(data: torch.Tensor, contour) -> torch.Tensor:
    """int8 mask of contour-surface cells of an (h, w, d) volume
    (6-neighbour threshold crossings; 4 when d == 1)."""
    h, w, d = data.shape
    below = data < contour
    interior = torch.zeros_like(below)
    if d > 1:
        interior[1 : h - 1, 1 : w - 1, 1 : d - 1] = True
    else:
        interior[1 : h - 1, 1 : w - 1, :] = True
    shifts = [(1, 0), (-1, 0), (1, 1), (-1, 1)] + ([(1, 2), (-1, 2)] if d > 1 else [])
    gt = data > contour  # roll the 1-byte mask, not the volume
    crossing = torch.zeros_like(below)
    for shift, axis in shifts:
        crossing |= torch.roll(gt, -shift, dims=axis)
    return (below & crossing & interior | (data == contour)).to(torch.int8)


def box_counts(edata: torch.Tensor, flength: int) -> np.ndarray:
    """Filled boxes of side 2^level, level = 0 .. flength-1 (boxes of one
    cell along z when d == 1), partial edge boxes included: int64 host
    array. The mask is padded once to a multiple of the largest box and
    each level is a 2x2x2 any-pool of the last, so the mask is read once."""
    h, w, d = edata.shape
    top = 2 ** (flength - 1)

    def pad(n):
        return -(-n // top) * top

    shape = (pad(h), pad(w), d if d == 1 else pad(d))
    m = torch.zeros(shape, dtype=torch.uint8, device=edata.device)
    m[:h, :w, :d] = edata > 0
    counts = [m.sum()]
    for _ in range(1, flength):
        a, b, c = m.shape
        kz = 1 if d == 1 else 2
        m = m.reshape(a // 2, 2, b // 2, 2, c // kz, kz).amax(dim=(1, 3, 5))
        counts.append(m.sum())
    return torch.stack(counts).cpu().numpy()


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
    data: torch.Tensor, contours: Union[float, List[float], None] = 0.5
) -> Dict[str, Dict[str, float]]:
    """Box-counting dimension of an (h, w, d) volume for each contour
    level: {contour: {"average fractal dimension", "slope", "R2",
    "curve"}}. ``contours=None`` takes the volume's mean (in the
    accumulation dtype, then in the data's)."""
    contour_list = _contours(contours)
    h, w, d = data.shape
    largest = min(h, w) if d == 1 else min(h, w, d)
    flength = int(np.log2(largest)) + 1
    out: Dict[str, Dict[str, float]] = {}
    for contour in contour_list:
        if contour is None:
            c = data.to(accum_dtype()).mean().to(data.dtype)
        else:
            c = torch.tensor(float(contour), dtype=data.dtype, device=data.device)
        out[f"{contour}"] = _statistics(box_counts(edge_detect(data, c), flength))
    return out
