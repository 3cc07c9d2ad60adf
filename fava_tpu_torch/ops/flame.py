"""Flame-window centroid fit and flame surface density.

Counterpart of fava_tpu/ops/flame.py. The window fit is a tiny 1D
Levenberg-Marquardt problem on the host (scipy, imported where it is
called); the stress profiles it fits come from the device upstream. The
surface measure is plain torch on the volume's device: fava_tpu has no
Pallas kernel here (XLA fuses its jitted core), so neither does the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

XFACT = 1.0e5  # cm -> km scaling used by the reference fit


def super_gaussian(x, amp, x0, sigma):
    return amp * np.exp(-2.0 * ((x - x0) / sigma) ** 10)


def flame_window(
    radius: np.ndarray,
    stress: Dict[str, np.ndarray],
    mask: Optional[np.ndarray] = None,
) -> float:
    """Flame centroid position from a super-Gaussian fit of Ryy + Rzz."""
    import scipy.optimize

    ma = mask if mask is not None else np.where(radius < np.inf)[0]
    rd = radius[ma]
    rs = {key: np.asarray(arr)[ma] for key, arr in stress.items()}

    rspan = rd / XFACT
    rmin = np.min(rspan)

    rsyyzz = rs["Ryy"] + rs["Rzz"]
    rfact = 10.0 ** np.max(np.floor(np.log10(np.maximum(rsyyzz, 1e-300))))
    rsyyzz = rsyyzz / rfact

    opt, _ = scipy.optimize.curve_fit(
        super_gaussian,
        rspan - rmin,
        rsyyzz,
        method="lm",
        p0=(np.max(rsyyzz), rspan[np.argmax(rsyyzz)], np.std(rsyyzz)),
    )
    return float(opt[1] * XFACT)


def _flame_core(vol: torch.Tensor, deltas, axis: int) -> np.ndarray:
    """[total, max |grad c|, sigma...] as one float64 host vector.

    Central differences with one-sided edges (``torch.gradient``, as
    ``jnp.gradient``) in the volume's dtype; the plane means of the
    magnitude in float64, then the total from them (the hierarchical
    sum fava_tpu measured against a flat one), and the max.
    """
    nd = vol.dim()
    plane_axes = tuple(a for a in range(nd) if a != axis)
    plane_count = float(np.prod([vol.shape[a] for a in plane_axes]))
    cell_vol = float(np.prod(deltas))
    grads = torch.gradient(vol, spacing=list(deltas))
    mag = torch.sqrt(sum(g * g for g in grads))
    del grads
    sigma = torch.mean(mag, dim=plane_axes, dtype=torch.float64)
    total = torch.sum(sigma) * (cell_vol * plane_count)
    gmax = torch.max(mag).to(torch.float64)
    return torch.cat([total.reshape(1), gmax.reshape(1), sigma]).cpu().numpy()


def flame_surface(
    c: torch.Tensor,
    deltas,
    axis: int = 0,
):
    """Flame surface density diagnostics of a progress variable.

    Coarea-formula surface measure: for c in [0, 1],
    ``integral |grad c| dV = integral_0^1 A(c*) dc*``, the
    isolevel-averaged flame surface area. Gradients are central
    differences with one-sided edges (the flame axis is not periodic in
    an RT column). Returns:

    * ``area``       — integral |grad c| dV (isolevel-mean front area);
    * ``wrinkling``  — area / planar cross-section (the wrinkling
      factor Xi >= 1 of an axis-normal front spanning the box);
    * ``x``, ``sigma`` — slab-resolved surface density profile along
      ``axis``: plane means of |grad c| at cell-center coordinates;
    * ``max_gradient``, ``thickness`` — peak |grad c| and the gradient
      flame thickness 1 / max|grad c| of a unit progress variable.
    """
    shape = tuple(int(s) for s in c.shape)
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"flame_surface requires a 2D or 3D volume, got {nd}D")
    if len(deltas) != nd:
        raise ValueError(f"deltas must have {nd} entries, got {len(deltas)}")
    if not 0 <= axis < nd:
        raise ValueError(f"axis must be in [0, {nd}), got {axis}")
    deltas = tuple(float(d) for d in deltas)
    # Cross-section of an unwrinkled axis-normal front spanning the box.
    planar = float(np.prod([deltas[a] * shape[a] for a in range(nd) if a != axis]))
    packed = _flame_core(c, deltas, int(axis))
    total, gmax = float(packed[0]), float(packed[1])
    sigma = packed[2:]
    x = (np.arange(shape[axis], dtype=np.float64) + 0.5) * deltas[axis]
    return {
        "area": total,
        "wrinkling": total / planar,
        "x": x,
        "sigma": sigma,
        "max_gradient": gmax,
        "thickness": (1.0 / gmax) if gmax > 0 else np.inf,
    }
