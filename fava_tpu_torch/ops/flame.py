"""Flame-window centroid fit and flame surface density.

Counterpart of fava_tpu/ops/flame.py. The window fit is a tiny 1D
Levenberg-Marquardt problem on the host (scipy, imported where it is
called); the stress profiles it fits come from the device upstream. The
surface measure is plain torch on the volume's device: fava_tpu has no
Pallas kernel here (XLA fuses its jitted core), so neither does the port.
It is one body over the x-slabs that a ``parallel.SpaceRanks`` plays
(``flame_surface_ranked``): under a device mesh the rank's slab with one
halo plane each side, the single device its one slab.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fava_tpu_torch.parallel import runtime

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


def _x_gradient(slab: torch.Tensor, dx: float, halo, rank: int, d: int) -> torch.Tensor:
    """The x-derivative of a rank's x-slab, as ``torch.gradient`` gives it
    on the whole volume: the slab with its neighbours' planes (``halo``:
    below, above), central differences across them, and the one-sided
    edge of the first and last rank, whose wrapped planes are dropped
    (the flame axis is not periodic)."""
    if d == 1:
        return torch.gradient(slab, spacing=dx, dim=0)[0]
    below, above = halo
    parts = ([below] if rank > 0 else []) + [slab] + ([above] if rank < d - 1 else [])
    lo = 1 if rank > 0 else 0
    return torch.gradient(torch.cat(parts), spacing=dx, dim=0)[0][lo : lo + slab.shape[0]]


def _gradient_magnitude(slab, dx_grad, deltas) -> torch.Tensor:
    """|grad c| of a rank's x-slab from its x-derivative ``dx_grad``, the
    other derivatives local, in the slab's dtype."""
    others = torch.gradient(slab, spacing=list(deltas[1:]), dim=list(range(1, slab.dim())))
    return torch.sqrt(sum(g * g for g in (dx_grad, *others)))


def _flame_core_ranked(slabs, ranks, deltas, shape, axis: int) -> np.ndarray:
    """[total, max |grad c|, sigma...] as one float64 host vector, of the
    volume of ``shape`` whose x-slabs ``ranks`` plays.

    Central differences with one-sided edges (``torch.gradient``, as
    ``jnp.gradient``) in the volume's dtype, one halo plane each side
    along x. sigma: along x each rank's float64 plane means, joined with
    its max by one gather; along y or z each rank's float64 partial plane
    sums, one SUM (each rank's max packed in its own slot, exact: one
    contributor each), divided by the whole plane count. Then the total
    from sigma (the hierarchical sum fava_tpu measured against a flat
    one), the same on every rank."""
    nd = len(shape)
    plane_axes = tuple(a for a in range(nd) if a != axis)
    plane_count = float(np.prod([shape[a] for a in plane_axes]))
    cell_vol = float(np.prod(deltas))
    halos = ranks.halos(slabs) if ranks.d > 1 else [None] * len(slabs)
    parts = []
    for slab, halo, r in zip(slabs, halos, ranks.ranks):
        mag = _gradient_magnitude(slab, _x_gradient(slab, deltas[0], halo, r, ranks.d), deltas)
        gmax = torch.max(mag).to(torch.float64).reshape(1)
        if axis == 0:
            parts.append(torch.cat([gmax, torch.mean(mag, dim=plane_axes, dtype=torch.float64)])[None])
        else:
            slots = torch.zeros(ranks.d, dtype=torch.float64, device=slab.device)
            slots[r] = gmax[0]
            parts.append(torch.cat([slots, torch.sum(mag, dim=plane_axes, dtype=torch.float64)]))
        del mag
    if axis == 0:
        rows = ranks.gather(parts)
        gmax, sigma = rows[:, 0].max(), rows[:, 1:].reshape(-1)
    else:
        joined = ranks.reduce(parts)
        gmax, sigma = joined[: ranks.d].max(), joined[ranks.d :] / plane_count
    total = torch.sum(sigma) * (cell_vol * plane_count)
    return torch.cat([total.reshape(1), gmax.reshape(1), sigma]).cpu().numpy()


def flame_surface(
    c: torch.Tensor,
    deltas,
    axis: int = 0,
    mesh=None,
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

    With ``mesh``, ``c`` is the rank's x-slab of a 3D volume slab-sharded
    over the mesh's space axis (:func:`flame_surface_ranked`); every rank
    gets the whole volume's diagnostics.
    """
    nd = c.dim()
    if mesh is not None and nd != 3:
        raise ValueError("the sharded flame surface needs a 3D volume")
    ranks = runtime.SpaceRanks(mesh)
    shape = (int(c.shape[0]) * ranks.d,) + tuple(int(s) for s in c.shape[1:])
    return flame_surface_ranked([c], ranks, deltas, shape, axis)


def flame_surface_ranked(slabs, ranks: runtime.SpaceRanks, deltas, shape, axis: int = 0):
    """:func:`flame_surface` of the volume of global ``shape`` whose
    x-slabs ``ranks`` plays (``_flame_core_ranked``)."""
    shape = tuple(int(s) for s in shape)
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
    packed = _flame_core_ranked(slabs, ranks, deltas, shape, int(axis))
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
