"""Coarse-grained (filtered) kinetic-energy flux: the Favre scale
decomposition of compressible turbulence.

Counterpart of fava_tpu/ops/coarse_grain.py. Definitions
(Favre filtering, 2D or 3D periodic boxes):

* ``bar(f)``      = low-pass filter of f at cutoff k_c (spectral
  multiplication by the kernel G, below),
* ``rho_b``       = bar(rho),
* ``u~_i``        = bar(rho u_i) / rho_b          (Favre velocity),
* ``rho_b tau_ij``= bar(rho u_i u_j) - rho_b u~_i u~_j
  (density-weighted SGS stress),
* deformation work (SGS kinetic-energy flux):
  ``Pi_l(x) = - rho_b tau_ij  d_j u~_i``  (sum over i, j),
* baropycnal work (only when a pressure field is given):
  ``Lambda_l(x) = (1 / rho_b) d_j bar(p) [ bar(rho u_j) - rho_b bar(u_j) ]``.

Positive mean Pi_l = forward cascade. With ``dens=None`` the
constant-density limit is used: rho == 1, u~ == bar(u), tau_ij =
bar(u_i u_j) - bar(u_i) bar(u_j). For a sharp filter on a divergence-free
field the volume mean obeys the exact discrete identity <Pi_l> = flux(k_c)
of ``ops.velocity.transfer_spectrum``.

One body runs over the x-slabs that a ``parallel.SpaceRanks`` plays: the
whole volume on a single device (``SpaceRanks()``), or under a device
mesh (``mesh=``, ROADMAP A11f.1) the rank's x-slab of a 3D volume
slab-sharded over its space axis. The products rho, rho u_i, rho u_i u_j
(and p, u_j) are formed on the x-slab and given their normalized forward
transforms ONCE (``_forward``: ``ranks.pencil_rfft``, each rank's y-slab
of the half-spectrum; ``torch.fft``, cuFFT on the card). A Python loop
over the cutoffs then filters on each y-slab (the gain of its global ky
columns) and brings each filtered field back to the x-slab by the
inverse pencil transform (``_scale_fields``), where tau, the Favre
velocities, Pi and Lambda are formed, adding each (i, j) term into Pi
as it is formed, so that the ~28 inverse volumes of a scale are never
alive together. Each rank keeps float64 (sum, sum of squares) of every
field of every cutoff, and ONE packed SUM joins the whole sweep; the
means and rms divide by the whole volume's cell count. The arithmetic is
fava_tpu's (no clamp of rho_b: a sharp filter can ring it towards 0 on
lognormal density, and a clamp would be a different result).

Conventions shared with ops/velocity.py: cutoffs are in INTEGER
wavenumber units; ``lengths`` scales only the physical derivative
operators (2*pi/L_i); derivatives zero the un-pairable Nyquist mode of
even axes; filters do not (they are even operators).

Kernels:

* ``"sharp"``    : G = 1 for |k| <= k_c, else 0 (Galerkin projector).
* ``"gaussian"`` : G = exp(-pi^2 |k|^2 / (24 k_c^2)), width l = pi / k_c.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops.velocity import (
    _check_vels,
    _k_grids,
    _mesh_ranks,
    _ranked_shape,
    _slab_cols,
)
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype

_KERNELS = ("sharp", "gaussian")


def _k2_int(shape: Tuple[int, ...], dtype, device, cols=None) -> torch.Tensor:
    """|k|^2 on the rfft half grid in INTEGER wavenumber units (no Nyquist
    zeroing: the filter is an even operator), or on its y-slab ``cols``
    (``_k_grids``)."""
    ks = _k_grids(shape, dtype, device, None, zero_nyquist=False, cols=cols)
    return sum(k * k for k in ks)


def _filter_gain(k2: torch.Tensor, kc: float, kernel: str) -> torch.Tensor:
    """Kernel transfer function G(|k|; k_c) in k2's dtype."""
    kc = torch.tensor(kc, dtype=k2.dtype, device=k2.device)
    if kernel == "sharp":
        return (k2 <= kc * kc).to(k2.dtype)
    # gaussian, width l = pi / k_c
    return torch.exp(-(np.pi**2) * k2 / (24.0 * kc * kc))


def _flux_stat_names(with_pres: bool):
    """Packed row order shared by _scale_sums and filtered_ke_flux_ranked."""
    names = ("pi_mean", "pi_rms")
    if with_pres:
        names = ("baropycnal_mean", "baropycnal_rms") + names
    return names


def _forward(vel_slabs, dens, pres, ranks) -> Dict[str, object]:
    """The transforms every scale filters, of the volume whose x-slabs
    ``ranks`` plays (``vel_slabs`` a list of the components each, ``dens``
    and ``pres`` lists of the slabs or None): the y-slabs (a list in slab
    order, ``ranks.pencil_rfft``; normalized, so the inverse pencil
    transform round-trips exactly under G == 1) of rho, rho u_i (or u_i),
    rho u_i u_j (or u_i u_j) for i <= j, and of p with u_j when ``pres``
    is given, each product formed on the x-slabs."""
    nd = len(vel_slabs[0])
    fwd = ranks.pencil_rfft
    rho = dens if dens is not None else [None] * len(vel_slabs)

    def weighted(r, x):
        return x if r is None else r * x

    f = {"rho": None if dens is None else fwd(dens),
         "mom": [fwd([weighted(r, v[i]) for r, v in zip(rho, vel_slabs)]) for i in range(nd)],
         "qq": {(i, j): fwd([weighted(r, v[i] * v[j]) for r, v in zip(rho, vel_slabs)])
                for i in range(nd) for j in range(i, nd)}}
    if pres is not None:
        f["p"] = fwd(pres)
        f["u"] = [fwd([v[i] for v in vel_slabs]) for i in range(nd)]
    return f


def _scale_fields(f, shape: Tuple[int, ...], kc: float, kernel: str, lengths,
                  ranks) -> Dict[str, List[torch.Tensor]]:
    """Pi (and the baropycnal Lambda when ``f`` holds p) at one cutoff:
    the x-slab of each slab that ``ranks`` plays. Each bar() filters the
    y-slabs of a transform (``_forward``) and brings the field back by
    one inverse pencil transform."""
    nd = len(shape)
    spec0 = f["mom"][0][0]
    rdt, dev = spec0.real.dtype, spec0.device
    cols = _slab_cols(shape, ranks)
    gains = [_filter_gain(_k2_int(shape, rdt, dev, c), kc, kernel) for c in cols]
    dks = [_k_grids(shape, rdt, dev, lengths, True, c) for c in cols]
    compressible = f["rho"] is not None
    slabs = range(len(cols))

    def bar(spec):
        return ranks.pencil_irfft([g * s for g, s in zip(gains, spec)], shape)

    def dbar(spec, j):
        return bar([1j * dk[j] * s for dk, s in zip(dks, spec)])

    mb = [bar(s) for s in f["mom"]]  # bar(rho u_i) (or bar(u_i))
    if compressible:
        rb = bar(f["rho"])
        ub = [[m / r for m, r in zip(m_i, rb)] for m_i in mb]  # Favre velocity u~_i
        drb = [dbar(f["rho"], j) for j in range(nd)]
    else:
        ub = mb

    def d_ub(i, j):
        """d_j u~_i from filtered transforms: (d_j bar(rho u_i) - u~_i
        d_j bar(rho)) / rho_b, or d_j bar(u_i) at constant density."""
        d = dbar(f["mom"][i], j)
        if not compressible:
            return d
        return [(dk - u * dr) / r for dk, u, dr, r in zip(d, ub[i], drb[j], rb)]

    # tau is symmetric: each (i <= j) stress meets d_j u~_i + d_i u~_j.
    pi = [None] * len(cols)
    for i in range(nd):
        for j in range(i, nd):
            tau = bar(f["qq"][(i, j)])
            du = d_ub(i, j)
            if i != j:
                du = [a + b for a, b in zip(du, d_ub(j, i))]
            for k in slabs:
                tau[k] -= rb[k] * ub[i][k] * ub[j][k] if compressible else ub[i][k] * ub[j][k]
                term = -(tau[k] * du[k])
                pi[k] = term if pi[k] is None else pi[k] + term
            del tau, du
    out = {"pi": pi}
    if "p" in f:
        lam = [None] * len(cols)
        for j in range(nd):
            # tau(rho, u_j) = bar(rho u_j) - rho_b bar(u_j)
            dp, uj = dbar(f["p"], j), bar(f["u"][j])
            for k in slabs:
                t = dp[k] * (mb[j][k] - rb[k] * uj[k]) / rb[k]
                lam[k] = t if lam[k] is None else lam[k] + t
            del dp, uj
        out["baropycnal"] = lam
    return out


def _scale_sums(f, shape, kc: float, kernel: str, lengths, ranks) -> List[torch.Tensor]:
    """The float64 sum (``*_mean`` rows) and sum of squares (``*_rms``
    rows) of each field of one cutoff, in ``_flux_stat_names`` order: one
    vector a slab that ``ranks`` plays."""
    fields = _scale_fields(f, shape, kc, kernel, lengths, ranks)
    adt = accum_dtype()
    names = _flux_stat_names("baropycnal" in fields)
    rows = []
    for k in range(len(ranks.ranks)):
        vols = {name: vol[k].to(adt) for name, vol in fields.items()}
        rows.append(torch.stack([vols[n.rsplit("_", 1)[0]].sum() if n.endswith("_mean")
                                 else vols[n.rsplit("_", 1)[0]].square().sum() for n in names]))
        del vols
    return rows


def _prep(vels, dens, pres, cutoffs, kernel, lengths, what):
    shape, key = _check_vels(vels, lengths, what)
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got {kernel!r}")
    kcs = np.asarray(cutoffs, dtype=np.float64)
    if kcs.ndim != 1 or kcs.size == 0 or not np.all(kcs > 0):
        raise ValueError("cutoffs must be a non-empty 1D sequence of positive wavenumbers")
    if pres is not None and dens is None:
        raise ValueError(
            "baropycnal work needs a density field: pass dens alongside pres "
            "(it vanishes identically at constant density)"
        )
    for name, fld in (("dens", dens), ("pres", pres)):
        # broadcast-compatible mismatches (e.g. an unsqueezed (n, n, 1)
        # dens with (n, n) velocities) would silently corrupt Pi_l
        if fld is not None and tuple(int(s) for s in fld.shape) != shape:
            raise ValueError(
                f"{what}: {name} shape {tuple(fld.shape)} does not match "
                f"velocity shape {shape}"
            )
    return shape, key, kcs


def filtered_ke_flux(
    velx: torch.Tensor,
    vely: torch.Tensor,
    velz: Optional[torch.Tensor] = None,
    *,
    dens: Optional[torch.Tensor] = None,
    pres: Optional[torch.Tensor] = None,
    cutoffs: Sequence[float] = (4.0, 8.0, 16.0),
    kernel: str = "gaussian",
    lengths: Optional[Sequence[float]] = None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Mean/RMS SGS kinetic-energy flux across a sweep of filter scales.

    Returns ``{"kc", "scale", "pi_mean", "pi_rms"}`` (+
    ``baropycnal_mean``/``baropycnal_rms`` when ``pres`` is given), one
    entry per cutoff; ``scale`` = pi / k_c is the nominal filter width in
    box-fraction units. ``dens=None`` selects the constant-density limit.
    The forward transforms are taken once for the whole sweep and the
    statistics joined and fetched once (module docstring). With ``mesh``
    the fields are the rank's x-slabs of a 3D volume slab-sharded over the
    mesh's space axis (:func:`filtered_ke_flux_ranked`); every rank gets
    the whole volume's statistics.
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key, kcs = _prep(vels, dens, pres, cutoffs, kernel, lengths, "filtered_ke_flux")
    ranks = _mesh_ranks(shape, "filtered KE flux", mesh)
    return filtered_ke_flux_ranked([list(vels)], ranks, None if dens is None else [dens],
                                   None if pres is None else [pres], kcs, kernel, key)


def filtered_ke_flux_ranked(vel_slabs, ranks, dens, pres, cutoffs, kernel: str,
                            lengths) -> Dict[str, np.ndarray]:
    """:func:`filtered_ke_flux` of the volume whose x-slabs ``ranks``
    plays (``vel_slabs`` a list of the components each, ``dens`` and
    ``pres`` lists of the slabs or None; ``cutoffs`` and ``kernel`` as
    checked by the entry): the forward transforms once, each cutoff's
    float64 sums on each slab (``_scale_sums``), ONE SUM of the whole
    sweep's, then the means and rms over the whole volume."""
    shape = _ranked_shape(vel_slabs, ranks)
    kcs = np.asarray(cutoffs, dtype=np.float64)
    f = _forward(vel_slabs, dens, pres, ranks)
    rows = [_scale_sums(f, shape, float(kc), kernel, lengths, ranks) for kc in kcs]
    del f
    sums = ranks.reduce([torch.stack([r[k] for r in rows], dim=1) for k in range(len(ranks.ranks))])
    names = _flux_stat_names(pres is not None)
    stats = sums / float(np.prod(shape))
    packed = torch.stack([s if n.endswith("_mean") else torch.sqrt(s)
                          for n, s in zip(names, stats)])
    res = {"kc": kcs.copy(), "scale": np.pi / kcs}
    res.update(dict(zip(names, packed.cpu().numpy().astype(np.float64))))  # (nstat, ncut)
    return res


def sgs_flux_fields(
    velx: torch.Tensor,
    vely: torch.Tensor,
    velz: Optional[torch.Tensor] = None,
    *,
    cutoff: float,
    dens: Optional[torch.Tensor] = None,
    pres: Optional[torch.Tensor] = None,
    kernel: str = "gaussian",
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, torch.Tensor]:
    """Pointwise SGS flux field(s) at ONE filter scale: ``{"pi": volume}``
    (+ ``"baropycnal"`` when ``pres`` is given) on the input's device, the
    inputs of intermittency statistics. Same definitions as
    :func:`filtered_ke_flux`. No mesh analysis: it takes whole volumes on
    a single device (the body on ``SpaceRanks()``) and returns whole
    fields."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key, kcs = _prep(vels, dens, pres, (float(cutoff),), kernel, lengths, "sgs_flux_fields")
    ranks = runtime.SpaceRanks()
    f = _forward([list(vels)], None if dens is None else [dens], None if pres is None else [pres],
                 ranks)
    return {name: vol[0] for name, vol in
            _scale_fields(f, shape, float(kcs[0]), kernel, key, ranks).items()}
