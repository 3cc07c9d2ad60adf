"""Coarse-grained (filtered) kinetic-energy flux: the Favre scale
decomposition of compressible turbulence.

Counterpart of fava_tpu/ops/coarse_grain.py, single device. Definitions
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

The transforms are ``torch.fft`` (cuFFT on the card). The forward
transforms of rho, rho u_i, rho u_i u_j (and p, u_j) are taken ONCE
(``_forward``); a Python loop over the cutoffs then filters and inverts
per scale (``_scale_stats``), adding each (i, j) term into Pi as it is
formed, so that the ~28 inverse volumes of a scale are never alive
together. The arithmetic is fava_tpu's (no clamp of rho_b: a sharp
filter can ring it towards 0 on lognormal density, and a clamp would be a
different result); the means and rms are float64 sums.

Conventions shared with ops/velocity.py: cutoffs are in INTEGER
wavenumber units; ``lengths`` scales only the physical derivative
operators (2*pi/L_i); derivatives zero the un-pairable Nyquist mode of
even axes; filters do not (they are even operators).

Kernels:

* ``"sharp"``    : G = 1 for |k| <= k_c, else 0 (Galerkin projector).
* ``"gaussian"`` : G = exp(-pi^2 |k|^2 / (24 k_c^2)), width l = pi / k_c.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops.velocity import _check_vels, _irfft, _k_grids, _rfft
from fava_tpu_torch.utils import accum_dtype

_KERNELS = ("sharp", "gaussian")


def _k2_int(shape: Tuple[int, ...], dtype, device) -> torch.Tensor:
    """|k|^2 on the rfft half grid in INTEGER wavenumber units (no Nyquist
    zeroing: the filter is an even operator)."""
    ks = _k_grids(shape, dtype, device, None, zero_nyquist=False)
    return sum(k * k for k in ks)


def _filter_gain(k2: torch.Tensor, kc: float, kernel: str) -> torch.Tensor:
    """Kernel transfer function G(|k|; k_c) in k2's dtype."""
    kc = torch.tensor(kc, dtype=k2.dtype, device=k2.device)
    if kernel == "sharp":
        return (k2 <= kc * kc).to(k2.dtype)
    # gaussian, width l = pi / k_c
    return torch.exp(-(np.pi**2) * k2 / (24.0 * kc * kc))


def _flux_stat_names(with_pres: bool):
    """Packed row order shared by _scale_stats and filtered_ke_flux."""
    names = ("pi_mean", "pi_rms")
    if with_pres:
        names = ("baropycnal_mean", "baropycnal_rms") + names
    return names


def _forward(vels, dens, pres) -> Dict[str, object]:
    """The forward transforms every scale filters (unnormalised; ``_irfft``
    carries the whole 1/N, so bar() round-trips exactly under G == 1):
    rho, rho u_i (or u_i), rho u_i u_j (or u_i u_j) for i <= j, and p with
    u_j when ``pres`` is given."""
    nd = len(vels)
    if dens is not None:
        f = {"rho": _rfft(dens), "mom": [_rfft(dens * v) for v in vels],
             "qq": {(i, j): _rfft(dens * vels[i] * vels[j]) for i in range(nd) for j in range(i, nd)}}
    else:
        f = {"rho": None, "mom": [_rfft(v) for v in vels],
             "qq": {(i, j): _rfft(vels[i] * vels[j]) for i in range(nd) for j in range(i, nd)}}
    if pres is not None:
        f["p"] = _rfft(pres)
        f["u"] = [_rfft(v) for v in vels]
    return f


def _scale_fields(f, shape: Tuple[int, ...], kc: float, kernel: str, lengths) -> Dict[str, torch.Tensor]:
    """Pi (and the baropycnal Lambda when ``f`` holds p) at one cutoff."""
    nd = len(shape)
    spec0 = f["mom"][0]
    rdt = spec0.real.dtype
    g = _filter_gain(_k2_int(shape, rdt, spec0.device), kc, kernel)
    dks = _k_grids(shape, rdt, spec0.device, lengths, zero_nyquist=True)
    compressible = f["rho"] is not None

    def bar(spec):
        return _irfft(g * spec, shape)

    def dbar(spec, j):
        return bar(1j * dks[j] * spec)

    mb = [bar(s) for s in f["mom"]]  # bar(rho u_i) (or bar(u_i))
    if compressible:
        rb = bar(f["rho"])
        ub = [m / rb for m in mb]  # Favre velocity u~_i
        drb = [dbar(f["rho"], j) for j in range(nd)]
    else:
        ub = mb

    def d_ub(i, j):
        """d_j u~_i from filtered transforms: (d_j bar(rho u_i) - u~_i
        d_j bar(rho)) / rho_b, or d_j bar(u_i) at constant density."""
        d = dbar(f["mom"][i], j)
        return (d - ub[i] * drb[j]) / rb if compressible else d

    # tau is symmetric: each (i <= j) stress meets d_j u~_i + d_i u~_j.
    pi = None
    for i in range(nd):
        for j in range(i, nd):
            tau = bar(f["qq"][(i, j)])
            tau -= rb * ub[i] * ub[j] if compressible else ub[i] * ub[j]
            du = d_ub(i, j) if i == j else d_ub(i, j) + d_ub(j, i)
            term = -(tau * du)
            del tau, du
            pi = term if pi is None else pi + term
    out = {"pi": pi}
    if "p" in f:
        lam = None
        for j in range(nd):
            # tau(rho, u_j) = bar(rho u_j) - rho_b bar(u_j)
            t = dbar(f["p"], j) * (mb[j] - rb * bar(f["u"][j])) / rb
            lam = t if lam is None else lam + t
        out["baropycnal"] = lam
    return out


def _scale_stats(f, shape, kc: float, kernel: str, lengths) -> torch.Tensor:
    """float64 (mean, rms) rows of one cutoff in ``_flux_stat_names`` order."""
    fields = _scale_fields(f, shape, kc, kernel, lengths)
    stats = {}
    for name, vol in fields.items():
        va = vol.to(accum_dtype())
        stats[f"{name}_mean"] = va.mean()
        stats[f"{name}_rms"] = torch.sqrt(va.square().mean())
    return torch.stack([stats[k] for k in _flux_stat_names("baropycnal" in fields)])


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
) -> Dict[str, np.ndarray]:
    """Mean/RMS SGS kinetic-energy flux across a sweep of filter scales.

    Returns ``{"kc", "scale", "pi_mean", "pi_rms"}`` (+
    ``baropycnal_mean``/``baropycnal_rms`` when ``pres`` is given), one
    entry per cutoff; ``scale`` = pi / k_c is the nominal filter width in
    box-fraction units. ``dens=None`` selects the constant-density limit.
    The forward transforms are taken once for the whole sweep and the
    statistics fetched once (module docstring).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key, kcs = _prep(vels, dens, pres, cutoffs, kernel, lengths, "filtered_ke_flux")
    f = _forward(vels, dens, pres)
    rows = [_scale_stats(f, shape, float(kc), kernel, key) for kc in kcs]
    del f
    packed = torch.stack(rows, dim=1).cpu().numpy().astype(np.float64)  # (nstat, ncut)
    res = {"kc": kcs.copy(), "scale": np.pi / kcs}
    res.update(dict(zip(_flux_stat_names(pres is not None), packed)))
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
    :func:`filtered_ke_flux`."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, key, kcs = _prep(vels, dens, pres, (float(cutoff),), kernel, lengths, "sgs_flux_fields")
    return _scale_fields(_forward(vels, dens, pres), shape, float(kcs[0]), kernel, key)
