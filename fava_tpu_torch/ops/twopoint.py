"""Real-space two-point correlation functions (Wiener-Khinchin).

Counterpart of fava_tpu/ops/twopoint.py, single device. R(r) =
<f'(x) f'(x+r)> on the periodic box is the inverse transform of the power
spectrum: ``torch.fft`` (cuFFT on the card) forward, |f̂|^2 in the field
dtype, and for the scalar case one inverse volume transform whose
trailing-axis half is shell-averaged over |r| by the port's scalar shell
binning (``velocity._bin_rfft_stats``: K3 + the single-channel walk for
even x and y extents, B10 otherwise; float32 values on the card, float64
sums). Real-space separations wrap as min(j, n - j), the geometry of the
k-shells, and R(r) = R(-r), so the Hermitian-weighted binning of the half
volume is the full-volume shell mean.

Axis lines never need the velocity correlation volume: the line R(r e_a)
is the 1D inverse transform of the power marginal summed over the other
axes (the phase involves k_a only), and the Hermitian-weighted half-grid
plane sum equals the full-spectrum marginal once every other axis is
summed. The marginals are float64 sums on every device. The out-of-core
drivers (``ops/outofcore.py``) end in the same host assembly
(``assemble_karman_howarth``, ``_integral_scale``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops.velocity import _bin_rfft_stats, _hermitian_weights, _irfft, _rfft
from fava_tpu_torch.utils import accum_dtype


def _power_marginal(p: torch.Tensor, full_shape: Tuple[int, ...], axis: int) -> torch.Tensor:
    """Full-spectrum float64 power marginal along ``axis`` from the
    half-grid power volume ``p`` (trailing axis halved), as rfft-layout
    coefficients of the axis line (length n_axis//2 + 1)."""
    nd = len(full_shape)
    adt = accum_dtype()
    if axis == nd - 1:
        # trailing axis: sum the leading axes and keep the half grid (the
        # 1D irfft applies the conjugate-pair weighting itself)
        return p.sum(dim=tuple(range(nd - 1)), dtype=adt)
    hw = _hermitian_weights(full_shape, adt, p.device)
    others = tuple(a for a in range(nd) if a != axis)
    m_half = (p.to(adt) * hw).sum(dim=others)  # signed k_axis
    # The weight-2 half-grid sum at +k counts the conjugate modes that live
    # at -k (the mirror is (-kx, -ky, -kz)): S(k) + S(-k) = 2 M(k), so the
    # true (even) marginal is the symmetrisation.
    m_full = 0.5 * (m_half + torch.roll(torch.flip(m_half, (0,)), 1))
    return m_full[: full_shape[axis] // 2 + 1]


def _scalar_corr(f: torch.Tensor, shape: Tuple[int, ...], nbins: int) -> torch.Tensor:
    """[variance, shell counts, shell sums, the per-axis half lines] of
    one field as ONE packed float64 vector (one host fetch)."""
    adt = accum_dtype()
    ndim = len(shape)
    ntot = int(np.prod(shape))
    fm = f - f.to(adt).mean().to(f.dtype)
    fhat = _rfft(fm)
    del fm
    p = fhat.real.square() + fhat.imag.square()
    del fhat
    corr = _irfft(p, shape) / ntot
    del p
    lines = []
    for a, n in enumerate(shape):
        sel = tuple(slice(None) if i == a else 0 for i in range(ndim))
        lines.append(corr[sel][: n // 2 + 1].to(adt))
    # Shell average over |r| of the trailing-axis half volume, in the field
    # dtype (the card's binning takes float32; its sums are float64).
    counts, sums = _bin_rfft_stats(corr[..., : shape[-1] // 2 + 1], shape, nbins)
    var = corr.reshape(-1)[:1].to(adt)
    return torch.cat([var, counts, sums] + lines)


def _unpack_scalar_corr(packed: np.ndarray, shape, nbins: int):
    var = float(packed[0])
    counts = packed[1 : 1 + nbins]
    sums = packed[1 + nbins : 1 + 2 * nbins]
    lines = []
    off = 1 + 2 * nbins
    for n in shape:
        m = n // 2 + 1
        lines.append(packed[off : off + m])
        off += m
    return var, lines, counts, sums


def _velocity_corr(vels, shape: Tuple[int, ...]) -> torch.Tensor:
    """Raw half lines <u_i'(x) u_i'(x + r e_a)> of every component along
    every axis, packed comp-major, axis-minor, float64."""
    adt = accum_dtype()
    ntot = int(np.prod(shape))
    lines = []
    for v in vels:
        vhat = _rfft(v - v.to(adt).mean().to(v.dtype))
        p = vhat.real.square() + vhat.imag.square()
        del vhat
        for a, n in enumerate(shape):
            # irfft carries 1/n and the unnormalised transforms 1/ntot^2:
            # n/ntot^2 gives the raw <u'(x) u'(x+r)> (line[0] == variance)
            marg = _power_marginal(p, shape, a)
            lines.append(torch.fft.irfft(marg, n=n)[: n // 2 + 1] * (float(n) / float(ntot) ** 2))
        del p
    return torch.cat(lines)


def _integral_scale(line: np.ndarray, dx: float) -> float:
    """integral_0^rzc R(r)/R(0) dr — trapezoid to the first zero
    crossing (linearly interpolated), or the half box if R stays
    positive (standard periodic-box convention)."""
    r0 = line[0]
    if not np.isfinite(r0) or r0 <= 0:
        return float("nan")
    rho = line / r0
    neg = np.nonzero(rho <= 0)[0]
    if neg.size == 0:
        return float(np.trapezoid(rho, dx=dx))
    j = int(neg[0])
    if j == 0:
        return 0.0
    area = float(np.trapezoid(rho[: j], dx=dx))
    # triangle from the last positive sample to the interpolated zero
    frac = rho[j - 1] / (rho[j - 1] - rho[j])
    return area + 0.5 * rho[j - 1] * frac * dx


def _check_volume(f, lengths, what: str):
    shape = tuple(int(s) for s in f.shape)
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"{what} requires a 2D or 3D volume, got {nd}D")
    if lengths is not None and len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    return shape, nd


def two_point_correlation(
    field: torch.Tensor,
    lengths: Optional[Sequence[float]] = None,
    nbins: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Scalar two-point autocorrelation R(r) = <f'(x) f'(x+r)> / var f.

    Returns the shell-averaged isotropic curve (``r_shell`` in CELL units:
    shell radii mix axes, so physical units only make sense for cubic
    cells) plus per-axis line correlations ``R_<ax>`` over physical
    separations ``r_<ax>`` (box ``lengths``; unit box default) and their
    integral length scales ``integral_scale_<ax>`` (trapezoid to the first
    zero crossing). ``variance`` is <f'^2>. ``nbins`` defaults to
    max(min(shape)//2, 1).
    """
    shape, nd = _check_volume(field, lengths, "two_point_correlation")
    if nbins is None:
        nbins = max(min(shape) // 2, 1)
    packed = _scalar_corr(field, shape, int(nbins)).cpu().numpy().astype(np.float64)
    var, lines, counts, sums = _unpack_scalar_corr(packed, shape, int(nbins))
    scale = var if var > 0 else 1.0
    out: Dict[str, np.ndarray] = {
        "variance": var,
        "r_shell": np.arange(nbins, dtype=np.float64),
        "R_shell": np.where(counts > 0, sums / np.maximum(counts, 1), np.nan) / scale,
    }
    ls = tuple(float(L) for L in lengths) if lengths is not None else (1.0,) * nd
    for a, ax in enumerate("xyz"[:nd]):
        dx = ls[a] / shape[a]
        line = np.asarray(lines[a], dtype=np.float64)
        out[f"r_{ax}"] = np.arange(line.size, dtype=np.float64) * dx
        out[f"R_{ax}"] = line / scale
        out[f"integral_scale_{ax}"] = _integral_scale(line, dx)
    return out


def velocity_correlations(
    velx: torch.Tensor,
    vely: torch.Tensor,
    velz: Optional[torch.Tensor] = None,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Karman-Howarth longitudinal f(r) and transverse g(r) velocity
    correlations along each axis, with integral scales.

    For each axis a: ``f_<ax>`` is the normalised line correlation of the
    axis-parallel component u_a along a (longitudinal), ``g_<ax>`` the mean
    of the perpendicular components' line correlations along a
    (transverse); ``L11_<ax>`` / ``L22_<ax>`` their integral scales and
    ``isotropy_ratio_<ax>`` = L11 / (2 L22), exactly 1 for isotropic
    incompressible turbulence. No inverse volume transforms: the lines are
    1D inverses of the power marginals (module docstring).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, nd = _check_volume(vels[0], lengths, "velocity_correlations")
    if len(vels) != nd:
        raise ValueError(
            f"velocity_correlations: {nd}D flow needs {nd} components, got {len(vels)}"
        )
    for i, v in enumerate(vels[1:], start=1):
        if tuple(int(s) for s in v.shape) != shape:
            raise ValueError(
                f"velocity component {i} shape {tuple(v.shape)} does not match {shape}"
            )
    packed = _velocity_corr(vels, shape).cpu().numpy().astype(np.float64)
    lines = []
    off = 0
    for _ in range(nd):
        per_axis = []
        for n in shape:
            m = n // 2 + 1
            per_axis.append(packed[off : off + m])
            off += m
        lines.append(per_axis)
    return assemble_karman_howarth(lines, shape, lengths)


def assemble_karman_howarth(lines, shape, lengths) -> Dict[str, np.ndarray]:
    """lines[comp][axis] (raw half line correlations) -> the public
    f/g/L11/L22/isotropy record; one definition for the in-core and the
    streamed (ops/outofcore.py) paths."""
    nd = len(shape)
    ls = tuple(float(L) for L in lengths) if lengths is not None else (1.0,) * nd
    out: Dict[str, np.ndarray] = {}
    for a, ax in enumerate("xyz"[:nd]):
        dx = ls[a] / shape[a]
        f_line = np.asarray(lines[a][a], dtype=np.float64)
        f0 = f_line[0] if f_line[0] > 0 else 1.0
        g_lines = [
            np.asarray(lines[i][a], dtype=np.float64) for i in range(nd) if i != a
        ]
        g0s = [g[0] if g[0] > 0 else 1.0 for g in g_lines]
        g_norm = np.mean([g / g0 for g, g0 in zip(g_lines, g0s)], axis=0)
        out[f"r_{ax}"] = np.arange(f_line.size, dtype=np.float64) * dx
        out[f"f_{ax}"] = f_line / f0
        out[f"g_{ax}"] = g_norm
        out[f"L11_{ax}"] = _integral_scale(f_line, dx)
        l22 = _integral_scale(g_norm, dx)
        out[f"L22_{ax}"] = l22
        out[f"isotropy_ratio_{ax}"] = (
            out[f"L11_{ax}"] / (2.0 * l22) if l22 and np.isfinite(l22) else float("nan")
        )
    return out
