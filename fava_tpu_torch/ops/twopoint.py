"""Real-space two-point correlation functions (Wiener-Khinchin).

Counterpart of fava_tpu/ops/twopoint.py. R(r) = <f'(x) f'(x+r)> on the
periodic box is the inverse transform of the power spectrum: the
normalized forward transform of the centred field, |f̂|^2 in the field
dtype, and for the scalar case one inverse volume transform whose
trailing-axis half is shell-averaged over |r|. Real-space separations
wrap as min(j, n - j), the geometry of the k-shells, and R(r) = R(-r),
so the Hermitian-weighted binning of the half volume is the full-volume
shell mean.

Axis lines never need the correlation volume: the line R(r e_a) is the
1D inverse transform of the power marginal summed over the other axes
(the phase involves k_a only), and the Hermitian-weighted half-grid
plane sum equals the full-spectrum marginal once every other axis is
summed. The marginals and the variance are float64 sums.

Every analysis here runs one body over the x-slabs that a
``parallel.SpaceRanks`` plays (``*_ranked``): on a single device the
whole volume (``SpaceRanks()``), and under a device mesh (``mesh=``,
ROADMAP A11f.1) the rank's x-slab of a 3D volume slab-sharded over its
space axis. The means are one packed SUM; the power is formed on each
rank's y-slab of the pencil transform (``ranks.pencil_rfft``), whose
marginals along x and z are partial sums and along y the slab's own
columns (placed in a zero vector); the shell sums and every marginal
then join in ONE packed SUM, and the variance is the joined trailing
marginal's Hermitian-weighted sum. The scalar shell curve bins
each rank's x-slab of the correlation volume (``ranks.pencil_irfft`` of
the power), cut to its trailing half, with the one-channel B6 at the
slab's row offset, against the static counts; the single device keeps
the port's scalar shell binning (``velocity._bin_rfft_stats``: K3 + the
single-channel walk for even x and y extents, B10 otherwise; float32
values on the card, float64 sums). The out-of-core analyses
(``ops/outofcore.py``) end in the same host assembly
(``assemble_karman_howarth``, ``_integral_scale``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.spectra import static_shell_counts
from fava_tpu_torch.ops.velocity import (
    _abs2,
    _bin_rfft_stats,
    _hermitian_weights,
    _mesh_ranks,
    _ranked_shape,
    _slab_cols,
)
from fava_tpu_torch.utils import accum_dtype


def _means(slabs, ranks, ntot: int) -> torch.Tensor:
    """float64 means of each field of the volume whose x-slabs ``ranks``
    plays (a list of the fields of each slab): one packed SUM."""
    adt = accum_dtype()
    return ranks.reduce([torch.stack([f.to(adt).sum() for f in fields]) for fields in slabs]) / ntot


def _marginal_parts(p: torch.Tensor, full_shape: Tuple[int, ...], cols) -> torch.Tensor:
    """The packed float64 power marginals of one y-slab ``p`` of a
    half-grid power (its columns ``cols`` of a 3D volume, ``_slab_cols``;
    the whole half grid in 2D), along each axis in turn: along the
    trailing axis the sum over the others on the half grid (the 1D irfft
    applies the conjugate-pair weighting itself); along every other axis
    the Hermitian-weighted sum over the others at signed k_axis, the
    y-slab's columns in place in a zero vector along y. The slabs' parts
    add up to the whole volume's."""
    nd = len(full_shape)
    adt = accum_dtype()
    pw = p.to(adt) * _hermitian_weights(full_shape, adt, p.device)
    out = []
    for axis, n in enumerate(full_shape):
        if axis == nd - 1:
            out.append(p.sum(dim=tuple(range(nd - 1)), dtype=adt))
            continue
        m = pw.sum(dim=tuple(a for a in range(nd) if a != axis))
        if axis == 1 and cols is not None:
            whole = torch.zeros(n, dtype=adt, device=p.device)
            whole[cols[0] : cols[0] + cols[1]] = m
            m = whole
        out.append(m)
    return torch.cat(out)


def _lines(marg: torch.Tensor, full_shape: Tuple[int, ...]) -> List[torch.Tensor]:
    """The raw half lines <f'(x) f'(x + r e_a)> along each axis from the
    joined marginals of the normalized power (``_marginal_parts``). The
    weight-2 half-grid sum at +k counts the conjugate modes that live at
    -k (the mirror is (-kx, -ky, -kz)): S(k) + S(-k) = 2 M(k), so the
    true (even) marginal of a leading axis is the symmetrisation; the 1D
    irfft carries 1/n, so n times it is the line (line[0] the variance)."""
    nd = len(full_shape)
    lines, off = [], 0
    for axis, n in enumerate(full_shape):
        m = n // 2 + 1 if axis == nd - 1 else n
        seg = marg[off : off + m]
        off += m
        if axis != nd - 1:
            seg = (0.5 * (seg + torch.roll(torch.flip(seg, (0,)), 1)))[: n // 2 + 1]
        lines.append(torch.fft.irfft(seg, n=n)[: n // 2 + 1] * float(n))
    return lines


def _scalar_corr(slabs, ranks, nbins: int) -> torch.Tensor:
    """[variance, shell counts, shell sums, the per-axis half lines] of
    the field whose x-slabs ``ranks`` plays, as ONE packed float64
    vector (one host fetch): one SUM of the mean, the pencil transform of
    the centred slabs, the marginals of each y-slab's power, its inverse
    pencil transform (each rank's x-slab of the correlation volume) cut
    to the trailing half and binned (the module docstring), and ONE SUM
    of the sums and marginals. The variance is the Hermitian-weighted sum
    of the joined trailing-axis marginal (Parseval)."""
    adt = accum_dtype()
    shape = _ranked_shape([[f] for f in slabs], ranks)
    ntot = int(np.prod(shape))
    mean = _means([[f] for f in slabs], ranks, ntot)[0]
    p = [_abs2(h) for h in ranks.pencil_rfft([f - mean.to(f.dtype) for f in slabs])]
    marg = [_marginal_parts(q, shape, c) for q, c in zip(p, _slab_cols(shape, ranks))]
    corr = ranks.pencil_irfft(p, shape)
    del p
    half = [c[..., : shape[-1] // 2 + 1] for c in corr]
    if ranks.mesh is None and ranks.d == 1:
        counts, sums = _bin_rfft_stats(half[0], shape, nbins)
        sums = [sums]
    else:
        rows = shape[0] // ranks.d
        sums = [cuda_kernels.shell_bin_values_rfft_chunk(h.contiguous(), None, nbins,
                                                          full_nx=shape[0], full_nz=shape[2],
                                                          kx0=r * rows)[0]
                for h, r in zip(half, ranks.ranks)]
        counts = static_shell_counts(shape, nbins, sums[0].device)
    del corr, half
    packed = ranks.reduce([torch.cat([s, m]) for s, m in zip(sums, marg)])
    hw = _hermitian_weights(shape, adt, packed.device).reshape(-1)
    var = (packed[-hw.numel() :] * hw).sum()
    lines = _lines(packed[nbins:], shape)
    return torch.cat([var[None], counts.to(adt), packed[:nbins]] + lines)


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


def _velocity_corr(vel_slabs, ranks) -> torch.Tensor:
    """Raw half lines <u_i'(x) u_i'(x + r e_a)> of every component along
    every axis, packed comp-major, axis-minor, float64, of the flow whose
    x-slabs ``ranks`` plays (a list of the components each): one SUM of
    the three means, the pencil transform of each centred component, the
    marginals of its power on each y-slab, ONE SUM of all of them, and
    the 1D inverse transforms."""
    shape = _ranked_shape(vel_slabs, ranks)
    nd = len(shape)
    means = _means(vel_slabs, ranks, int(np.prod(shape)))
    cols = _slab_cols(shape, ranks)
    parts: List[List[torch.Tensor]] = [[] for _ in cols]
    for c in range(nd):
        hats = ranks.pencil_rfft([s[c] - means[c].to(s[c].dtype) for s in vel_slabs])
        for part, h, col in zip(parts, hats, cols):
            part.append(_marginal_parts(_abs2(h), shape, col))
        del hats
    marg = ranks.reduce([torch.cat(part) for part in parts])
    per = int(marg.shape[0]) // nd
    return torch.cat([line for c in range(nd)
                      for line in _lines(marg[c * per : (c + 1) * per], shape)])


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


def _check_volume(shape, lengths, what: str):
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"{what} requires a 2D or 3D volume, got {nd}D")
    if lengths is not None and len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    return nd


def two_point_correlation(
    field: torch.Tensor,
    lengths: Optional[Sequence[float]] = None,
    nbins: Optional[int] = None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Scalar two-point autocorrelation R(r) = <f'(x) f'(x+r)> / var f.

    Returns the shell-averaged isotropic curve (``r_shell`` in CELL units:
    shell radii mix axes, so physical units only make sense for cubic
    cells) plus per-axis line correlations ``R_<ax>`` over physical
    separations ``r_<ax>`` (box ``lengths``; unit box default) and their
    integral length scales ``integral_scale_<ax>`` (trapezoid to the first
    zero crossing). ``variance`` is <f'^2>. ``nbins`` defaults to
    max(min(shape)//2, 1). With ``mesh`` the field is the rank's x-slab
    of a 3D volume slab-sharded over the mesh's space axis
    (:func:`two_point_correlation_ranked`); every rank gets the whole
    volume's result.
    """
    _check_volume(tuple(field.shape), lengths, "two_point_correlation")
    ranks = _mesh_ranks(tuple(field.shape), "two-point correlation", mesh)
    return two_point_correlation_ranked([field], ranks, lengths, nbins)


def two_point_correlation_ranked(slabs, ranks, lengths=None,
                                 nbins: Optional[int] = None) -> Dict[str, np.ndarray]:
    """:func:`two_point_correlation` of the field whose x-slabs ``ranks``
    plays (``_scalar_corr``)."""
    shape = _ranked_shape([[f] for f in slabs], ranks)
    nd = len(shape)
    if nbins is None:
        nbins = max(min(shape) // 2, 1)
    packed = _scalar_corr(slabs, ranks, int(nbins)).cpu().numpy().astype(np.float64)
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
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Karman-Howarth longitudinal f(r) and transverse g(r) velocity
    correlations along each axis, with integral scales.

    For each axis a: ``f_<ax>`` is the normalised line correlation of the
    axis-parallel component u_a along a (longitudinal), ``g_<ax>`` the mean
    of the perpendicular components' line correlations along a
    (transverse); ``L11_<ax>`` / ``L22_<ax>`` their integral scales and
    ``isotropy_ratio_<ax>`` = L11 / (2 L22), exactly 1 for isotropic
    incompressible turbulence. No inverse volume transforms: the lines are
    1D inverses of the power marginals (module docstring). With ``mesh``
    the components are the rank's x-slabs of a 3D volume slab-sharded
    over the mesh's space axis (:func:`velocity_correlations_ranked`).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape = tuple(int(s) for s in vels[0].shape)
    nd = _check_volume(shape, lengths, "velocity_correlations")
    if len(vels) != nd:
        raise ValueError(
            f"velocity_correlations: {nd}D flow needs {nd} components, got {len(vels)}"
        )
    for i, v in enumerate(vels[1:], start=1):
        if tuple(int(s) for s in v.shape) != shape:
            raise ValueError(
                f"velocity component {i} shape {tuple(v.shape)} does not match {shape}"
            )
    ranks = _mesh_ranks(shape, "velocity correlations", mesh)
    return velocity_correlations_ranked([list(vels)], ranks, lengths)


def velocity_correlations_ranked(vel_slabs, ranks, lengths=None) -> Dict[str, np.ndarray]:
    """:func:`velocity_correlations` of the flow whose x-slabs ``ranks``
    plays (a list of the components each; ``_velocity_corr``)."""
    shape = _ranked_shape(vel_slabs, ranks)
    packed = _velocity_corr(vel_slabs, ranks).cpu().numpy().astype(np.float64)
    lines = []
    off = 0
    for _ in shape:
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
