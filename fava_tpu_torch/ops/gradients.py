"""Real-space velocity-gradient statistics and the Q-R invariant PDF.

Counterpart of fava_tpu/ops/gradients.py, single device. The gradients
g_ij = du_i/dx_j are 2nd-order central differences by ``torch.roll`` on
the periodic wrap (``boundary="interior"``: the common interior, where
they need no wrap); ``lengths=None`` means the 2*pi-periodic unit box
(dx = 2*pi/n), else dx_j = L_j/n_j. The differences are taken in the
field dtype (float32 on the card) and every mean and moment in float64,
centred in two passes (means first, then (g - <g>)^p). The packed vector
keeps fava_tpu's entry order (``packed_names``), so the report assembly
is the same host function. The Q-R joint PDF bins the card's float32 Q
and R through the joint-histogram kernel (B8, ``cuda_kernels.pdf2d_counts``)
against float64 host edges scaled by Q_w.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.velocity import _check_vels
from fava_tpu_torch.utils import accum_dtype

_BOUNDARIES = ("periodic", "interior")
# Rotation cross-term pairs: cov(g_ab, g_ba) in the order of the vorticity
# components (3D: omega_x, omega_y, omega_z; 2D: omega_z).
_ROT_PAIRS = {3: ((2, 1), (0, 2), (1, 0)), 2: ((1, 0),)}
# Divergence cross terms cov(g_ii, g_jj), i < j.
_DIV_PAIRS = {3: ((0, 1), (0, 2), (1, 2)), 2: ((0, 1),)}
QW_FLOOR = 1e-20  # fava_tpu's clamp of Q_w before it scales the edges


def _spacings(shape: Tuple[int, ...], lengths) -> Tuple[float, ...]:
    if lengths is None:
        return tuple(2.0 * np.pi / n for n in shape)
    return tuple(float(L) / n for L, n in zip(lengths, shape))


def packed_names(nd: int) -> Tuple[str, ...]:
    """Entry order of the packed vector (central volume means)."""
    names = []
    for i in range(nd):
        for j in range(nd):
            names += [f"g{i}{j}_mean"] + [f"g{i}{j}_c{p}" for p in (2, 3, 4)]
    names += [f"rot_cov_g{a}{b}_g{b}{a}" for a, b in _ROT_PAIRS[nd]]
    names += [f"div_cov_g{i}{i}_g{j}{j}" for i, j in _DIV_PAIRS[nd]]
    for i in range(nd):
        names += [f"u{i}_mean", f"u{i}_var"]
    return tuple(names)


def _check_boundary(shape, boundary: str) -> None:
    if boundary not in _BOUNDARIES:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}, got {boundary!r}")
    if boundary == "interior" and min(shape) < 3:
        raise ValueError("interior gradients need at least 3 cells per axis")


def _gradient(u: torch.Tensor, j: int, dx: float, interior: bool) -> torch.Tensor:
    """du/dx_j by a central difference in u's dtype (interior: the
    common interior of every axis)."""
    d = (torch.roll(u, -1, dims=j) - torch.roll(u, 1, dims=j)) / (2.0 * dx)
    if interior:
        d = d[tuple(slice(1, -1) for _ in range(u.ndim))]
    return d


def gradient_stats_device(vels: Sequence[torch.Tensor], lengths: Optional[Sequence[float]] = None,
                          boundary: str = "periodic") -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """Packed float64 central gradient-moment vector on the input's
    device (no host fetch) and its ``packed_names``; series drivers
    stack these and fetch once (:func:`assemble_gradient_stats`)."""
    shape, key = _check_vels(vels, lengths, "velocity_gradient_statistics")
    _check_boundary(shape, boundary)
    nd = len(shape)
    dx = _spacings(shape, key)
    interior = boundary == "interior"
    adt = accum_dtype()
    # Pass 1: the gradients in float64 and their means; pass 2: centre in
    # place and take the moments (every cross term over the same cells).
    fl = {}
    means = {}
    for i in range(nd):
        for j in range(nd):
            g = _gradient(vels[i], j, dx[j], interior).to(adt)
            means[(i, j)] = g.mean()
            fl[(i, j)] = g.sub_(means[(i, j)])
    acc = []
    for i in range(nd):
        for j in range(nd):
            f = fl[(i, j)]
            f2 = f * f
            acc += [means[(i, j)], f2.mean(), (f2 * f).mean(), (f2 * f2).mean()]
            del f2
    acc += [(fl[(a, b)] * fl[(b, a)]).mean() for a, b in _ROT_PAIRS[nd]]
    acc += [(fl[(i, i)] * fl[(j, j)]).mean() for i, j in _DIV_PAIRS[nd]]
    del fl
    for i in range(nd):
        u = vels[i]
        if interior:
            u = u[tuple(slice(1, -1) for _ in range(nd))]
        ua = u.to(adt)
        um = ua.mean()
        acc += [um, (ua - um).square().mean()]
    return torch.stack(acc), packed_names(nd)


def assemble_gradient_stats(vec, nd: int) -> Dict[str, np.ndarray | float]:
    """Packed central means -> the gradient-statistics report (float64)."""
    v = np.asarray(vec, dtype=np.float64)
    k = 0
    m1, c2, c3, c4 = (np.empty((nd, nd)) for _ in range(4))
    for i in range(nd):
        for j in range(nd):
            m1[i, j], c2[i, j], c3[i, j], c4[i, j] = v[k : k + 4]
            k += 4
    rot = {p: v[k + n] for n, p in enumerate(_ROT_PAIRS[nd])}
    k += len(_ROT_PAIRS[nd])
    div = {p: v[k + n] for n, p in enumerate(_DIV_PAIRS[nd])}
    k += len(_DIV_PAIRS[nd])
    u_mean = np.array([v[k + 2 * i] for i in range(nd)])
    u_var = np.array([v[k + 2 * i + 1] for i in range(nd)])

    def ratio(num, den):
        return np.where(den > 0.0, num / np.maximum(den, 1e-300), 0.0)

    skew = ratio(c3, c2**1.5)
    flat = ratio(c4, c2**2)
    long_skew = np.diagonal(skew).copy()
    long_flat = np.diagonal(flat).copy()
    off = ~np.eye(nd, dtype=bool)
    # Fluctuation enstrophy: each vorticity component is g_ab - g_ba.
    enstrophy = sum(c2[a, b] + c2[b, a] - 2.0 * rot[(a, b)] for a, b in _ROT_PAIRS[nd])
    # <(div u')^2> = sum_i c2_ii + 2 sum_{i<j} cov(g_ii, g_jj).
    dilatation_msq = float(np.sum(np.diagonal(c2))) + 2.0 * sum(div[p] for p in _DIV_PAIRS[nd])
    taylor = np.sqrt(ratio(u_var, np.diagonal(c2)))
    return {
        "gradient_mean": m1,
        "gradient_moment2": c2,
        "gradient_moment3": c3,
        "gradient_moment4": c4,
        "longitudinal_skewness": long_skew,
        "derivative_skewness": float(long_skew.mean()),
        "longitudinal_flatness": long_flat,
        "derivative_flatness": float(long_flat.mean()),
        "transverse_flatness": float(flat[off].mean()) if nd > 1 else 0.0,
        "pseudo_dissipation": float(np.sum(c2)),
        "enstrophy": float(enstrophy),
        "dilatation_msq": float(dilatation_msq),
        "velocity_mean": u_mean,
        "velocity_variance": u_var,
        "taylor_microscale": taylor,
        "taylor_microscale_mean": float(taylor.mean()),
    }


def velocity_gradient_statistics(velx, vely, velz=None, lengths=None,
                                 boundary: str = "periodic") -> Dict[str, np.ndarray | float]:
    """Velocity-gradient tensor statistics: the (nd, nd) mean and central
    moment tables of g_ij to fourth order, the longitudinal skewness and
    flatness per axis and their means, the transverse flatness, the
    pseudo-dissipation <|grad u'|^2>, the enstrophy <|omega'|^2> and
    <(div u')^2> from the same operator, the longitudinal Taylor
    microscales and the velocity means and variances, all float64 on the
    host. ``boundary="periodic"`` wraps; ``"interior"`` averages over the
    common interior (windowed extracts such as the pipeline's flame
    windows)."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    vec, _ = gradient_stats_device(vels, lengths=lengths, boundary=boundary)
    return assemble_gradient_stats(vec.cpu().numpy(), len(vels))


def invariant_fields(vels, spacings, boundary: str):
    """Per-cell invariants of A_ij = du_i/dx_j (lambda^3 + P lambda^2 +
    Q lambda + R = 0): Q = (P^2 - tr(A^2))/2 and R = -det(A), P = -tr(A),
    in the field dtype, and Q_w = <omega^2>/4 as a float64 0-d tensor."""
    interior = boundary == "interior"
    g = [[_gradient(vels[i], j, spacings[j], interior) for j in range(3)] for i in range(3)]
    P = -(g[0][0] + g[1][1] + g[2][2])
    trA2 = sum(g[i][j] * g[j][i] for i in range(3) for j in range(3))
    Q = 0.5 * (P * P - trA2)
    del P, trA2
    R = -(g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[2][1])
          - g[0][1] * (g[1][0] * g[2][2] - g[1][2] * g[2][0])
          + g[0][2] * (g[1][0] * g[2][1] - g[1][1] * g[2][0]))
    w2 = (g[2][1] - g[1][2]).square() + (g[0][2] - g[2][0]).square() + (g[1][0] - g[0][1]).square()
    qw = w2.to(accum_dtype()).mean() / 4.0
    return Q, R, qw


def gradient_invariant_pdfs(velx, vely, velz, lengths=None, nbins=(100, 100), qr_range: float = 8.0,
                            boundary: str = "periodic") -> Dict[str, np.ndarray | float]:
    """Joint PDF of the velocity-gradient invariants (Q, R), the
    Chong-Perry-Cantwell map. 3D only. The full compressible definitions
    (:func:`invariant_fields`), binned over Q/Q_w and R/Q_w^{3/2} in
    [-qr_range, qr_range], Q_w = <omega^2>/4 (clamped at 1e-20) from the
    same differences; exact np.histogram2d counts (cells beyond the range
    dropped). Returns ``q_edges``/``r_edges`` (normalised units),
    ``counts``, ``pdf`` (integrates to ``inside_fraction``), ``q_w`` and
    ``inside_fraction``."""
    vels = (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "gradient_invariant_pdfs")
    if len(shape) != 3:
        raise ValueError("gradient invariants need a 3D velocity field (3x3 tensor)")
    _check_boundary(shape, boundary)
    if isinstance(nbins, int):
        nbins = (nbins, nbins)
    nbx, nby = int(nbins[0]), int(nbins[1])
    if min(nbx, nby) < 2:
        raise ValueError(f"gradient_invariant_pdfs needs nbins >= 2 per axis, got {nbins}")
    r = float(qr_range)
    Q, R, qw_t = invariant_fields(vels, _spacings(shape, key), boundary)
    qw = float(qw_t)
    qs = max(qw, QW_FLOOR)
    rs = qs * np.sqrt(qs)
    xe = np.linspace(-r * qs, r * qs, nbx + 1)
    ye = np.linspace(-r * rs, r * rs, nby + 1)
    counts = cuda_kernels.pdf2d_counts(Q.contiguous().reshape(-1), R.contiguous().reshape(-1), xe, ye)
    counts = counts.cpu().numpy().astype(np.float64)
    # The edges are reported in normalised units.
    q_edges = np.linspace(-r, r, nbx + 1)
    r_edges = np.linspace(-r, r, nby + 1)
    ntot = float(np.prod([s - 2 for s in shape] if boundary == "interior" else shape))
    areas = np.diff(q_edges)[:, None] * np.diff(r_edges)[None, :]
    return {
        "q_edges": q_edges,
        "r_edges": r_edges,
        "counts": counts,
        "pdf": counts / (ntot * areas),
        "q_w": qw,
        "inside_fraction": float(counts.sum() / ntot),
    }
