"""Real-space velocity-gradient statistics and the Q-R invariant PDF.

Counterpart of fava_tpu/ops/gradients.py. The gradients
g_ij = du_i/dx_j are 2nd-order central differences on the periodic wrap
(``torch.roll``; along x the slab's halo planes) (``boundary="interior"``:
the common interior, where
they need no wrap); ``lengths=None`` means the 2*pi-periodic unit box
(dx = 2*pi/n), else dx_j = L_j/n_j. The differences are taken in the
field dtype (float32 on the card) and every mean and moment in float64,
centred in two passes (means first, then (g - <g>)^p). The packed vector
keeps fava_tpu's entry order (``packed_names``), so the report assembly
is the same host function. The Q-R joint PDF bins the card's float32 Q
and R through the joint-histogram kernel (B8, ``cuda_kernels.pdf2d_counts``)
against float64 host edges scaled by Q_w.

The gradient statistics of a volume slab-sharded over a device mesh
(``mesh=``, ROADMAP A11d) are rank-local: each rank differentiates its
x-slab with one halo plane from each neighbour (``parallel.runtime.halo_x``),
one packed all_reduce joins the sums of pass 1 and one those of pass 2;
``boundary="interior"`` drops the global first and last x planes, on
ranks 0 and d-1 only. So does the Q-R PDF (A11e): the same halo plane,
Q and R on the slab, one packed all_reduce for Q_w, B8 on the slab and
one all_reduce of the counts.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.velocity import _check_vels
from fava_tpu_torch.parallel import runtime
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


def _gradient(u: torch.Tensor, j: int, dx: float, interior: bool, halo=None,
              x_cut: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """du/dx_j by a central difference in u's dtype (interior: the
    common interior of every axis). With ``halo``, ``u`` is an x-slab,
    its x neighbours the (below, above) halo planes, and its interior x
    rows ``x_cut`` = (first, end); else the periodic wrap of ``u``."""
    if halo is None:
        halo, x_cut = (u[-1:], u[:1]), (1, u.shape[0] - 1)
    if j == 0:
        ext = torch.cat([halo[0], u, halo[1]])
        d = (ext[2:] - ext[:-2]) / (2.0 * dx)
    else:
        d = (torch.roll(u, -1, dims=j) - torch.roll(u, 1, dims=j)) / (2.0 * dx)
    if interior:
        d = d[(slice(*x_cut),) + tuple(slice(1, -1) for _ in range(u.ndim - 1))]
    return d


def gradient_stats_device(vels: Sequence[torch.Tensor], lengths: Optional[Sequence[float]] = None,
                          boundary: str = "periodic", mesh=None) -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """Packed float64 central gradient-moment vector on the input's
    device (no host fetch) and its ``packed_names``; series drivers
    stack these and fetch once (:func:`assemble_gradient_stats`). With
    ``mesh``, ``vels`` are the rank's x-slabs of a 3D volume slab-sharded
    over the mesh's space axis (``gradient_stats_ranked``); every rank
    gets the whole volume's vector."""
    shape, key = _check_vels(vels, lengths, "velocity_gradient_statistics")
    ranks = runtime.SpaceRanks(mesh)
    if mesh is not None:
        if len(shape) != 3:
            raise ValueError("sharded gradient statistics need a 3D volume")
        shape = (shape[0] * ranks.d,) + shape[1:]
    _check_boundary(shape, boundary)
    return gradient_stats_ranked([list(vels)], ranks, key, boundary), packed_names(len(shape))


def gradient_stats_ranked(vel_slabs, ranks: runtime.SpaceRanks, lengths=None,
                          boundary: str = "periodic") -> torch.Tensor:
    """The packed vector of the volume whose x-slabs ``ranks`` plays (a
    list of velocity components each; the whole volumes on a single
    device). One halo plane on each side of each slab for the
    x-derivatives; pass 1 the float64 sums of every g_ij and u_i, one
    all_reduce; pass 2 the sums of the centred moments and cross terms,
    one all_reduce. ``boundary="interior"`` drops the first x plane of
    rank 0 and the last of rank d-1."""
    nd = len(vel_slabs[0])
    rows = int(vel_slabs[0][0].shape[0])
    shape = (rows * ranks.d,) + tuple(int(s) for s in vel_slabs[0][0].shape[1:])
    dx = _spacings(shape, lengths)
    interior = boundary == "interior"
    count = float(np.prod([n - 2 for n in shape] if interior else shape))
    adt = accum_dtype()
    halos = [ranks.halos([v[i] for v in vel_slabs]) for i in range(nd)]
    cuts = [(1 if interior and r == 0 else 0, rows - 1 if interior and r == ranks.d - 1 else rows)
            for r in ranks.ranks]
    # Pass 1: the gradients in float64 and their sums; pass 2: centre in
    # place and take the moments (every cross term over the same cells).
    grads, us, parts = [], [], []
    for k, vels in enumerate(vel_slabs):
        g = {}
        for i in range(nd):
            for j in range(nd):
                g[(i, j)] = _gradient(vels[i], j, dx[j], interior, halos[i][k], cuts[k]).to(adt)
        u = [v[(slice(*cuts[k]),) + tuple(slice(1, -1) for _ in range(nd - 1))] if interior else v
             for v in vels]
        u = [a.to(adt) for a in u]
        parts.append(torch.stack([g[(i, j)].sum() for i in range(nd) for j in range(nd)]
                                 + [a.sum() for a in u]))
        grads.append(g)
        us.append(u)
    sums = ranks.reduce(parts) / count
    means = {(i, j): sums[i * nd + j] for i in range(nd) for j in range(nd)}
    u_means = sums[nd * nd :]
    parts = []
    for g, u in zip(grads, us):
        acc = []
        for i in range(nd):
            for j in range(nd):
                f = g[(i, j)].sub_(means[(i, j)])
                f2 = f * f
                acc += [f2.sum(), (f2 * f).sum(), (f2 * f2).sum()]
                del f2
        acc += [(g[(a, b)] * g[(b, a)]).sum() for a, b in _ROT_PAIRS[nd]]
        acc += [(g[(i, i)] * g[(j, j)]).sum() for i, j in _DIV_PAIRS[nd]]
        acc += [(u[i] - u_means[i]).square().sum() for i in range(nd)]
        parts.append(torch.stack(acc))
    del grads, us
    mom = ranks.reduce(parts) / count
    out = []
    for i in range(nd):
        for j in range(nd):
            k = 3 * (i * nd + j)
            out += [means[(i, j)], mom[k], mom[k + 1], mom[k + 2]]
    k = 3 * nd * nd
    extra = len(_ROT_PAIRS[nd]) + len(_DIV_PAIRS[nd])
    out += list(mom[k : k + extra])
    for i in range(nd):
        out += [u_means[i], mom[k + extra + i]]
    return torch.stack(out)


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


def velocity_gradient_statistics(velx, vely, velz=None, lengths=None, boundary: str = "periodic",
                                 mesh=None) -> Dict[str, np.ndarray | float]:
    """Velocity-gradient tensor statistics: the (nd, nd) mean and central
    moment tables of g_ij to fourth order, the longitudinal skewness and
    flatness per axis and their means, the transverse flatness, the
    pseudo-dissipation <|grad u'|^2>, the enstrophy <|omega'|^2> and
    <(div u')^2> from the same operator, the longitudinal Taylor
    microscales and the velocity means and variances, all float64 on the
    host. ``boundary="periodic"`` wraps; ``"interior"`` averages over the
    common interior (windowed extracts such as the pipeline's flame
    windows). ``mesh`` as in :func:`gradient_stats_device`."""
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    vec, _ = gradient_stats_device(vels, lengths=lengths, boundary=boundary, mesh=mesh)
    return assemble_gradient_stats(vec.cpu().numpy(), len(vels))


def _invariants(vels, spacings, interior: bool, halos=None, x_cut=None):
    """Q, R (the field dtype) and the float64 sum of omega^2 of a volume,
    or with ``halos`` (one (below, above) pair a component) and ``x_cut``
    of an x-slab (``_gradient``), over the cells the boundary keeps."""
    halos = halos or [None] * 3
    g = [[_gradient(vels[i], j, spacings[j], interior, halos[i], x_cut) for j in range(3)]
         for i in range(3)]
    P = -(g[0][0] + g[1][1] + g[2][2])
    trA2 = sum(g[i][j] * g[j][i] for i in range(3) for j in range(3))
    Q = 0.5 * (P * P - trA2)
    del P, trA2
    R = -(g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[2][1])
          - g[0][1] * (g[1][0] * g[2][2] - g[1][2] * g[2][0])
          + g[0][2] * (g[1][0] * g[2][1] - g[1][1] * g[2][0]))
    w2 = (g[2][1] - g[1][2]).square() + (g[0][2] - g[2][0]).square() + (g[1][0] - g[0][1]).square()
    return Q, R, w2.to(accum_dtype()).sum()


def invariant_fields(vels, spacings, boundary: str):
    """Per-cell invariants of A_ij = du_i/dx_j (lambda^3 + P lambda^2 +
    Q lambda + R = 0): Q = (P^2 - tr(A^2))/2 and R = -det(A), P = -tr(A),
    in the field dtype, and Q_w = <omega^2>/4 as a float64 0-d tensor."""
    Q, R, w2 = _invariants(vels, spacings, boundary == "interior")
    return Q, R, w2 / Q.numel() / 4.0


def gradient_invariant_pdfs(velx, vely, velz, lengths=None, nbins=(100, 100), qr_range: float = 8.0,
                            boundary: str = "periodic", mesh=None) -> Dict[str, np.ndarray | float]:
    """Joint PDF of the velocity-gradient invariants (Q, R), the
    Chong-Perry-Cantwell map. 3D only. The full compressible definitions
    (:func:`invariant_fields`), binned over Q/Q_w and R/Q_w^{3/2} in
    [-qr_range, qr_range], Q_w = <omega^2>/4 (clamped at 1e-20) from the
    same differences; exact np.histogram2d counts (cells beyond the range
    dropped). Returns ``q_edges``/``r_edges`` (normalised units),
    ``counts``, ``pdf`` (integrates to ``inside_fraction``), ``q_w`` and
    ``inside_fraction``. With ``mesh`` the velocities are the rank's
    x-slabs of a volume slab-sharded over the mesh's space axis
    (:func:`gradient_invariant_pdfs_ranked`); every rank gets the whole
    volume's PDF."""
    vels = (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "gradient_invariant_pdfs")
    if len(shape) != 3:
        raise ValueError("gradient invariants need a 3D velocity field (3x3 tensor)")
    ranks = runtime.SpaceRanks(mesh)
    _check_boundary((shape[0] * ranks.d,) + shape[1:], boundary)
    return gradient_invariant_pdfs_ranked([list(vels)], ranks, key, nbins, qr_range, boundary)


def gradient_invariant_pdfs_ranked(vel_slabs, ranks: runtime.SpaceRanks, lengths=None,
                                   nbins=(100, 100), qr_range: float = 8.0,
                                   boundary: str = "periodic") -> Dict[str, np.ndarray | float]:
    """The Q-R PDF of the volume whose x-slabs ``ranks`` plays (a list of
    the three velocity components each; the whole volumes on a single
    device): one halo plane on each side of each slab, Q and R on the
    slab (``boundary="interior"`` drops the global first and last x
    planes only, as :func:`gradient_stats_ranked`), the sums of omega^2
    by one packed SUM (Q_w), then B8 on each slab against the edges Q_w
    scales and one SUM of the counts.

    Q_w is a float64 mean whose sum follows the slabs, so its last place,
    and with it the edges' (the edges scale with Q_w), may differ from
    another decomposition's: a sample within that rounding of an edge
    may fall in the neighbouring bin of another decomposition's PDF.
    Every other sample is counted in the same bin."""
    if isinstance(nbins, int):
        nbins = (nbins, nbins)
    nbx, nby = int(nbins[0]), int(nbins[1])
    if min(nbx, nby) < 2:
        raise ValueError(f"gradient_invariant_pdfs needs nbins >= 2 per axis, got {nbins}")
    rows = int(vel_slabs[0][0].shape[0])
    shape = (rows * ranks.d,) + tuple(int(s) for s in vel_slabs[0][0].shape[1:])
    interior = boundary == "interior"
    spacings = _spacings(shape, lengths)
    halos = [ranks.halos([v[i] for v in vel_slabs]) for i in range(3)]
    cuts = [(1 if interior and r == 0 else 0, rows - 1 if interior and r == ranks.d - 1 else rows)
            for r in ranks.ranks]
    qr, parts = [], []
    for k, vels in enumerate(vel_slabs):
        Q, R, w2 = _invariants(vels, spacings, interior, [h[k] for h in halos], cuts[k])
        qr.append((Q.contiguous().reshape(-1), R.contiguous().reshape(-1)))
        parts.append(w2[None])
        del Q, R
    ntot = float(np.prod([s - 2 for s in shape] if interior else shape))
    qw = float(ranks.reduce(parts)[0]) / ntot / 4.0
    r = float(qr_range)
    qs = max(qw, QW_FLOOR)
    rs = qs * np.sqrt(qs)
    xe = np.linspace(-r * qs, r * qs, nbx + 1)
    ye = np.linspace(-r * rs, r * rs, nby + 1)
    counts = ranks.reduce([cuda_kernels.pdf2d_counts(q, rr, xe, ye) for q, rr in qr])
    counts = counts.cpu().numpy().astype(np.float64)
    # The edges are reported in normalised units.
    q_edges = np.linspace(-r, r, nbx + 1)
    r_edges = np.linspace(-r, r, nby + 1)
    areas = np.diff(q_edges)[:, None] * np.diff(r_edges)[None, :]
    return {
        "q_edges": q_edges,
        "r_edges": r_edges,
        "counts": counts,
        "pdf": counts / (ntot * areas),
        "q_w": qw,
        "inside_fraction": float(counts.sum() / ntot),
    }
