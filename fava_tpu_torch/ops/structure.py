"""Velocity structure functions, increment PDFs and scaling exponents on a
uniform grid.

Counterpart of fava_tpu/ops/structure.py (reference:
fava/mesh/FLASH/FlashUniform.py:306-447), plain torch: fava_tpu leaves
it to XLA. Every (order, separation, point) sample comes from the
port's Threefry (utils/prng.py), word for word fava_tpu's, so both
packages draw the same point pairs. Stream layout: order ``o`` uses
streams ``(o-1)*3 + {0,1,2}`` for (position, phi, theta); the
shared-sample mode streams 0-2 (order 1's draw); the increment PDFs
base ``1 << 17``.

Semantics kept exactly: isotropic directions from (phi, acos) angles;
the periodic wrap of the second point (floor-mod); the nearest cell by
floor((p - lo)/dx); the structure functions' longitudinal |dv . rhat|
with rhat from the *wrapped* separation and transverse |dv - |dv.rhat|
rhat|; the increment PDFs' signed projections on the *pre-wrap* draw
direction.

Deviation from fava_tpu: it draws in the fields' dtype (float32 on the
TPU, which has no float64) and sums in two-float words. Here the draws,
the increments (the gathered values widened before they are subtracted),
the moments and the sums are float64 on every device, and the counts
int64: the card samples the cells the float64 reference samples, up to
an ulp-level tie of a transcendental at a cell boundary.

``pair_structure_functions`` (tracer particles, fava_tpu/ops/structure.py
:565-729) draws its pairs from stream ``_PAIR_STREAM`` of the same
Threefry, so both packages pair the same particles. Deviation: fava_tpu
decides bin membership in two-float words against split squared edges
(float32 on the TPU). Here separations, the periodic minimum image, r^2,
the bin decisions and the moment sums are float64 on the device, so the
counts are those of the float64 oracle by construction.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.ops import volume
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype, prng, resolve_device

# Increment-PDF sampling owns stream base 1<<17: structure-function orders
# use streams 0..29 and the particle pair sampler 1<<16, so the analyses
# never reuse Threefry words under a shared seed.
_INC_STREAM = 1 << 17


def _separations(sep_bounds, num_seps: int, log_scale: bool, cell_size, width) -> np.ndarray:
    """The separations: by default (smallest cell, half the narrowest
    width), the resolvable range (the reference's default (0, 1) crashes
    its own geomspace)."""
    if sep_bounds is None:
        sep_bounds = (float(cell_size.min()), float(width.min()) / 2.0)
    if log_scale and sep_bounds[0] <= 0.0:
        raise ValueError(
            f"sep_bounds lower bound must be positive with log_scale=True, got {sep_bounds[0]}"
        )
    if log_scale:
        return np.geomspace(sep_bounds[0], sep_bounds[1], num_seps)
    return np.linspace(sep_bounds[0], sep_bounds[1], num_seps)


def _geometry(vels, domain_bounds, vol_shape=None):
    """(ndim, volume shape, lo, width, cell size): the domain's float64
    host arrays over the fields' ndim axes (of a volume of ``vol_shape``
    when given: ``vels`` are then x-slabs of it)."""
    ndim = len(vels)
    vol_shape = tuple(int(s) for s in (vels[0].shape if vol_shape is None else vol_shape))
    bounds = np.asarray(domain_bounds, dtype=np.float64)
    lo = bounds[:ndim, 0]
    width = bounds[:ndim, 1] - bounds[:ndim, 0]
    return ndim, vol_shape, lo, width, width / np.asarray(vol_shape[:ndim], dtype=np.float64)


def _draw_pairs(separations, lo, width, cell_size, vol_shape, seed, base, num_points: int,
                dtype, device):
    """One (num_seps, num_points) pair draw from streams base..base+2:
    ``(p1, p2, direction, i1, i2)`` — the first endpoints, the wrapped
    second ones, the draw directions (unit in 3D; in 2D the truncated
    3-sphere draw, norm sin(theta)) and both endpoints' int64 cells, in
    ``dtype`` on ``device`` (fava_tpu's draw in that dtype, formula for
    formula)."""
    ndim = len(lo)
    num_seps = len(separations)
    shape = (num_seps, num_points)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    lo_t, width_t, cell_t = t(lo), t(width), t(cell_size)
    p1 = lo_t + prng.uniform(seed, base, shape + (ndim,), dtype, device) * width_t
    phi = 2.0 * np.pi * prng.uniform(seed, base + 1, shape, dtype, device)
    theta = torch.arccos(2.0 * prng.uniform(seed, base + 2, shape, dtype, device) - 1.0)
    direction = torch.stack(
        [torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )[..., :ndim]
    p2 = p1 + t(separations)[:, None, None] * direction
    p2 = lo_t + torch.remainder(p2 - lo_t, width_t)  # the periodic wrap: floor-mod
    top = torch.as_tensor(vol_shape[:ndim], device=device) - 1

    def cell_index(p):
        idx = torch.floor((p - lo_t) / cell_t).to(torch.int64)
        return torch.clamp(idx, min=torch.zeros_like(top), max=top)

    return p1, p2, direction, cell_index(p1), cell_index(p2)


def _sample(vol: torch.Tensor, idx: torch.Tensor, ndim: int) -> torch.Tensor:
    """The cells ``idx`` (..., ndim) of ``vol``: a flat int32 gather in 3D
    below 2^31 cells, the tuple gather above and in 2D."""
    shape = vol.shape
    if ndim == 3 and vol.numel() < 2**31:
        flat = ((idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]).to(torch.int32)
        return vol.reshape(-1)[flat]
    return vol[tuple(idx[..., a] for a in range(ndim))]


def _sample_rows(slab: torch.Tensor, idx: torch.Tensor, lo: int, ndim: int) -> torch.Tensor:
    """``_sample`` of the rank's x-slab of rows lo .. lo+rows-1: the cells
    ``idx`` whose x lies in its rows, zero for every other."""
    rows = int(slab.shape[0])
    x = idx[..., 0] - lo
    inside = (x >= 0) & (x < rows)
    local = torch.cat([x.clamp(0, rows - 1)[..., None], idx[..., 1:]], dim=-1)
    return torch.where(inside, _sample(slab, local, ndim), 0)


def _sampler(vel_slabs, ranks):
    """``sample(idx) -> (ndim, *idx.shape[:-1])`` values of the velocity
    components at the cells ``idx``, in the field dtype. ``ranks`` None:
    gathered from the whole volumes ``vel_slabs[0]``. Else each rank that
    ``ranks`` plays reads the cells in its rows of its slabs (one list of
    components each, ``vel_slabs``) and writes zero elsewhere, and one
    all_reduce SUM joins them: every cell lies in one rank's rows, so the
    sum is the cell's value exactly (x + 0 = x)."""
    ndim = len(vel_slabs[0])
    if ranks is None:
        return lambda idx: torch.stack([_sample(v, idx, ndim) for v in vel_slabs[0]])

    def sample(idx):
        parts = [torch.stack([_sample_rows(v, idx, r * int(v.shape[0]), ndim) for v in vels])
                 for vels, r in zip(vel_slabs, ranks.ranks)]
        return ranks.reduce(parts)

    return sample


def _draw_increments(vels, separations, lo, width, cell_size, seed, base, *, num_points: int,
                     anisotropic: bool, draw=None):
    """``(dv, rhat, dirhat)`` of one float64 pair draw (``_draw_pairs``):
    the raw velocity-increment vectors, the *wrapped* separation unit
    vectors (reference parity, FlashUniform.py:418-427) and the *pre-wrap*
    draw directions (the minimal-image separation), renormalised in 2D.
    Both endpoints' cells are read by one ``sample`` of ``draw``
    (``_ranked_draw``; of the whole volumes ``vels`` when None). The
    structure functions and the increment PDFs share it."""
    sample, vol_shape, device = draw if draw is not None else _ranked_draw([list(vels)], None)
    adt = accum_dtype()
    p1, p2, direction, i1, i2 = _draw_pairs(
        separations, lo, width, cell_size, tuple(vol_shape), seed, base, num_points, adt, device,
    )
    vals = sample(torch.stack([i2, i1])).to(adt)
    dv = (vals[:, 0] - vals[:, 1]).movedim(0, -1)
    del vals
    if anisotropic:
        rhat = torch.zeros_like(dv)
        rhat[..., 0] = 1.0
        return dv, rhat, rhat
    sep_vec = p2 - p1
    rhat = sep_vec / torch.sqrt(torch.sum(sep_vec**2, dim=-1, keepdim=True))
    norm = torch.sqrt(torch.sum(direction**2, dim=-1, keepdim=True))
    dirhat = direction / torch.where(norm > 0, norm, torch.ones_like(norm))
    return dv, rhat, dirhat


def _components(draw, separations, lo, width, cell_size, seed, base, num_points, anisotropic):
    """(longitudinal, transverse) float64 magnitudes of one draw:
    |dv . rhat| and |dv - |dv . rhat| rhat| (the reference's). ``draw``
    is ``_ranked_draw``'s."""
    dv, rhat, _ = _draw_increments(None, separations, lo, width, cell_size, seed, base,
                                   num_points=num_points, anisotropic=anisotropic, draw=draw)
    long_comp = torch.abs(torch.sum(dv * rhat, dim=-1))
    return long_comp, torch.sqrt(torch.sum((dv - long_comp[..., None] * rhat) ** 2, dim=-1))


def _ranked_draw(vel_slabs, ranks):
    """(sample, whole volume shape, device) of the velocity slabs that
    ``ranks`` plays (the whole volumes with ``ranks`` None)."""
    shape = [int(s) for s in vel_slabs[0][0].shape]
    if ranks is not None:
        shape[0] *= ranks.d
    return _sampler(vel_slabs, ranks), tuple(shape), vel_slabs[0][0].device


def structure_functions(
    vels: Sequence[torch.Tensor],
    *,
    domain_bounds: np.ndarray,
    mesh=None,
    **kwargs,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Longitudinal/transverse velocity structure functions, orders 1-10
    (``structure_functions_ranked``'s keywords). With ``mesh``, ``vels``
    are the rank's x-slabs of a volume slab-sharded over the mesh's space
    axis: every rank makes the same draw, reads the endpoints in its rows
    and one all_reduce a draw joins them, so the moments equal the single
    device's bit for bit; every rank gets them."""
    ranks = None if mesh is None else runtime.SpaceRanks(mesh)
    return structure_functions_ranked([list(vels)], ranks, domain_bounds=domain_bounds, **kwargs)


def structure_functions_ranked(
    vel_slabs,
    ranks,
    *,
    domain_bounds: np.ndarray,
    num_seps: int = 100,
    num_points: int = 10000,
    sep_bounds: Optional[Sequence[float]] = None,
    log_scale: bool = True,
    anisotropic: bool = False,
    seed: int = 0,
    resample_per_order: bool = True,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Longitudinal/transverse velocity structure functions, orders 1-10:
    {"longitudinal": {"1".."10": (num_seps,)}, "transverse": {...},
    "separations"}, of the whole volumes ``vel_slabs[0]`` (``ranks``
    None) or of the x-slabs that ``ranks`` plays (a list of components
    each). ``resample_per_order=True`` (the reference's loop nesting)
    draws fresh pairs for every order; ``False`` draws once (order 1's
    streams) and evaluates all ten orders on that draw, so order 1 is
    identical between the modes."""
    draw = _ranked_draw(vel_slabs, ranks)
    ndim, vol_shape, lo, width, cell_size = _geometry(vel_slabs[0], domain_bounds, draw[1])
    separations = _separations(sep_bounds, int(num_seps), log_scale, cell_size, width)
    args = (draw, separations, lo, width, cell_size, seed)
    num_points = int(num_points)
    long_v, trans_v = [], []
    if resample_per_order:
        for order in range(1, 11):
            long_c, trans_c = _components(*args, (order - 1) * 3, num_points, anisotropic)
            long_v.append((long_c**order).sum(dim=-1) / float(num_points))
            trans_v.append((trans_c**order).sum(dim=-1) / float(num_points))
    else:
        long_c, trans_c = _components(*args, 0, num_points, anisotropic)
        long_p, trans_p = torch.ones_like(long_c), torch.ones_like(trans_c)
        for _ in range(10):
            long_p, trans_p = long_p * long_c, trans_p * trans_c
            long_v.append(long_p.sum(dim=-1) / float(num_points))
            trans_v.append(trans_p.sum(dim=-1) / float(num_points))
    long_v = torch.stack(long_v).cpu().numpy()
    trans_v = torch.stack(trans_v).cpu().numpy()
    return {
        "transverse": {f"{o}": trans_v[o - 1] for o in range(1, 11)},
        "longitudinal": {f"{o}": long_v[o - 1] for o in range(1, 11)},
        "separations": separations,
    }


def _transverse_direction(rhat: torch.Tensor) -> torch.Tensor:
    """One unit vector perpendicular to each rhat: in 2D rhat turned a
    quarter; in 3D cross(a, rhat) with a = z-hat away from the pole and
    x-hat near it (|rhat_z| > 0.9)."""
    if rhat.shape[-1] == 2:
        return torch.stack([-rhat[..., 1], rhat[..., 0]], dim=-1)
    xhat = torch.tensor([1.0, 0.0, 0.0], dtype=rhat.dtype, device=rhat.device)
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=rhat.dtype, device=rhat.device)
    a = torch.where(torch.abs(rhat[..., 2:3]) > 0.9, xhat, zhat)
    that = torch.linalg.cross(a, rhat, dim=-1)
    return that / torch.sqrt(torch.sum(that**2, dim=-1, keepdim=True))


def _moments_and_counts(x: torch.Tensor, edges: np.ndarray) -> Dict[str, np.ndarray]:
    """Per separation (rows of ``x``): the counts of the increments
    centred and normalised by their own std against ``edges``, and their
    mean, std, skewness and flatness (two-pass, float64; NaN skewness and
    flatness and every sample at z = 0 where the std is 0)."""
    mean = x.mean(dim=1)
    c = x - mean[:, None]
    m2 = (c * c).mean(dim=1)
    m3 = (c * c * c).mean(dim=1)
    m4 = ((c * c) ** 2).mean(dim=1)
    std = torch.sqrt(m2)
    z = c / torch.where(std > 0, std, torch.ones_like(std))[:, None]
    counts = volume.interval_counts(z, edges)
    s2 = torch.where(m2 > 0, m2, torch.ones_like(m2))
    nan = torch.full_like(m2, float("nan"))
    skew = torch.where(m2 > 0, m3 / (s2 * torch.sqrt(s2)), nan)
    flat = torch.where(m2 > 0, m4 / (s2 * s2), nan)
    host = torch.stack([mean, std, skew, flat]).cpu().numpy()
    return {"counts": counts.cpu().numpy().astype(np.float64), "mean": host[0], "std": host[1],
            "skewness": host[2], "flatness": host[3]}


def velocity_increment_pdfs(
    vels: Sequence[torch.Tensor],
    *,
    domain_bounds: np.ndarray,
    mesh=None,
    **kwargs,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """PDFs of signed velocity increments (``velocity_increment_pdfs_ranked``'s
    keywords); ``mesh`` as in ``structure_functions``: the increments, and
    so the counts, equal the single device's exactly."""
    ranks = None if mesh is None else runtime.SpaceRanks(mesh)
    return velocity_increment_pdfs_ranked([list(vels)], ranks, domain_bounds=domain_bounds,
                                          **kwargs)


def velocity_increment_pdfs_ranked(
    vel_slabs,
    ranks,
    *,
    domain_bounds: np.ndarray,
    num_seps: int = 8,
    num_points: int = 65536,
    sep_bounds: Optional[Sequence[float]] = None,
    log_scale: bool = True,
    nbins: int = 101,
    nsigma: float = 10.0,
    anisotropic: bool = False,
    seed: int = 0,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """PDFs of signed velocity increments at a handful of separations
    (beyond the reference): the longitudinal dv . rhat and one transverse
    dv . that, rhat the pre-wrap draw direction (streams 1<<17 ..), per
    separation centred and normalised by their own std and counted into
    ``nbins`` equal bins over [-nsigma, nsigma] (np.histogram semantics;
    out-of-range samples dropped). Returns {"separations", "edges",
    "longitudinal": {"counts" (num_seps, nbins), "mean", "std",
    "skewness", "flatness"}, "transverse": {...}}."""
    if not 0 < int(num_points) < 2**24:
        raise ValueError(
            f"num_points must be in (0, 2^24) so packed f32 counts stay "
            f"integer-exact, got {num_points}"
        )
    if nbins < 1:
        raise ValueError(f"nbins must be positive, got {nbins}")
    if not nsigma > 0:
        raise ValueError(f"nsigma must be positive, got {nsigma}")
    draw = _ranked_draw(vel_slabs, ranks)
    ndim, vol_shape, lo, width, cell_size = _geometry(vel_slabs[0], domain_bounds, draw[1])
    separations = _separations(sep_bounds, int(num_seps), log_scale, cell_size, width)
    edges = np.linspace(-float(nsigma), float(nsigma), int(nbins) + 1)
    dv, _, rhat = _draw_increments(None, separations, lo, width, cell_size, seed, _INC_STREAM,
                                   num_points=int(num_points), anisotropic=anisotropic, draw=draw)
    dl = torch.sum(dv * rhat, dim=-1)
    dt = torch.sum(dv * _transverse_direction(rhat), dim=-1)
    return {
        "separations": separations,
        "edges": edges,
        "longitudinal": _moments_and_counts(dl, edges),
        "transverse": _moments_and_counts(dt, edges),
    }


def she_leveque(orders) -> np.ndarray:
    """She-Leveque (1994) model exponents zeta_p = p/9 + 2(1-(2/3)^(p/3))
    (zeta_3 = 1):

    >>> she_leveque([3]).round(12)
    array([1.])
    """
    p = np.asarray(orders, dtype=np.float64)
    return p / 9.0 + 2.0 * (1.0 - (2.0 / 3.0) ** (p / 3.0))


def _log_slope(x: np.ndarray, y: np.ndarray):
    """Least-squares slope of y vs x with its standard error (NaN when
    fewer than 3 usable points)."""
    good = np.isfinite(x) & np.isfinite(y)
    if int(good.sum()) < 3:
        return np.nan, np.nan
    (slope, _icpt), cov = np.polyfit(x[good], y[good], 1, cov=True)
    return float(slope), float(np.sqrt(cov[0, 0]))


def scaling_exponents(
    vsfs: Dict,
    *,
    reference_order: int = 3,
    fit_range: Optional[Sequence[float]] = None,
    ess: bool = True,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Structure-function scaling exponents zeta_p of a
    :func:`structure_functions` result (host numpy): the log-log slope of
    S_p against S_ref (Extended Self-Similarity, ``ess=True``) or against
    r, over the separations in ``fit_range`` (default all), non-positive
    S_p excluded. Returns {"orders", "longitudinal": {"zeta",
    "zeta_err"}, "transverse": {...}, "ess", "reference_order"}."""
    seps = np.asarray(vsfs["separations"], dtype=np.float64)
    sel = np.ones(seps.shape, dtype=bool)
    if fit_range is not None:
        rmin, rmax = float(fit_range[0]), float(fit_range[1])
        sel = (seps >= rmin) & (seps <= rmax)
        if sel.sum() < 3:
            raise ValueError(
                f"fit_range {fit_range} keeps {int(sel.sum())} of {seps.size} "
                "separations; need at least 3 for a slope fit"
            )
    orders = sorted(int(o) for o in vsfs["longitudinal"])
    if ess and reference_order not in orders:
        raise ValueError(f"reference_order {reference_order} not among computed orders {orders}")

    def log_positive(a):
        a = np.asarray(a, dtype=np.float64)
        return np.log(np.where(a > 0, a, 1.0), where=a > 0, out=np.full(a.shape, np.nan))

    out: Dict[str, Dict[str, np.ndarray] | np.ndarray] = {
        "orders": np.asarray(orders, dtype=np.float64),
        "ess": bool(ess),
        "reference_order": int(reference_order) if ess else None,
    }
    for comp in ("longitudinal", "transverse"):
        x = (log_positive(vsfs[comp][str(reference_order)]) if ess else np.log(seps))[sel]
        fits = [_log_slope(x, log_positive(vsfs[comp][str(o)])[sel]) for o in orders]
        out[comp] = {"zeta": np.asarray([f[0] for f in fits]),
                     "zeta_err": np.asarray([f[1] for f in fits])}
    return out


# Pair sampling draws from a dedicated stream far outside the
# structure-function stream range (orders 1-10 use streams 0..29), so
# the two analyses never reuse Threefry words under a shared seed.
_PAIR_STREAM = 1 << 16


def pair_bin_edges(lo: float, hi: float, nbins: int, log_bins: bool) -> np.ndarray:
    """The float64 separation-bin edges (nbins+1,) that the binning and
    the same-draw oracles share."""
    if log_bins:
        return np.geomspace(float(lo), float(hi), nbins + 1)
    return np.linspace(float(lo), float(hi), nbins + 1)


def pair_indices(seed, num_pairs: int, n: int, device="cuda") -> torch.Tensor:
    """The pair-sampling index draw: one (2, num_pairs) int32 block from
    stream ``_PAIR_STREAM`` of ``seed`` (row 0 the first endpoints, row 1
    the second), word for word fava_tpu's ``pair_indices``."""
    return prng.randint(seed, _PAIR_STREAM, (2, int(num_pairs)), int(n), device=device)


def pair_structure_functions(
    positions,
    velocities,
    *,
    num_pairs: int = 200000,
    nbins: int = 24,
    sep_bounds: Optional[Sequence[float]] = None,
    orders: int = 10,
    lengths: Optional[Sequence[float]] = None,
    log_bins: bool = True,
    seed: int = 0,
    device="cuda",
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Structure functions from particle pairs (no grid interpolation).

    ``positions`` and ``velocities`` are matching (N, ndim) tables (numpy
    arrays or tensors; they go to ``device`` as float64). Samples
    ``num_pairs`` random pairs (``pair_indices``), projects the velocity
    increments on the pair separation (longitudinal |du_L|, transverse
    magnitude) and bins them by separation into ``nbins`` bins (log by
    default) over ``sep_bounds``: bin k covers [e_k, e_{k+1}), the top
    edge inclusive, decided on r^2 against the squared edges. With
    ``lengths`` the separations take the periodic minimum image.
    Returns {"longitudinal": {"1".."orders"}, "transverse": {...},
    "separations" (per-bin mean pair distance), "counts"}; empty bins
    are NaN.
    """
    dev = resolve_device(device)
    pos = torch.as_tensor(positions).to(device=dev, dtype=torch.float64)
    vel = torch.as_tensor(velocities).to(device=dev, dtype=torch.float64)
    if pos.ndim != 2 or vel.shape != pos.shape:
        raise ValueError(
            f"positions/velocities must be matching (N, ndim) tables, got "
            f"{tuple(pos.shape)} / {tuple(vel.shape)}"
        )
    n, ndim = int(pos.shape[0]), int(pos.shape[1])
    if n < 2:
        raise ValueError("need at least 2 particles")
    if sep_bounds is None:
        # The resolvable range from the data: the mean spacing
        # (narrowest span over N^(1/ndim)) to half the narrowest span.
        span = (pos.amax(dim=0) - pos.amin(dim=0)).cpu().numpy()
        hi = float(np.min(span[span > 0])) / 2.0 if np.any(span > 0) else 1.0
        lo = hi / max(n ** (1.0 / ndim), 2.0)
        sep_bounds = (lo, hi)
    lo, hi = (float(s) for s in sep_bounds)
    if not 0 < lo < hi:
        raise ValueError(f"sep_bounds must satisfy 0 < lo < hi, got ({lo}, {hi})")
    nbins, orders = int(nbins), int(orders)
    e2 = torch.as_tensor(pair_bin_edges(lo, hi, nbins, bool(log_bins)) ** 2, device=dev)

    idx = pair_indices(seed, num_pairs, n, dev).long()
    d = pos[idx[1]] - pos[idx[0]]
    if lengths is not None:
        L = torch.tensor([float(x) for x in lengths], dtype=torch.float64, device=dev)
        d = d - L * torch.round(d / L)
    # r^2 summed x, y, z in that order: the oracle's float64 operations.
    r2 = d[:, 0] * d[:, 0]
    for a in range(1, ndim):
        r2 = r2 + d[:, a] * d[:, a]
    keep = torch.nonzero((r2 >= e2[0]) & (r2 <= e2[nbins])).squeeze(1)
    d, r2 = d[keep], r2[keep]
    bidx = torch.bucketize(r2, e2[1:nbins].contiguous(), right=True)
    dv = vel[idx[1, keep]] - vel[idx[0, keep]]
    r = torch.sqrt(r2)
    dl = torch.abs((dv * d).sum(dim=-1) / torch.clamp_min(r, 1e-30))
    dt = torch.sqrt(torch.clamp_min((dv * dv).sum(dim=-1) - dl * dl, 0.0))

    # One scatter of every column: [count, r, |du_L|^p, du_T^p for p = 1..orders].
    cols = [torch.ones_like(r), r]
    pl, pt = torch.ones_like(dl), torch.ones_like(dt)
    for _ in range(orders):
        pl, pt = pl * dl, pt * dt
        cols += [pl, pt]
    sums = torch.zeros((nbins, len(cols)), dtype=accum_dtype(), device=dev)
    sums.index_add_(0, bidx, torch.stack(cols, dim=1))
    packed = sums.T.cpu().numpy()
    counts = packed[0]
    safe = np.maximum(counts, 1)
    out: Dict[str, Dict[str, np.ndarray] | np.ndarray] = {
        "counts": counts,
        "separations": np.where(counts > 0, packed[1] / safe, np.nan),
        "longitudinal": {},
        "transverse": {},
    }
    for o in range(1, orders + 1):
        out["longitudinal"][f"{o}"] = np.where(counts > 0, packed[2 * o] / safe, np.nan)
        out["transverse"][f"{o}"] = np.where(counts > 0, packed[2 * o + 1] / safe, np.nan)
    return out
