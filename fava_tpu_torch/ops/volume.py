"""Volume-wise reductions, mass sums, and PDFs.

Counterpart of fava_tpu/ops/volume.py. All are AMR-aware through the
weights the meshes pass (leaf cell volumes, optionally times density).

Deviation from fava_tpu: the TPU has no float64, so fava_tpu packs its
counts as int32 hi/lo words and its weighted sums as double-word pairs
(utils/twofloat.py). Here every sum is float64 and every count an exact
int64, on every device. The joint histogram (``pdf2d``) runs the
hand-written kernel B8 on the card (``cuda_kernels.pdf2d_counts``);
``pdf1d``, ``density_pdf`` and ``binned_statistic`` are plain torch, as
they are XLA code in fava_tpu. Bin edges are ``np.linspace`` on the
host (fava_tpu's in-trace ``_edges_traced`` is its bit-identical twin),
so a data-dependent range costs one device-to-host fetch of the range
scalars before the histogram. ``volume_integration``, ``volume_average``
and ``mass_sum`` take ``mesh=`` for a volume slab-sharded over a device
mesh: a local float64 sum on the rank's x-slab, then one all_reduce of
the packed sums (ROADMAP A11d). So do the PDFs and ``binned_statistic``
(A11e): each is a body over the slabs that a ``parallel.SpaceRanks``
plays (``*_ranked``; a single device runs it on its one slab), with an
auto range by one MIN all_reduce of the slabs' (min, -max), the local
counts (``bincount``, B8) or float64 sums, and one SUM all_reduce a
pass. ``sample_points_ranked`` samples block stacks at cells, each rank
the points that its x-rows hold, joined by one SUM (A11f.2).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype


def _joined(vec: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's packed float64 partial sums, summed over the mesh's space
    axis (one all_reduce); as they are with no mesh."""
    return vec if mesh is None else runtime.all_reduce_packed(vec, mesh)


def volume_integration(data: torch.Tensor, cell_volumes, blocklist=None, mesh=None) -> float:
    """integral(field dV) = sum over leaf blocks of blocksum * cell_volume.
    With ``mesh``, ``data`` is the rank's x-slab of a volume slab-sharded
    over the mesh's space axis: a local float64 sum, then one all_reduce."""
    if blocklist is not None:
        data = torch.index_select(data, 0, torch.as_tensor(np.asarray(blocklist), device=data.device))
    if data.ndim == 3:  # single uniform block
        data = data[None]
    sums = data.to(accum_dtype()).sum(dim=tuple(range(1, data.ndim)))
    cv = torch.as_tensor(np.asarray(cell_volumes, dtype=np.float64), device=sums.device)
    return float(_joined((sums * cv).sum()[None], mesh)[0])


def volume_average(data: torch.Tensor, cell_volumes, domain_volume: float, blocklist=None,
                   mesh=None) -> float:
    return volume_integration(data, cell_volumes, blocklist, mesh) / float(domain_volume)


def _rank_rows(mask, dens: torch.Tensor, mesh):
    """A whole-volume mask cut to the rank's x-rows of ``dens`` (its x
    axis the third from last): a view, on the host when it is a host
    array; a mask that broadcasts along x stays whole."""
    d = runtime.space_axis_size(mesh)
    nx = int(dens.shape[-3]) * d
    axis = np.ndim(mask) - 3
    if axis < 0 or np.shape(mask)[axis] != nx:
        return mask
    lo, hi = runtime.slab_rows(nx, mesh)
    if not isinstance(mask, torch.Tensor):
        mask = np.asarray(mask)
    return mask[(slice(None),) * axis + (slice(lo, hi),)]


def mass_sum(dens: torch.Tensor, cell_volume, masks: Optional[Dict[str, object]] = None,
             mesh=None) -> Dict[str, float]:
    """Total mass plus per-mask masses (the reference's mass_fraction).

    ``cell_volume`` is a scalar (uniform grids) or an array that
    broadcasts along the leading axis (AMR per-block volumes); masks are
    boolean arrays or tensors broadcastable to ``dens``. With ``mesh``,
    ``dens`` is the rank's x-slab of a volume slab-sharded over the
    mesh's space axis: the masks (whole-volume arrays) are cut to the
    rank's rows before they reach the device, and one all_reduce joins
    the packed sums.
    """
    masks = masks or {}
    cv = torch.as_tensor(np.asarray(cell_volume, dtype=np.float64), device=dens.device)
    mass = dens.to(accum_dtype()) * cv
    sums = [mass.sum()]
    for name in masks:
        m = masks[name] if mesh is None else _rank_rows(masks[name], dens, mesh)
        m = torch.as_tensor(m, device=dens.device)
        sums.append(torch.where(m, mass, 0.0).sum())
    vec = _joined(torch.stack(sums), mesh).cpu().numpy()
    out = {"total": float(vec[0])}
    out.update({n: float(vec[1 + i]) for i, n in enumerate(masks)})
    return out


def _ranges(fields, ranks: runtime.SpaceRanks):
    """[(min, max)] of each field as float64 host scalars, over the volume
    whose slabs ``ranks`` plays (``fields[f][k]``: slab k of field f):
    each slab's (min, -max) of every field in one float64 vector, one
    MIN join (negation is exact, so the MIN of -max gives the max), one
    fetch. The join is exact: the edges built from it are the single
    device's bit for bit."""
    parts = [torch.stack([m for v in slabs for m in (v.min(), -v.max())]).to(torch.float64)
             for slabs in zip(*fields)]
    mm = ranks.reduce(parts, "min").cpu().numpy()
    return [(float(mm[2 * f]), float(-mm[2 * f + 1])) for f in range(len(fields))]


def _edges(lo: float, hi: float, nbins: int, device) -> Tuple[np.ndarray, torch.Tensor]:
    """np.linspace edges on the host and their float64 copy on ``device``."""
    edges = np.linspace(lo, hi, nbins + 1)
    return edges, torch.as_tensor(edges, device=device)


def _bin_sums(idx: torch.Tensor, nbins: int, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-bin int64 counts (weights None) or float64 sums of the flat
    ``weights``, over samples with bin ``idx`` >= 0."""
    keep = idx >= 0
    if weights is None:
        return torch.bincount(idx[keep], minlength=nbins)
    out = torch.zeros(nbins, dtype=torch.float64, device=idx.device)
    return out.index_add_(0, idx[keep], weights.reshape(-1).to(torch.float64)[keep])


def interval_counts(values: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """(rows, nbins) int64 counts of each row of the 2D ``values`` against
    the host-exact ``edges``, np.histogram semantics (half-open bins, the
    last closed at edges[-1], out-of-range and NaN samples dropped): the
    counting form of fava_tpu's ``_interval_hist``, every row at once."""
    rows, nbins = values.shape[0], len(edges) - 1
    idx = cuda_kernels.bin_index(values, torch.as_tensor(edges, device=values.device))
    offset = nbins * torch.arange(rows, device=values.device)[:, None]
    flat = torch.where(idx.reshape(rows, -1) >= 0, idx.reshape(rows, -1) + offset, -1)
    return _bin_sums(flat.reshape(-1), rows * nbins, None).reshape(rows, nbins)


def _density(counts: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Counts over (total * bin width, or area); the counts when empty."""
    total = counts.sum()
    return counts / (total * widths) if total > 0 else counts


def _check_shape(what: str, a, ref, ref_name: str) -> None:
    # Equal sizes would broadcast cleanly and silently pair each sample
    # with another cell's weight: shapes must match.
    if a is not None and tuple(a.shape) != tuple(ref.shape):
        raise ValueError(
            f"{what} shape {tuple(a.shape)} does not match {ref_name} shape {tuple(ref.shape)}"
        )


def _lists(weights, count: int):
    """The per-slab weights: the list given, or None for each slab."""
    return [None] * count if weights is None else list(weights)


def pdf1d(
    values: torch.Tensor,
    *,
    nbins: int = 100,
    vrange: Optional[Tuple[float, float]] = None,
    weights: Optional[torch.Tensor] = None,
    density: bool = True,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Weighted 1D PDF of a field: np.histogram semantics (half-open
    bins, the last closed, out-of-range samples dropped); exact counts,
    float64 weight sums. With ``mesh``, ``values`` (and ``weights``) are
    the rank's x-slab of a volume slab-sharded over the mesh's space
    axis (:func:`pdf1d_ranked`); every rank gets the whole volume's
    PDF."""
    _check_shape("weights", weights, values, "values")
    if vrange is None and values.numel() == 0:
        raise ValueError("pdf1d cannot auto-range an empty array; pass vrange")
    return pdf1d_ranked([values], runtime.SpaceRanks(mesh), nbins=nbins, vrange=vrange,
                        weights=None if weights is None else [weights], density=density)


def pdf1d_ranked(values, ranks: runtime.SpaceRanks, *, nbins: int = 100, vrange=None,
                 weights=None, density: bool = True) -> Dict[str, np.ndarray]:
    """:func:`pdf1d` of the volume whose slabs ``ranks`` plays (``values``
    and ``weights`` lists in that order): the range by one MIN join
    (``_ranges``), the local counts (``bincount``) or float64 weight sums
    of each slab, one SUM join."""
    if vrange is None:
        (vrange,) = _ranges([values], ranks)
    lo, hi = float(vrange[0]), float(vrange[1])
    if hi <= lo:
        hi = lo + 1.0
    edges, edges_t = _edges(lo, hi, nbins, values[0].device)
    parts = [_bin_sums(cuda_kernels.bin_index(v, edges_t), nbins, w)
             for v, w in zip(values, _lists(weights, len(values)))]
    counts = ranks.reduce(parts).cpu().numpy().astype(np.float64)
    out = _density(counts, np.diff(edges)) if density else counts
    return {"edges": edges, "centers": 0.5 * (edges[1:] + edges[:-1]), "pdf": out, "counts": counts}


def pdf2d(
    xvalues: torch.Tensor,
    yvalues: torch.Tensor,
    *,
    nbins: Tuple[int, int] = (100, 100),
    xrange: Optional[Tuple[float, float]] = None,
    yrange: Optional[Tuple[float, float]] = None,
    weights: Optional[torch.Tensor] = None,
    density: bool = True,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Weighted joint PDF of two fields: np.histogram2d semantics against
    float64 linspace edges; exact counts (unweighted) or float64 weight
    sums, from the joint-histogram kernel B8 on the card. ``mesh`` as in
    :func:`pdf1d` (:func:`pdf2d_ranked`)."""
    _check_shape("yvalues", yvalues, xvalues, "xvalues")
    _check_shape("weights", weights, xvalues, "xvalues")
    if xvalues.numel() == 0 and (xrange is None or yrange is None):
        raise ValueError("pdf2d cannot auto-range empty arrays; pass xrange/yrange")
    return pdf2d_ranked([xvalues], [yvalues], runtime.SpaceRanks(mesh), nbins=nbins,
                        xrange=xrange, yrange=yrange,
                        weights=None if weights is None else [weights], density=density)


def pdf2d_ranked(xvalues, yvalues, ranks: runtime.SpaceRanks, *, nbins=(100, 100), xrange=None,
                 yrange=None, weights=None, density: bool = True) -> Dict[str, np.ndarray]:
    """:func:`pdf2d` of the volume whose slabs ``ranks`` plays: the
    missing ranges by one MIN join of both fields, B8 on each slab
    (``cuda_kernels.pdf2d_counts``, counted or weighted), one SUM join
    of the (nbx, nby) int64 counts or float64 sums."""
    if isinstance(nbins, int):
        nbins = (nbins, nbins)
    nbx, nby = int(nbins[0]), int(nbins[1])
    missing = [v for v, r in ((xvalues, xrange), (yvalues, yrange)) if r is None]
    if missing:
        found = iter(_ranges(missing, ranks))
        xrange = next(found) if xrange is None else xrange
        yrange = next(found) if yrange is None else yrange
    xlo, xhi = map(float, xrange)
    ylo, yhi = map(float, yrange)
    if xhi <= xlo:
        xhi = xlo + 1.0
    if yhi <= ylo:
        yhi = ylo + 1.0
    xedges = np.linspace(xlo, xhi, nbx + 1)
    yedges = np.linspace(ylo, yhi, nby + 1)
    parts = [cuda_kernels.pdf2d_counts(x, y, xedges, yedges, weights=w)
             for x, y, w in zip(xvalues, yvalues, _lists(weights, len(xvalues)))]
    counts = ranks.reduce(parts).cpu().numpy().astype(np.float64)
    out = _density(counts, np.outer(np.diff(xedges), np.diff(yedges))) if density else counts
    return {"xedges": xedges, "yedges": yedges, "pdf": out, "counts": counts}


def _weighted_sums(values, weights, ranks: runtime.SpaceRanks) -> torch.Tensor:
    """[sum of w * value, sum of w] over the volume (w = 1 without
    weights: the sum and the sample count), one packed float64 SUM join;
    ``values`` and ``weights`` are flat float64 slabs."""
    parts = [torch.stack([v.sum(), torch.full((), float(v.numel()), dtype=v.dtype, device=v.device)])
             if w is None else torch.stack([(w * v).sum(), w.sum()])
             for v, w in zip(values, weights)]
    return ranks.reduce(parts)


def density_pdf(
    dens: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    nbins: int = 200,
    srange: Optional[Tuple[float, float]] = None,
    nsigma: float = 5.0,
    mach: Optional[float] = None,
    mesh=None,
) -> Dict[str, object]:
    """Lognormality diagnostics of s = ln(rho / <rho>), <rho> the
    (optionally weighted) mean: the weighted s-PDF over ``srange``
    (default mean_s +- nsigma * sigma_s), the exact weighted moments
    (mean_s, sigma_s, skewness, excess kurtosis) from full-volume float64
    sums, the lognormal residual |mean_s + sigma_s^2 / 2| and, with the
    rms Mach number ``mach``, the driving parameter b from
    sigma_s^2 = ln(1 + b^2 M^2). ``weights``: per-cell volume (AMR) or
    mass; None is uniform. ``mesh`` as in :func:`pdf1d`
    (:func:`density_pdf_ranked`)."""
    if nbins < 1:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    _check_shape("weights", weights, dens, "dens")
    if srange is not None:
        slo, shi = (float(s) for s in srange)
        # The hi > lo guard below is for a constant field (sigma = 0): a
        # fixed range the caller gives is validated, not rewritten.
        if not shi > slo:
            raise ValueError(f"srange must satisfy lo < hi, got ({slo}, {shi})")
    return density_pdf_ranked([dens], runtime.SpaceRanks(mesh),
                              weights=None if weights is None else [weights], nbins=nbins,
                              srange=srange, nsigma=nsigma, mach=mach)


def density_pdf_ranked(dens, ranks: runtime.SpaceRanks, *, weights=None, nbins: int = 200,
                       srange=None, nsigma: float = 5.0, mach=None) -> Dict[str, object]:
    """:func:`density_pdf` of the volume whose slabs ``ranks`` plays, in
    the single device's passes, each joined by one packed float64 SUM:
    <rho> (with the sample count or the weight sum), <s>, the centred
    moments of s; then the edges on the host and the counts (or weight
    sums) of each slab, one SUM join. <rho> and <s> are float64 sums in
    the order of the slabs, so the default edges may differ in the last
    place from another decomposition's: a sample within that of an edge
    may then fall in the neighbouring bin."""
    adt = accum_dtype()
    rs = [d.reshape(-1).to(adt) for d in dens]
    ws = [None if w is None else w.reshape(-1).to(adt) for w in _lists(weights, len(rs))]
    sums = _weighted_sums(rs, ws, ranks)
    norm = sums[1]
    rho_mean = sums[0] / norm
    ss = [torch.log(r / rho_mean) for r in rs]
    del rs
    mu = ranks.reduce([(s if w is None else w * s).sum()[None] for s, w in zip(ss, ws)])[0] / norm
    parts = []
    for s, w in zip(ss, ws):
        d = s - mu
        d2 = d * d
        terms = (d2, d2 * d, d2 * d2)
        parts.append(torch.stack([(t if w is None else w * t).sum() for t in terms]))
        del d, d2, terms
    m234 = ranks.reduce(parts) / norm
    rho_mean, mu, m2, m3, m4 = torch.cat([torch.stack([rho_mean, mu]), m234]).cpu().numpy().tolist()
    sigma = float(np.sqrt(m2))
    if srange is not None:
        lo, hi = (float(s) for s in srange)
    else:
        lo, hi = mu - nsigma * sigma, mu + nsigma * sigma
    if not hi > lo:
        hi = lo + 1.0
    edges, edges_t = _edges(lo, hi, nbins, ss[0].device)
    parts = [_bin_sums(cuda_kernels.bin_index(s, edges_t), nbins, w) for s, w in zip(ss, ws)]
    counts = ranks.reduce(parts).cpu().numpy().astype(np.float64)
    out = {
        "edges": edges,
        "centers": 0.5 * (edges[1:] + edges[:-1]),
        "pdf": _density(counts, np.diff(edges)),
        "counts": counts,
        "rho_mean": rho_mean,
        "mean_s": mu,
        "sigma_s": sigma,
        "skewness": m3 / sigma**3 if sigma > 0 else 0.0,
        "excess_kurtosis": m4 / sigma**4 - 3.0 if sigma > 0 else 0.0,
        "lognormal_residual": abs(mu + 0.5 * sigma**2),
    }
    if mach is not None:
        m = float(mach)
        if m <= 0:
            raise ValueError(f"mach must be positive, got {m}")
        out["b_parameter"] = float(np.sqrt(np.expm1(sigma**2)) / m)
    return out


def binned_statistic(
    xvalues: torch.Tensor,
    yvalues: torch.Tensor,
    *,
    nbins: int = 100,
    vrange: Optional[Tuple[float, float]] = None,
    weights: Optional[torch.Tensor] = None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Conditional bin statistics of ``y`` given ``x``: scipy's
    binned_statistic count/mean/std (population std; NaN for empty
    bins) with np.histogram bin semantics, edges from ``vrange`` or the
    measured x min/max. ``weights`` (AMR cell volumes, mass) make mean
    and std the weighted statistics and add ``weight_sums``. y is
    centered by its global (weighted) mean before the bin sums, as in
    fava_tpu, so a large common offset does not cancel in the variance.
    ``mesh`` as in :func:`pdf1d` (:func:`binned_statistic_ranked`)."""
    if nbins < 1:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    if xvalues.numel() == 0:
        raise ValueError("binned_statistic needs at least one sample")
    _check_shape("y", yvalues, xvalues, "x")
    _check_shape("weights", weights, xvalues, "x")
    if vrange is not None:
        lo, hi = (float(v) for v in vrange)
        if not hi > lo:
            raise ValueError(f"vrange must satisfy lo < hi, got ({lo}, {hi})")
    return binned_statistic_ranked([xvalues], [yvalues], runtime.SpaceRanks(mesh), nbins=nbins,
                                   vrange=vrange, weights=None if weights is None else [weights])


def binned_statistic_ranked(xvalues, yvalues, ranks: runtime.SpaceRanks, *, nbins: int = 100,
                            vrange=None, weights=None) -> Dict[str, np.ndarray]:
    """:func:`binned_statistic` of the volume whose slabs ``ranks``
    plays, in the single device's passes: the x range by one MIN join,
    the global (weighted) mean of y by one packed SUM, then each slab's
    bin counts (as float64, exact below 2^53) and centred sums packed in
    one vector, one SUM join."""
    adt = accum_dtype()
    xs = [x.reshape(-1).to(adt) for x in xvalues]
    ys = [y.reshape(-1).to(adt) for y in yvalues]
    ws = [None if w is None else w.reshape(-1).to(adt) for w in _lists(weights, len(xs))]
    if vrange is None:
        ((lo, hi),) = _ranges([xs], ranks)
        if not hi > lo:
            hi = lo + 1.0
    else:
        lo, hi = (float(v) for v in vrange)
    edges, edges_t = _edges(lo, hi, nbins, xs[0].device)
    sums = _weighted_sums(ys, ws, ranks)
    ymean = sums[0] / sums[1]
    parts = []
    for x, y, w in zip(xs, ys, ws):
        idx = cuda_kernels.bin_index(x, edges_t)
        yc = y - ymean
        rows = [yc, yc * yc] if w is None else [w * yc, w * yc * yc, w]
        parts.append(torch.cat([_bin_sums(idx, nbins, None).to(adt)]
                               + [_bin_sums(idx, nbins, v) for v in rows]))
        del idx, yc, rows
    host = ranks.reduce(parts).cpu().numpy().reshape(-1, nbins)
    counts, sy, syy = host[0], host[1], host[2]
    norm = host[3] if weights is not None else counts
    ymean = float(ymean)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_c = sy / norm
        var = syy / norm - mean_c**2
        mean = np.where(counts > 0, ymean + mean_c, np.nan)
        std = np.where(counts > 0, np.sqrt(np.maximum(var, 0.0)), np.nan)
    out = {
        "edges": edges,
        "centers": 0.5 * (edges[1:] + edges[:-1]),
        "counts": counts,
        "mean": mean,
        "std": std,
    }
    if weights is not None:
        out["weight_sums"] = norm
    return out


def sample_points_ranked(stacks, ranks: runtime.SpaceRanks, blk, cells) -> torch.Tensor:
    """(fields, points) float64 values at the cells ``cells`` (points x
    ndim, grid indices along the block's axes) of the blocks ``blk``, of
    the block stacks whose x-slabs ``ranks`` plays (``stacks[f][k]``:
    slab k of field f, an (nblocks, rows, ...) stack holding the x cells
    ``[r rows, (r + 1) rows)`` of each block for rank r). A point belongs
    to the rank whose rows hold its x cell: each rank takes its own
    points from its slab (``torch.take``) into a zero vector, and one SUM
    joins them, exact, since each value has one contributor."""
    blk = np.asarray(blk, dtype=np.int64)
    cells = np.asarray(cells, dtype=np.int64).reshape(blk.size, -1)
    parts = []
    for k, r in enumerate(ranks.ranks):
        slabs = [s[k] for s in stacks]
        shape = tuple(slabs[0].shape)
        device = slabs[0].device
        i = cells[:, 0] - r * shape[1]
        own = np.nonzero((i >= 0) & (i < shape[1]))[0]
        idx = blk[own]
        for a in range(1, len(shape)):
            c = i[own] if a == 1 else (cells[own, a - 1] if a - 1 < cells.shape[1] else 0)
            idx = idx * shape[a] + c
        flat = torch.as_tensor(idx, device=device)
        mine = torch.as_tensor(own, device=device)
        vec = torch.zeros((len(slabs), blk.size), dtype=torch.float64, device=device)
        for f, s in enumerate(slabs):
            vec[f, mine] = torch.take(s, flat).to(torch.float64)
        parts.append(vec)
    return ranks.reduce(parts)
