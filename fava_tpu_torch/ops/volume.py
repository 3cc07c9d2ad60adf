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
the packed sums (ROADMAP A11d); the PDFs and ``binned_statistic`` take
the whole volume (A11e).
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


def _range(values: torch.Tensor) -> Tuple[float, float]:
    """(min, max) of the values as float64 host scalars (one fetch)."""
    mm = torch.stack([values.min(), values.max()]).to(torch.float64).cpu().numpy()
    return float(mm[0]), float(mm[1])


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


def pdf1d(
    values: torch.Tensor,
    *,
    nbins: int = 100,
    vrange: Optional[Tuple[float, float]] = None,
    weights: Optional[torch.Tensor] = None,
    density: bool = True,
) -> Dict[str, np.ndarray]:
    """Weighted 1D PDF of a field: np.histogram semantics (half-open
    bins, the last closed, out-of-range samples dropped); exact counts,
    float64 weight sums."""
    _check_shape("weights", weights, values, "values")
    if vrange is None:
        if values.numel() == 0:
            raise ValueError("pdf1d cannot auto-range an empty array; pass vrange")
        vrange = _range(values)
    lo, hi = float(vrange[0]), float(vrange[1])
    if hi <= lo:
        hi = lo + 1.0
    edges, edges_t = _edges(lo, hi, nbins, values.device)
    idx = cuda_kernels.bin_index(values, edges_t)
    counts = _bin_sums(idx, nbins, weights).cpu().numpy().astype(np.float64)
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
) -> Dict[str, np.ndarray]:
    """Weighted joint PDF of two fields: np.histogram2d semantics against
    float64 linspace edges; exact counts (unweighted) or float64 weight
    sums, from the joint-histogram kernel B8 on the card."""
    _check_shape("yvalues", yvalues, xvalues, "xvalues")
    _check_shape("weights", weights, xvalues, "xvalues")
    if xvalues.numel() == 0 and (xrange is None or yrange is None):
        raise ValueError("pdf2d cannot auto-range empty arrays; pass xrange/yrange")
    if isinstance(nbins, int):
        nbins = (nbins, nbins)
    nbx, nby = int(nbins[0]), int(nbins[1])
    if xrange is None:
        xrange = _range(xvalues)
    if yrange is None:
        yrange = _range(yvalues)
    xlo, xhi = map(float, xrange)
    ylo, yhi = map(float, yrange)
    if xhi <= xlo:
        xhi = xlo + 1.0
    if yhi <= ylo:
        yhi = ylo + 1.0
    xedges = np.linspace(xlo, xhi, nbx + 1)
    yedges = np.linspace(ylo, yhi, nby + 1)
    counts = cuda_kernels.pdf2d_counts(xvalues, yvalues, xedges, yedges, weights=weights)
    counts = counts.cpu().numpy().astype(np.float64)
    out = _density(counts, np.outer(np.diff(xedges), np.diff(yedges))) if density else counts
    return {"xedges": xedges, "yedges": yedges, "pdf": out, "counts": counts}


def density_pdf(
    dens: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    nbins: int = 200,
    srange: Optional[Tuple[float, float]] = None,
    nsigma: float = 5.0,
    mach: Optional[float] = None,
) -> Dict[str, object]:
    """Lognormality diagnostics of s = ln(rho / <rho>), <rho> the
    (optionally weighted) mean: the weighted s-PDF over ``srange``
    (default mean_s +- nsigma * sigma_s), the exact weighted moments
    (mean_s, sigma_s, skewness, excess kurtosis) from full-volume float64
    sums, the lognormal residual |mean_s + sigma_s^2 / 2| and, with the
    rms Mach number ``mach``, the driving parameter b from
    sigma_s^2 = ln(1 + b^2 M^2). ``weights``: per-cell volume (AMR) or
    mass; None is uniform."""
    if nbins < 1:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    _check_shape("weights", weights, dens, "dens")
    if srange is not None:
        slo, shi = (float(s) for s in srange)
        # The hi > lo guard below is for a constant field (sigma = 0): a
        # fixed range the caller gives is validated, not rewritten.
        if not shi > slo:
            raise ValueError(f"srange must satisfy lo < hi, got ({slo}, {shi})")
    adt = accum_dtype()
    r = dens.reshape(-1).to(adt)
    wv = None if weights is None else weights.reshape(-1).to(adt)

    def wmean(a):
        return a.mean() if wv is None else (wv * a).sum() / wv.sum()

    rho_mean = wmean(r)
    s = torch.log(r / rho_mean)
    mu = wmean(s)
    d = s - mu
    d2 = d * d
    moments = torch.stack([rho_mean, mu, wmean(d2), wmean(d2 * d), wmean(d2 * d2)])
    rho_mean, mu, m2, m3, m4 = moments.cpu().numpy().tolist()
    sigma = float(np.sqrt(m2))
    if srange is not None:
        lo, hi = slo, shi
    else:
        lo, hi = mu - nsigma * sigma, mu + nsigma * sigma
    if not hi > lo:
        hi = lo + 1.0
    edges, edges_t = _edges(lo, hi, nbins, dens.device)
    counts = _bin_sums(cuda_kernels.bin_index(s, edges_t), nbins, wv)
    counts = counts.cpu().numpy().astype(np.float64)
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
) -> Dict[str, np.ndarray]:
    """Conditional bin statistics of ``y`` given ``x``: scipy's
    binned_statistic count/mean/std (population std; NaN for empty
    bins) with np.histogram bin semantics, edges from ``vrange`` or the
    measured x min/max. ``weights`` (AMR cell volumes, mass) make mean
    and std the weighted statistics and add ``weight_sums``. y is
    centered by its global (weighted) mean before the bin sums, as in
    fava_tpu, so a large common offset does not cancel in the variance."""
    if nbins < 1:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    if xvalues.numel() == 0:
        raise ValueError("binned_statistic needs at least one sample")
    _check_shape("y", yvalues, xvalues, "x")
    _check_shape("weights", weights, xvalues, "x")
    adt = accum_dtype()
    x = xvalues.reshape(-1).to(adt)
    y = yvalues.reshape(-1).to(adt)
    if vrange is None:
        lo, hi = _range(x)
        if not hi > lo:
            hi = lo + 1.0
    else:
        lo, hi = (float(v) for v in vrange)
        if not hi > lo:
            raise ValueError(f"vrange must satisfy lo < hi, got ({lo}, {hi})")
    edges, edges_t = _edges(lo, hi, nbins, x.device)
    idx = cuda_kernels.bin_index(x, edges_t)
    counts = _bin_sums(idx, nbins, None)
    if weights is None:
        ymean = y.mean()
        yc = y - ymean
        sums = [yc, yc * yc]
    else:
        w = weights.reshape(-1).to(adt)
        ymean = (w * y).sum() / w.sum()
        yc = y - ymean
        sums = [w * yc, w * yc * yc, w]
    host = [_bin_sums(idx, nbins, v).cpu().numpy() for v in sums]
    counts = counts.cpu().numpy().astype(np.float64)
    sy, syy = host[0], host[1]
    norm = host[2] if weights is not None else counts
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
