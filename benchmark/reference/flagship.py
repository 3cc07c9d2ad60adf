"""Plain reference of the flagship analysis of one uniform snapshot.

Independent of the port: plain torch in float64 (``dtype``), on the
device that holds the inputs, in blocks of x planes so that it fits
beside them once the program's state is freed. It follows the
definitions of the analysis, as fava_tpu states them:

- spectra: the forward-normalized 3D transform F_i of sqrt(rho) v_i;
  over every cell of the full (nx, ny, nz) grid, with the signed
  wavenumbers k of numpy's fftfreq * n (the Nyquist index at -n/2), the
  shell of |k| by edges arange(max(n) // 2) - 0.5 (``nbins = max(n)//2 -
  1`` shells), the cell counts, the sums of the total power 0.5 sum_i
  |F_i|^2, of the longitudinal power |k . F|^2 / |k|^2 (0 at k = 0) and
  of the transverse power, total - longitudinal. The full grid's cells
  come from the z half-spectrum: each cell (a, b, j) with 0 < j <
  ceil(nz/2) also stands for its mirror (-a, -b, nz - j), whose
  transform is the conjugate and whose signed wavenumbers are worked out
  from the mirrored indices (at a Nyquist index they are not the
  negatives), so both are counted the plain way;
- profiles along x, with layer = ny * nz cells a row: mean_dens = sum rho
  / layer; reynolds_stress[ij] = sum rho (v_i - <v_i>)(v_j - <v_j>) /
  layer over the pairs xx, xy, xz, yy, yz, zz, <v_i> the row's plain
  mean; favre_mean_i = sum rho v_i / sum rho; favre_rms_i = sqrt(sum rho
  (v_i - favre_mean_i)^2 / sum rho); total_mass = sum rho over the volume.

``store`` (the control) rounds the inputs, every product and the
transforms to that dtype, and computes in ``dtype`` (float32 for
bfloat16): a reduced-precision path with float32 accumulation.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

NAMES = ("dens", "velx", "vely", "velz")
EXACT = ("spectra_counts",)
SPECTRA = ("spectra_total", "spectra_longitudinal", "spectra_transverse")
SHELL_FLOOR = 2.0**-24
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_BLOCK_ELEMS = 1 << 25


def _rounder(store: Optional[torch.dtype]):
    if store is None:
        return lambda t: t

    def rnd(t: torch.Tensor) -> torch.Tensor:
        if t.is_complex():
            return torch.view_as_complex(torch.view_as_real(t).to(store).to(t.real.dtype))
        return t.to(store).to(t.dtype)

    return rnd


def _signed(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy.fft.fftfreq(n) * n at integer indices (int64)."""
    idx = torch.remainder(idx, n)
    return torch.where(idx <= (n - 1) // 2, idx, idx - n)


def _rows(nx: int, row_elems: int) -> int:
    return max(1, min(nx, _BLOCK_ELEMS // max(row_elems, 1)))


def _transforms(dens, vels, dtype, rnd):
    """The three forward-normalized z half-spectra of sqrt(rho) v_i:
    rfft2 over (y, z) a block of x planes at a time, then the transform
    along x a block of y columns at a time."""
    nx, ny, nz = (int(s) for s in dens.shape)
    nzr = nz // 2 + 1
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    specs = [torch.empty((nx, ny, nzr), dtype=cdt, device=dens.device) for _ in vels]
    step = _rows(nx, ny * nz)
    for x0 in range(0, nx, step):
        sq = rnd(torch.sqrt(rnd(dens[x0 : x0 + step].to(dtype))))
        for spec, v in zip(specs, vels):
            prod = rnd(sq * rnd(v[x0 : x0 + step].to(dtype)))
            spec[x0 : x0 + step] = rnd(torch.fft.rfft2(prod, norm="forward"))
            del prod
        del sq
    step = _rows(ny, nx * nzr)
    for spec in specs:
        for y0 in range(0, ny, step):
            cols = spec[:, y0 : y0 + step]
            cols.copy_(rnd(torch.fft.fft(cols, dim=0, norm="forward")))
    return specs


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real.square() + z.imag.square()


def spectra(dens, vels, dtype=torch.float64, store=None) -> Dict[str, np.ndarray]:
    rnd = _rounder(store)
    nx, ny, nz = (int(s) for s in dens.shape)
    nzr = nz // 2 + 1
    nbins = max(nx, ny, nz) // 2 - 1
    dev = dens.device
    specs = _transforms(dens, vels, dtype, rnd)
    counts = torch.zeros(nbins + 1, dtype=torch.float64, device=dev)
    sums = torch.zeros((2, nbins + 1), dtype=dtype, device=dev)
    b = torch.arange(ny, device=dev)[None, :, None]
    j = torch.arange(nzr, device=dev)[None, None, :]
    mirrored = (j >= 1) & (j < (nz + 1) // 2)
    kb, kb_m = _signed(b, ny), _signed(-b, ny)
    kj, kj_m = _signed(j, nz), _signed(nz - j, nz)
    step = _rows(nx, ny * nzr)
    r_max2 = (nbins - 0.5) ** 2
    for x0 in range(0, nx, step):
        a = torch.arange(x0, min(nx, x0 + step), device=dev)[:, None, None]
        ka, ka_m = _signed(a, nx), _signed(-a, nx)
        k2 = ka * ka + kb * kb + kj * kj  # int64; the mirror's is the same
        shell = torch.floor(torch.sqrt(k2.to(torch.float64)) + 0.5).to(torch.int64)
        shell = torch.where(k2.to(torch.float64) < r_max2, shell, nbins)
        weight = 1 + mirrored.to(torch.int64)
        f = [s[x0 : x0 + step] for s in specs]
        total = rnd(0.5 * (rnd(_abs2(f[0])) + rnd(_abs2(f[1])) + rnd(_abs2(f[2]))))
        inv_k2 = torch.where(k2 > 0, 1.0 / k2.clamp(min=1).to(dtype), torch.zeros((), dtype=dtype, device=dev))

        def proj(kx, ky, kz):
            return rnd(_abs2(rnd(kx.to(dtype) * f[0] + ky.to(dtype) * f[1] + kz.to(dtype) * f[2])))

        longi = proj(ka, kb, kj) + torch.where(mirrored, proj(ka_m, kb_m, kj_m), 0.0)
        longi = rnd(longi * inv_k2)
        w = weight.expand_as(shell).reshape(-1)
        idx = shell.reshape(-1)
        counts.index_add_(0, idx, w.to(torch.float64))
        sums[0].index_add_(0, idx, (total * weight.to(dtype)).reshape(-1))
        sums[1].index_add_(0, idx, longi.reshape(-1))
        del total, longi, k2, shell, f, inv_k2
    del specs
    counts, total, longi = counts[:nbins], sums[0, :nbins], sums[1, :nbins]
    host = lambda t: t.to(torch.float64).cpu().numpy()  # noqa: E731
    return {
        "spectra_counts": host(counts),
        "spectra_total": host(total),
        "spectra_longitudinal": host(longi),
        "spectra_transverse": host(total - longi),
    }


def profiles(dens, vels, dtype=torch.float64, store=None) -> Dict[str, np.ndarray]:
    rnd = _rounder(store)
    nx, ny, nz = (int(s) for s in dens.shape)
    layer = float(ny * nz)
    rows = {k: [] for k in ("d", "mean", "stress", "fmean", "frms")}
    mass = torch.zeros((), dtype=dtype, device=dens.device)
    step = _rows(nx, ny * nz)
    for x0 in range(0, nx, step):
        d = rnd(dens[x0 : x0 + step].to(dtype))
        v = [rnd(c[x0 : x0 + step].to(dtype)) for c in vels]
        d_row = d.sum(dim=(1, 2))
        mean = torch.stack([c.sum(dim=(1, 2)) / layer for c in v])
        fmean = torch.stack([rnd(d * c).sum(dim=(1, 2)) for c in v]) / d_row
        frms = torch.stack([
            (rnd(d * rnd((c - m[:, None, None]).square())).sum(dim=(1, 2)) / d_row).sqrt()
            for c, m in zip(v, fmean)])
        cen = [rnd(c - m[:, None, None]) for c, m in zip(v, mean)]
        stress = torch.stack([rnd(rnd(d * cen[i]) * cen[k]).sum(dim=(1, 2)) / layer
                              for i, k in PAIRS])
        mass = mass + d_row.sum()
        for key, val in (("d", d_row), ("mean", mean), ("stress", stress), ("fmean", fmean),
                         ("frms", frms)):
            rows[key].append(val)
        del d, v, cen
    host = lambda t: t.to(torch.float64).cpu().numpy()  # noqa: E731
    return {
        "mean_dens": host(torch.cat(rows["d"]) / layer),
        "reynolds_stress": host(torch.cat(rows["stress"], dim=1)),
        "favre_mean": host(torch.cat(rows["fmean"], dim=1)),
        "favre_rms": host(torch.cat(rows["frms"], dim=1)),
        "total_mass": host(mass),
    }


def outputs(fields: Dict[str, torch.Tensor], dtype=torch.float64, store=None) -> Dict[str, np.ndarray]:
    """Every output of the flagship analysis of one snapshot (float64 numpy)."""
    dens, *vels = (fields[n] for n in NAMES)
    with torch.no_grad():
        return {**spectra(dens, vels, dtype, store), **profiles(dens, vels, dtype, store)}


def scales(ref: Dict[str, np.ndarray], fields: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """What each output's gap is divided by. The spectra: each shell
    against its own total power in the reference (|longitudinal| <= 2
    total, |transverse| <= total, so the three share it), floored at
    float32's unit round-off times the largest shell's, below which a
    float32 transform does not resolve a shell. The row Favre means,
    which vanish up to rounding for velocities with no mean flow: their
    largest magnitude, floored at the rms velocity. The other profiles:
    their largest magnitude (the compare's default)."""
    total = np.abs(np.asarray(ref["spectra_total"], dtype=np.float64))
    shell = np.maximum(total, SHELL_FLOOR * total.max(initial=0.0))
    sq = sum(float(torch.linalg.vector_norm(fields[n], dtype=torch.float64)) ** 2 for n in NAMES[1:])
    favre = max(float(np.abs(ref["favre_mean"]).max(initial=0.0)),
                math.sqrt(sq / (3 * fields["dens"].numel())))
    return {**{k: shell for k in SPECTRA}, "favre_mean": favre}
