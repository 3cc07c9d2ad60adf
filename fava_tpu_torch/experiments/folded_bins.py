"""The one-pass and the row-chunked folded binning paths (B11).

Counterpart of the spectra paths of fava_tpu's binning probes
(scripts/tpu_shellbin_v2_probe.py, scripts/tpu_zsplit_probe.py), the
only callers of its v1 and v2 folded binning kernels: transforms,
power volumes, the quadrant fold in fava_tpu's layout (rows padded to a
multiple of 8), then the one-pass binning with counts in the kernel
(``ops.cuda_kernels.shell_bin_sums_folded_onepass``) or the row-chunked
values-only binning with the static counts
(``ops.cuda_kernels.shell_bin_values_folded_rows``). Even x and y
extents. The same result as ``ops.cuda_kernels.shell_bin_sums_rfft``
on the power volumes, which folds without padding and bins with K4.
"""

from __future__ import annotations

import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.spectra import kinetic_power_volumes

BINNINGS = ("onepass", "rows")


def pad_rows8(folded: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """A fold (nx//2+1, ny//2+1, nzr) with its rows padded to a multiple
    of 8, the pad rows holding ``fill``: fava_tpu's fold layout
    (pallas_kernels._fold_quadrants) with its zeros by default."""
    nxh, nyh, nzr = folded.shape
    out = folded.new_full((nxh, nyh + (-nyh) % 8, nzr), fill)
    out[:, :nyh] = folded
    return out


def shell_sums_padded_fold(total, longi, nbins: int, full_nz: int, binning: str = "onepass"):
    """(counts, sums[3]) of (nx, ny, nzr) rfft power volumes: K3's fold,
    padded as fava_tpu pads it, into the one-pass or the row-chunked
    folded binning."""
    if binning not in BINNINGS:
        raise ValueError(f"binning must be one of {BINNINGS}, got {binning!r}")
    nx, ny, _ = (int(s) for s in total.shape)
    folds = [pad_rows8(f) for f in cuda_kernels.fold_quadrants_pair(total, longi)]
    if binning == "onepass":
        return cuda_kernels.shell_bin_sums_folded_onepass(*folds, nbins, nx, ny, full_nz)
    t_sum, l_sum = cuda_kernels.shell_bin_values_folded_rows(*folds, nbins, nx, ny, full_nz)
    counts = cuda_kernels.rfft_shell_counts((nx, ny, full_nz), nbins, device=total.device)
    return counts, torch.stack([t_sum, l_sum, t_sum - l_sum])


def rfft_shell_sums_folded(dens, vels, nbins: int, binning: str = "onepass"):
    """(counts, sums[3]) of the kinetic-energy power of sqrt(rho)*v of a 3D
    volume with even x and y extents: three cuFFT transforms, the power
    volumes, then ``shell_sums_padded_fold``."""
    total, longi = kinetic_power_volumes(dens, vels)
    return shell_sums_padded_fold(total, longi, nbins, int(dens.shape[2]), binning)
