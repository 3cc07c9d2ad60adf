"""Stacked transforms and the fused-spectrum path: counterpart of
fava_tpu/experiments/planar_dft.py.

fava_tpu formed the three velocity transforms as planar re/im matrix
products (no complex dtype on the TPU), the input format of its fused
powers + fold + binning kernel. Here the transforms are one cuFFT call
over the stacked volumes, and the planar pair is the two halves of
``torch.view_as_real`` of its complex output: views, no copy; the
fused binning (B9) reads them in place. fava_tpu's ``karatsuba`` option
(three real products per complex axis instead of four) saved matrix-unit
work on the TPU and has no counterpart in an FFT: it is not carried over.
"""

from __future__ import annotations

import math

import torch

from fava_tpu_torch.experiments import fused_dft
from fava_tpu_torch.ops import cuda_kernels


def rfftn_planar_stacked(vols, norm: str = "backward"):
    """(re, im), each (3, nx, ny, nz//2+1): the rfftn of three real
    volumes (a sequence, or one (3, nx, ny, nz) tensor), unnormalized as
    fava_tpu's ``rfftn_mxu_planar_stacked`` unless ``norm`` says
    otherwise (torch.fft's names). One transform over the stacked
    volumes; re and im are views of its complex output."""
    x = vols if isinstance(vols, torch.Tensor) else torch.stack(list(vols))
    r = torch.view_as_real(torch.fft.rfftn(x, dim=(1, 2, 3), norm=norm))
    return r[..., 0], r[..., 1]


def velocity_transforms(dens, vels):
    """(re, im), each (3, nx, ny, nz//2+1): the normalized (1/ntot) rfftn
    of sqrt(rho)*v of the three components, one stacked cuFFT call."""
    shape = tuple(int(s) for s in dens.shape)
    sq = torch.sqrt(dens)
    w = torch.empty((3,) + shape, dtype=dens.dtype, device=dens.device)
    for c, v in enumerate(vels):
        torch.mul(sq, v, out=w[c])
    del sq
    return rfftn_planar_stacked(w, norm="forward")


def velocity_transforms_fused_zy(dens, vels):
    """``velocity_transforms`` through the fused z+y transform (B12) and
    cuFFT along x, component by component."""
    shape = tuple(int(s) for s in dens.shape)
    sq = torch.sqrt(dens)
    cdt = torch.complex64 if dens.dtype == torch.float32 else torch.complex128
    spec = torch.empty((3, shape[0], shape[1], shape[2] // 2 + 1), dtype=cdt, device=dens.device)
    for c, v in enumerate(vels):
        spec[c] = fused_dft.rfftn_fused(sq * v)
    del sq
    r = torch.view_as_real(spec.div_(math.prod(shape)))
    return r[..., 0], r[..., 1]


def rfft_shell_sums_fused(dens, vels, nbins: int):
    """(counts, sums[3]) of the kinetic-energy power of sqrt(rho)*v of a 3D
    volume with even x and y extents: ``velocity_transforms``, then the
    powers, fold and shell binning in one kernel pass (B9). fava_tpu's
    fused-spectrum path (scripts/tpu_fused_bin_probe.py); the same result
    as the main path's ``ops.spectra.rfft_shell_sums``."""
    re, im = velocity_transforms(dens, vels)
    return cuda_kernels.shell_bin_powers_fused(re, im, nbins, int(dens.shape[2]))


def rfft_shell_sums_fused_zy(dens, vels, nbins: int):
    """``rfft_shell_sums_fused`` with the transforms of
    ``velocity_transforms_fused_zy`` (fava_tpu's ``rfftn_mxu_fused``)."""
    re, im = velocity_transforms_fused_zy(dens, vels)
    return cuda_kernels.shell_bin_powers_fused(re, im, nbins, int(dens.shape[2]))
