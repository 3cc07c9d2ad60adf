"""Spectral power volumes of z-rfft half-spectra (plain torch).

Counterpart of fava_tpu/ops/spectra.py:50-119. The transforms feeding
this module are ``torch.fft.rfftn`` (cuFFT on the card); fava_tpu's
dense-DFT matmuls exist only for the TPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _wavenumbers(n: int, dtype, device) -> torch.Tensor:
    """Integer wavenumbers in unshifted FFT order: [0..n/2-1, -n/2..-1]."""
    k = torch.arange(n, device=device)
    return torch.where(k <= (n - 1) // 2, k, k - n).to(dtype)


def _split_nyquist(k: torch.Tensor, n: int, idx: torch.Tensor):
    """Signed wavenumbers -> (conjugate-even part, Nyquist magnitude).

    Even extents place the self-conjugate Nyquist mode at idx == n//2
    (signed value -n/2); odd extents have none.
    """
    if n % 2 == 0:
        is_nyq = idx == n // 2
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        nyq = torch.full((), n / 2.0, dtype=k.dtype, device=k.device)
        return torch.where(is_nyq, zero, k), torch.where(is_nyq, nyq, zero)
    return k, torch.zeros_like(k)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real.square() + z.imag.square()


def rfft_power_volumes(
    ffts: Sequence[torch.Tensor], full_shape: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, longi) power volumes of the three velocity half-spectra.

    Shell-binning these with Hermitian weights reproduces the full-grid
    computation exactly. For the longitudinal projection that needs the
    Nyquist split: weight-2 planes (kz > 0) use |reg.w|^2 + |nyq.w|^2
    and the kz = 0 plane uses |reg.w - nyq.w|^2 (the derivation is in
    fava_tpu/ops/spectra.py:68-87). Unlike fava_tpu, the transverse
    volume and |k| are not returned: the binning forms transverse sums
    as total - longitudinal, and in eager mode each extra volume would
    cost a full pass. Both volumes are returned contiguous.
    """
    nx, ny, nz = full_shape
    nzr = ffts[0].shape[-1]
    rdt = ffts[0].real.dtype
    dev = ffts[0].device
    jx = torch.arange(nx, device=dev)[:, None, None]
    jy = torch.arange(ny, device=dev)[None, :, None]
    jz = torch.arange(nzr, device=dev)[None, None, :]
    kx = _wavenumbers(nx, rdt, dev)[:, None, None]
    ky = _wavenumbers(ny, rdt, dev)[None, :, None]
    kz = jz.to(rdt)

    total = 0.5 * (_abs2(ffts[0]) + _abs2(ffts[1]) + _abs2(ffts[2]))

    kx_r, kx_n = _split_nyquist(kx, nx, jx)
    ky_r, ky_n = _split_nyquist(ky, ny, jy)
    kz_r, kz_n = _split_nyquist(kz, nz, jz)
    reg = kx_r * ffts[0] + ky_r * ffts[1] + kz_r * ffts[2]
    nyq = kx_n * ffts[0] + ky_n * ffts[1] + kz_n * ffts[2]

    # k2 is integer-valued: clamping at 1 only touches k = 0, where the
    # projections are exactly 0 (fava_tpu's 1e-30 guard gives the same).
    inv_k2 = 1.0 / torch.clamp(kx * kx + ky * ky + kz * kz, min=1.0)
    longi = torch.where(jz == 0, _abs2(reg - nyq), _abs2(reg) + _abs2(nyq)) * inv_k2
    # cuFFT may return permuted strides, which elementwise ops keep; the
    # binning kernels take row-major volumes.
    return total.contiguous(), longi.contiguous()
