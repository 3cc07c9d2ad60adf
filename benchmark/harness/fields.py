"""Random fields for the generators, made on the device from a torch.Generator."""

from __future__ import annotations

import math

import torch

# x planes of the half-spectrum scaled at a time (bounds the temporaries)
_BLOCK_ELEMS = 1 << 26


def _wavenumbers(n: int, device) -> torch.Tensor:
    """Integer wavenumbers in FFT order, as float32: 0..n/2-1, -n/2..-1."""
    k = torch.arange(n, device=device)
    return torch.where(k <= (n - 1) // 2, k, k - n).to(torch.float32)


def mode_exponent(energy_slope: float, ndim: int) -> float:
    """Exponent of the Fourier amplitude |f(k)| ~ |k|^a of a field whose
    shell spectrum goes as k^energy_slope in ``ndim`` dimensions (a shell
    holds ~k^(ndim-1) modes)."""
    return (energy_slope - (ndim - 1)) / 2.0


def gaussian_field(out: torch.Tensor, exponent: float, gen: torch.Generator) -> torch.Tensor:
    """Fill the real 2D or 3D float32 tensor ``out`` with a periodic
    Gaussian random field of zero mean and unit variance whose Fourier
    amplitudes go as |k|^exponent, the k = 0 mode removed: white noise
    from ``gen``, shaped in Fourier space, transformed back into ``out``."""
    shape = tuple(out.shape)
    out.normal_(generator=gen)
    spec = torch.fft.rfftn(out)
    dev = out.device
    axes = [_wavenumbers(n, dev) for n in shape[:-1]]
    axes.append(torch.arange(shape[-1] // 2 + 1, device=dev, dtype=torch.float32))
    step = max(1, _BLOCK_ELEMS // math.prod(spec.shape[1:]))
    for x0 in range(0, shape[0], step):
        k2 = 0.0
        for axis, k in enumerate(axes):
            k = k[x0 : x0 + step] if axis == 0 else k
            view = [1] * len(shape)
            view[axis] = k.numel()
            k2 = k2 + k.square().reshape(view)
        amp = torch.where(k2 > 0, k2.clamp(min=1.0).pow(exponent / 2.0), torch.zeros_like(k2))
        spec[x0 : x0 + step] *= amp
        del k2, amp
    torch.fft.irfftn(spec, s=shape, out=out)
    del spec
    out.sub_(out.mean(dtype=torch.float64).to(out.dtype))
    rms = torch.linalg.vector_norm(out, dtype=torch.float64) / math.sqrt(out.numel())
    out.div_(rms.to(out.dtype))
    return out
