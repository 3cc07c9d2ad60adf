"""The fused z+y transform: counterpart of fava_tpu/experiments/pallas_dft.py.

fava_tpu's dense rfftn applied one matrix product per axis; its Pallas
kernel did the z-rfft and the y-DFT of an x-slab in one pass, keeping the
slab's intermediate in VMEM. Here that kernel is B12
(``ops.cuda_kernels.zy_rfft_planar``, ``csrc/dft_kernels.cu``): a
cluster FFT kernel that keeps the slab's intermediate in a thread-block
cluster's shared memory, for every y and z extent up to 1024 (mixed
radix, or Bluestein's algorithm for an extent with a prime factor above
7); the dense DFT products of ``ops/dft.py`` are the plain twin on the
CPU. The x axis, which fava_tpu contracted with a
dense einsum, is cuFFT (``torch.fft.fft``).

``use_fused_zy(shape)`` is the kernels' own size check
(``ops.cuda_kernels.zy_rfft_fits``): fava_tpu's gate (multiples of 128,
ny*nz <= 512^2) was its matrix unit's tiling and VMEM; here the kernel
takes y and z extents up to 1024.
"""

from __future__ import annotations

import torch

from fava_tpu_torch.ops.cuda_kernels import zy_rfft_fits as use_fused_zy
from fava_tpu_torch.ops.cuda_kernels import zy_rfft_planar

__all__ = ["rfftn_fused", "use_fused_zy", "zy_rfft_planar"]


def rfftn_fused(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized rfftn of a real 3D volume: the fused z+y transform,
    then cuFFT along x (fava_tpu's ``rfftn_mxu_fused``, whose x axis was a
    dense einsum). Complex, (nx, ny, nz//2+1)."""
    re, im = zy_rfft_planar(x)
    return torch.fft.fft(torch.complex(re, im), dim=0)
