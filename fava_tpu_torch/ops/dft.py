"""Dense DFT matrices (host numpy): the plain twin of the fused z+y
transform kernel (B12) applies them as matmuls.

Jax-free copy of the two matrix builders of fava_tpu/ops/dft.py
(``_rdft_mats`` :72, ``_dft_mat`` :82). Nothing else of that module is
ported: it applied these matrices on the TPU's matrix unit in place of
an FFT, and the port's transforms are cuFFT (``torch.fft``). The cached
arrays are read-only, shared by every caller.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=16)
def _rdft_mats(n: int, dtype_name: str):
    """Real-to-halfcomplex DFT matrices: (cos, -sin), each (n, n//2+1)."""
    k = np.arange(n // 2 + 1)
    j = np.arange(n)[:, None]
    ang = 2.0 * np.pi * j * k / n
    dt = np.dtype(dtype_name)
    mats = np.cos(ang).astype(dt), (-np.sin(ang)).astype(dt)
    for m in mats:
        m.setflags(write=False)
    return mats


@lru_cache(maxsize=16)
def _dft_mat(n: int, dtype_name: str):
    """Complex DFT matrix exp(-2*pi*i*j*k/n), (n, n)."""
    j = np.arange(n)[:, None]
    k = np.arange(n)
    ang = -2.0 * np.pi * j * k / n
    cdt = np.complex128 if np.dtype(dtype_name) == np.float64 else np.complex64
    mat = np.exp(1j * ang).astype(cdt)
    mat.setflags(write=False)
    return mat
