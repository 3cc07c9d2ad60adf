"""Device and floating-point policy.

Deviation from fava_tpu/utils/precision.py: there the accumulators are
float32 on the TPU (float64 is emulated and slow), which forced the
two-stage reductions of its Pallas kernels. Hopper has native float64,
so here every accumulator (row moments, shell sums, profiles, counts)
is float64 on every device. Bulk field data is float32 on CUDA and
float64 on the CPU, where the tests hold the port to fava_tpu in
float64.

``set_compute_dtype`` overrides the field dtype on every device (float64
fields on the card, say); ``None`` restores the per-device default.

Every public entry of the package takes ``device=`` (default "cuda").
A CUDA request on a machine without CUDA raises: nothing moves to the
CPU on its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_OVERRIDE: Optional[torch.dtype] = None


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or what numpy reads as a dtype, as a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


def set_compute_dtype(dtype) -> None:
    """Force the field dtype on every device (a torch dtype or anything
    numpy reads as a float dtype); ``None`` restores the default policy.
    The CUDA kernels take float32 volumes, so under a float64 override
    their wrappers raise on the card: the override serves the analyses
    that run as plain torch."""
    global _OVERRIDE
    if dtype is not None:
        dtype = _torch_dtype(dtype)
    if dtype is not None and not dtype.is_floating_point:
        raise TypeError(f"set_compute_dtype takes a floating dtype, got {dtype}")
    _OVERRIDE = dtype


def field_dtype(device) -> torch.dtype:
    """Dtype of bulk field volumes on ``device``."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def compute_dtype(device="cuda") -> torch.dtype:
    """fava_tpu's name for ``field_dtype``."""
    return field_dtype(device)


def complex_dtype(device="cuda") -> torch.dtype:
    """The complex dtype of transforms of ``compute_dtype`` fields."""
    return torch.complex128 if field_dtype(device) == torch.float64 else torch.complex64


def to_device(array, dtype=None, device="cuda") -> torch.Tensor:
    """Host array -> tensor on ``device``. With no ``dtype`` only floating
    data takes the field dtype (integer tags and indices keep theirs); an
    explicit ``dtype`` is always honoured."""
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(array))
    if dtype is not None:
        dt = _torch_dtype(dtype)
    elif t.is_floating_point():
        dt = field_dtype(dev)
    else:
        dt = t.dtype
    return t.to(device=dev, dtype=dt)


def asdevice(x, dtype=None, device="cuda") -> torch.Tensor:
    """``x`` (array, tensor or number) as a tensor on ``device`` in
    ``dtype`` (the field dtype when None)."""
    dev = resolve_device(device)
    dt = field_dtype(dev) if dtype is None else _torch_dtype(dtype)
    return torch.as_tensor(x, dtype=dt, device=dev)


def accum_dtype() -> torch.dtype:
    """Dtype of small accumulators (profiles, spectra, counts): always float64."""
    return torch.float64
