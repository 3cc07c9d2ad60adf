"""Device and floating-point policy.

Deviation from fava_tpu/utils/precision.py: there the accumulators are
float32 on the TPU (float64 is emulated and slow), which forced the
two-stage reductions of its Pallas kernels. Hopper has native float64,
so here every accumulator (row moments, shell sums, profiles, counts)
is float64 on every device. Bulk field data is float32 on CUDA and
float64 on the CPU, where the tests hold the port to fava_tpu in
float64.

Every public entry of the package takes ``device=`` (default "cuda").
A CUDA request on a machine without CUDA raises: nothing moves to the
CPU on its own.
"""

from __future__ import annotations

import torch


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


def field_dtype(device) -> torch.dtype:
    """Dtype of bulk field volumes on ``device``."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def accum_dtype() -> torch.dtype:
    """Dtype of small accumulators (profiles, spectra, counts): always float64."""
    return torch.float64
