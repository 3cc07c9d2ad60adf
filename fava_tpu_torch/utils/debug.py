"""Debug / correctness-check toggles.

Counterpart of fava_tpu/utils/debug.py. The failure modes that remain
in an eager single-controller port are numerical: ``enable_checks``
traps NaN (not Inf, as ``jax_debug_nans``) in the output of every torch
op, through a dispatch mode on the calling thread, and in the output of
every hand-written CUDA kernel, which writes through raw pointers that
no dispatch mode sees: its launch helper (``ops/cuda_kernels._launch``)
checks the tensors each launch wrote while ``NAN_CHECKS`` is set. Each
check waits for the device, which is why checks are off unless asked
for; with them off a launch reads one flag.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Read by ops/cuda_kernels._launch after every kernel launch.
NAN_CHECKS: bool = False


def _holds_nan(t) -> bool:
    return (
        isinstance(t, torch.Tensor)
        and (t.is_floating_point() or t.is_complex())
        and bool(torch.isnan(t).any())
    )


def check_outputs(name: str, outputs) -> None:
    """Raise FloatingPointError naming ``name`` when a floating tensor
    of ``outputs`` holds a NaN."""
    if any(_holds_nan(t) for t in outputs):
        raise FloatingPointError(f"invalid value (nan) encountered in {name}")


# Ops whose outputs hold no computed value: allocations, whose memory is
# not initialized (reused memory may hold NaN bits until a kernel or an op
# writes it). Views of inputs are skipped too.
_ALLOCATIONS = frozenset(
    ("empty", "empty_like", "empty_strided", "empty_permuted", "new_empty", "new_empty_strided")
)


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket.__name__ in _ALLOCATIONS):
            check_outputs(str(func), tree_leaves(out))
        return out


_MODE: Optional[_NanCheck] = None


def enable_checks(nan_checks: bool = True, disable_jit: bool = False) -> None:
    """Trap the first NaN in a torch op's or a kernel's floating output
    (FloatingPointError). ``disable_jit`` has no counterpart in an eager
    port: it is accepted and does nothing."""
    global NAN_CHECKS, _MODE
    if nan_checks and _MODE is None:
        _MODE = _NanCheck()
        _MODE.__enter__()
        NAN_CHECKS = True


def disable_checks() -> None:
    """Turn the NaN checks off; no mode of this module stays on the stack."""
    global NAN_CHECKS, _MODE
    NAN_CHECKS = False
    if _MODE is not None:
        mode, _MODE = _MODE, None
        mode.__exit__(None, None, None)
