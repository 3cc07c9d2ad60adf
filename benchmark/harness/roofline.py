"""Peaks, and the least time of the port's kernels by role.

A kernel's least time is the larger of the bytes it must move (each
input it needs read once, each output written once) over the memory rate
and its arithmetic over the float32 rate outside the tensor cores:
NVIDIA H100 SXM at its full 700 W (the data sheet's 3.35 TB/s and 67
TFLOP/s). A role file under ``benchmark/kernels/`` states which kernels
it matches (``NAMES``, regular expressions on the trace's kernel name),
which launch counters of ``ops/cuda_kernels.launch_counts()`` count them
(``COUNTERS``), and ``work(kernel, ctx) -> (bytes, flops)`` of one
launch, or None where the cell's shapes do not give it. A kernel that
later takes over a role is held to the role's work.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


@dataclass
class Ctx:
    """What a role's work may read: the cell's (nx, ny, nz)."""

    shape: Tuple[int, int, int]

    @property
    def nbins(self) -> int:
        return max(self.shape) // 2 - 1


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S)


def _inside(kx: np.ndarray, ky: np.ndarray, nzr: int, nbins: int) -> int:
    """Cells (i, j, z), z in [0, nzr), with |kx_i|^2 + |ky_j|^2 + z^2 inside
    the last shell (|k| < nbins - 0.5, i.e. k^2 <= nbins^2 - nbins)."""
    rem = (nbins * nbins - nbins) - (kx.astype(np.int64)[:, None] ** 2 + ky.astype(np.int64)[None, :] ** 2)
    zmax = np.floor(np.sqrt(np.maximum(rem, 0).astype(np.float64))).astype(np.int64)
    zmax -= (zmax * zmax > rem).astype(np.int64)
    zmax += ((zmax + 1) ** 2 <= rem).astype(np.int64)
    return int(np.where(rem >= 0, np.minimum(zmax + 1, nzr), 0).sum())


def _signed(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.where(k <= (n - 1) // 2, k, k - n)


@lru_cache(maxsize=64)
def folded_inside(nx: int, ny: int, nz: int, nbins: int) -> int:
    """Cells of the quadrant-folded (nx/2+1, ny/2+1, nz/2+1) power inside
    the last shell: what a folded binning must read of each channel."""
    return _inside(np.arange(nx // 2 + 1), np.arange(ny // 2 + 1), nz // 2 + 1, nbins)


@lru_cache(maxsize=64)
def unfolded_inside(nx: int, ny: int, nz: int, nbins: int) -> int:
    """Cells of the (nx, ny, nz/2+1) half-spectrum inside the last shell."""
    return _inside(np.abs(_signed(nx)), np.abs(_signed(ny)), nz // 2 + 1, nbins)


def template_args(name: str, kernel: str) -> List[str]:
    """The template arguments of ``kernel<...>`` in a trace name."""
    m = re.search(rf"{re.escape(kernel)}<([^>]*)>", name)
    return [a.strip() for a in m.group(1).split(",")] if m else []


def role_of(name: str, roles: Sequence) -> Optional[object]:
    for role in roles:
        if any(re.search(p, name) for p in role.NAMES):
            return role
    return None


@dataclass
class KernelRow:
    role: str
    name: str
    launches: int = 0
    traced_us: float = 0.0
    bound_us: Optional[float] = 0.0


def kernel_table(ops, roles: Sequence, ctx: Ctx) -> List[KernelRow]:
    """One row per kernel name among ``ops`` (the port's own kernels):
    its role, launches, traced and least microseconds (None when its
    role does not give the work)."""
    rows: Dict[str, KernelRow] = {}
    for op in ops:
        row = rows.get(op.name)
        if row is None:
            role = role_of(op.name, roles)
            row = rows[op.name] = KernelRow(role.ROLE if role else "unmatched", op.name)
            work = role.work(op.name, ctx) if role else None
            row.bound_us = None if work is None else 1e6 * least_seconds(*work)
        row.launches += 1
        row.traced_us += op.dur
    return list(rows.values())


def launch_check(ops, roles: Sequence, launches: Dict[str, int]) -> List[Tuple[str, int, int]]:
    """(role, kernels in the trace, launches counted) of each role with
    counters, and of the kernels no role matches (counted: 0)."""
    traced: Dict[str, int] = {}
    for op in ops:
        role = role_of(op.name, roles)
        key = role.ROLE if role else "unmatched"
        traced[key] = traced.get(key, 0) + 1
    out = []
    for role in roles:
        if role.COUNTERS:
            out.append((role.ROLE, traced.get(role.ROLE, 0),
                        sum(int(launches.get(c, 0)) for c in role.COUNTERS)))
    if traced.get("unmatched"):
        out.append(("unmatched", traced["unmatched"], 0))
    return out


def zy_fft_ops(nx: int, ny: int, nz: int) -> float:
    """Operations of a real z-transform of each of the nx*ny rows (2.5 nz
    log2 nz) and a complex y-transform of each of the nx*(nz/2+1) columns
    (5 ny log2 ny): the cheapest known way, as FFTs."""
    return (nx * ny * 2.5 * nz * math.log2(max(nz, 2))
            + nx * (nz // 2 + 1) * 5 * ny * math.log2(max(ny, 2)))
