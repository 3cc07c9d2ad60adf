"""Hand-written CUDA kernels of the flagship step, with their plain twins.

Counterpart of fava_tpu/ops/pallas_kernels.py for the four Pallas
kernels on the flagship path (sources and design notes in
``fava_tpu_torch/csrc/flagship_kernels.cu``):

=============================  ===========================================
wrapper                        replaces (fava_tpu/ops/pallas_kernels.py)
=============================  ===========================================
``row_moments_volume``         ``_moments_kernel`` (:95)
``centered_row_moments``       ``_centered_kernel`` (:200)
``fold_quadrants_pair``        ``_fold_pair_kernel`` (:678)
``shell_bin_values_folded``    ``_shell_kernel_folded_v3`` (:955)
=============================  ===========================================

Every wrapper takes the plain PyTorch version of its function (the
``_*_plain`` functions below) only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; any other device raises.
Kernels take float32 volumes and produce float64 sums. A successful
launch adds one to the kernel's count in ``launch_counts()``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import _build
from fava_tpu_torch.utils import accum_dtype

NMOM = 13  # raw row moments
NCEN = 9  # 6 centered covariances + 3 centered first moments

KERNELS = ("row_moments", "centered_row_moments", "fold_quadrants_pair", "shell_bin_values_folded")
_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Dispatch helpers


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a consistent set of tensors; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device type {kind!r}")
    return kind


def _check_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def _vec_ok(row_len: int, *tensors: torch.Tensor) -> int:
    """1 when every row starts 16-byte aligned (float4 loads), else 0."""
    return int(row_len % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


@lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(kernel: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _build.library().fava_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")
    _LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# K1: the 13 raw per-row moments


def _row_moments_plain(d, vx, vy, vz) -> torch.Tensor:
    d, vx, vy, vz = (a.to(accum_dtype()) for a in (d, vx, vy, vz))

    def rows(a):
        return a.sum(dim=(1, 2))

    dvx, dvy, dvz = d * vx, d * vy, d * vz
    return torch.stack(
        [
            rows(d),
            rows(vx),
            rows(vy),
            rows(vz),
            rows(dvx),
            rows(dvy),
            rows(dvz),
            rows(dvx * vx),
            rows(dvx * vy),
            rows(dvx * vz),
            rows(dvy * vy),
            rows(dvy * vz),
            rows(dvz * vz),
        ]
    )


def row_moments_volume(dens, vx, vy, vz) -> torch.Tensor:
    """(13, nx) float64 row moments of a uniform volume, profile along x:
    [d, vx, vy, vz, d*vx, d*vy, d*vz, d*vxvx, d*vxvy, d*vxvz, d*vyvy,
    d*vyvz, d*vzvz]."""
    name = "row_moments"
    fields = (dens, vx, vy, vz)
    if _device_kind(name, *fields) == "cpu":
        return _row_moments_plain(*fields)
    _check_cuda(name, *fields)
    if dens.ndim != 3 or any(f.shape != dens.shape for f in fields) or dens.numel() == 0:
        raise ValueError(f"{name}: four non-empty same-shaped 3D volumes required")
    nx, ny, nz = dens.shape
    out = torch.empty((NMOM, nx), dtype=torch.float64, device=dens.device)
    lib = _build.library()
    row_len = ny * nz
    _launch(
        name, dens.device, lib.fava_row_moments, *(f.data_ptr() for f in fields), out.data_ptr(),
        nx, row_len, _vec_ok(row_len, *fields),
    )
    return out


# ---------------------------------------------------------------------------
# K2: centered second moments about the per-row means


def _centered_plain(d, vx, vy, vz, means) -> torch.Tensor:
    d, vx, vy, vz = (a.to(accum_dtype()) for a in (d, vx, vy, vz))
    means = means.to(accum_dtype())

    def rows(a):
        return a.sum(dim=(1, 2))

    cx = vx - means[0][:, None, None]
    cy = vy - means[1][:, None, None]
    cz = vz - means[2][:, None, None]
    dcx, dcy, dcz = d * cx, d * cy, d * cz
    return torch.stack(
        [
            rows(dcx * cx),
            rows(dcx * cy),
            rows(dcx * cz),
            rows(dcy * cy),
            rows(dcy * cz),
            rows(dcz * cz),
            rows(dcx),
            rows(dcy),
            rows(dcz),
        ]
    )


def centered_row_moments(dens, vx, vy, vz, means) -> torch.Tensor:
    """(9, nx) float64: [sum d*ci*cj (xx,xy,xz,yy,yz,zz), sum d*ci (3)],
    ci = vi - means[i] per row; ``means`` is (3, nx)."""
    name = "centered_row_moments"
    fields = (dens, vx, vy, vz)
    if _device_kind(name, *fields, means) == "cpu":
        return _centered_plain(*fields, means)
    _check_cuda(name, *fields)
    _check_cuda(name, means, dtype=torch.float64)
    if dens.ndim != 3 or any(f.shape != dens.shape for f in fields) or dens.numel() == 0:
        raise ValueError(f"{name}: four non-empty same-shaped 3D volumes required")
    nx, ny, nz = dens.shape
    if means.shape != (3, nx):
        raise ValueError(f"{name}: means must be (3, {nx}), got {tuple(means.shape)}")
    out = torch.empty((NCEN, nx), dtype=torch.float64, device=dens.device)
    lib = _build.library()
    row_len = ny * nz
    _launch(
        name, dens.device, lib.fava_centered_row_moments, *(f.data_ptr() for f in fields),
        means.data_ptr(), out.data_ptr(), nx, row_len, _vec_ok(row_len, *fields),
    )
    return out


# ---------------------------------------------------------------------------
# K3: quadrant fold of the total and longitudinal power


def _fold_plain(v: torch.Tensor) -> torch.Tensor:
    """Sum the negative-frequency x/y halves onto the non-negative
    quadrant: (nx, ny, nzr) -> (nx//2+1, ny//2+1, nzr). Index 0 and, for
    even extents, n/2 are their own mirrors and are counted once."""
    for axis in (0, 1):
        n = v.shape[axis]
        nh = n // 2 + 1
        top = v.narrow(axis, 0, nh).clone()
        rest = v.narrow(axis, nh, n - nh).flip(axis)
        top.narrow(axis, 1, n - nh).add_(rest)
        v = top
    return v


def fold_quadrants_pair(total, longi) -> Tuple[torch.Tensor, torch.Tensor]:
    """(folded_total, folded_longi), each (nx//2+1, ny//2+1, nzr), for
    even nx and ny."""
    name = "fold_quadrants_pair"
    if total.ndim != 3 or longi.shape != total.shape:
        raise ValueError(f"{name}: two same-shaped 3D volumes required")
    nx, ny, nzr = total.shape
    if nx % 2 or ny % 2:
        raise ValueError(f"{name}: even x and y extents required, got {tuple(total.shape)}")
    if _device_kind(name, total, longi) == "cpu":
        return _fold_plain(total), _fold_plain(longi)
    _check_cuda(name, total, longi)
    fshape = (nx // 2 + 1, ny // 2 + 1, nzr)
    to = torch.empty(fshape, dtype=total.dtype, device=total.device)
    lo = torch.empty_like(to)
    blocks = max(1, min(-(-to.numel() // 256), 8 * _sm_count(total.device.index or 0)))
    _launch(
        name, total.device, _build.library().fava_fold_quadrants_pair,
        total.data_ptr(), longi.data_ptr(), to.data_ptr(), lo.data_ptr(), nx, ny, nzr, blocks,
    )
    return to, lo


# ---------------------------------------------------------------------------
# K4: values-only shell binning of the folded quadrant


def _z_weights(nzr: int, full_nz: int, device) -> torch.Tensor:
    """Hermitian kz weights: 1 on self-conjugate planes, 2 elsewhere."""
    jz = torch.arange(nzr, device=device)
    self_conj = jz == 0
    if full_nz % 2 == 0:
        self_conj |= jz == full_nz // 2
    return torch.where(self_conj, 1.0, 2.0).to(accum_dtype())


def _folded_shells(fshape, nbins: int, full_ny: int, device) -> torch.Tensor:
    """Shell index of every folded cell; ``nbins`` marks dropped cells.
    |k| is taken in float32 as the kernel does (k^2 is an exact integer
    there)."""
    nxh, rows, nzr = fshape
    i = torch.arange(nxh, device=device)[:, None, None]
    j = torch.arange(rows, device=device)[None, :, None]
    z = torch.arange(nzr, device=device)[None, None, :]
    k = torch.sqrt((i * i + j * j + z * z).to(torch.float32))
    shell = torch.floor(k + 0.5).to(torch.int64)
    valid = (k <= nbins - 0.5) & (j <= full_ny // 2)
    return torch.where(valid, torch.clamp(shell, max=nbins - 1), nbins)


def _shell_bin_folded_plain(total, longi, nbins, full_ny, full_nz) -> torch.Tensor:
    fshape = tuple(total.shape)
    shell = _folded_shells(fshape, nbins, full_ny, total.device).reshape(-1)
    wz = _z_weights(fshape[2], full_nz, total.device)
    vals = torch.stack([total, longi]).to(accum_dtype()) * wz
    out = torch.zeros((2, nbins + 1), dtype=accum_dtype(), device=total.device)
    out.index_add_(1, shell, vals.reshape(2, -1))
    return out[:, :nbins]


def shell_bin_values_folded(total, longi, nbins: int, full_ny: int, full_nz: int):
    """(2, nbins) float64 Hermitian-weighted shell sums of the folded
    total and longitudinal power (values only: counts are the static
    ``_folded_counts``)."""
    name = "shell_bin_values_folded"
    if total.ndim != 3 or longi.shape != total.shape or nbins < 1:
        raise ValueError(f"{name}: two same-shaped 3D volumes and nbins >= 1 required")
    if _device_kind(name, total, longi) == "cpu":
        return _shell_bin_folded_plain(total, longi, nbins, full_ny, full_nz)
    _check_cuda(name, total, longi)
    nxh, rows, nzr = total.shape
    out = torch.zeros((2, nbins), dtype=torch.float64, device=total.device)
    warps = 256 // 32
    blocks = max(1, min(-(-(nxh * rows) // warps), 4 * _sm_count(total.device.index or 0)))
    _launch(
        name, total.device, _build.library().fava_shell_bin_values_folded,
        total.data_ptr(), longi.data_ptr(), out.data_ptr(), nxh, rows, nzr, int(nbins), full_ny,
        full_nz, blocks,
    )
    return out


@lru_cache(maxsize=8)
def _folded_counts(
    fshape: Tuple[int, int, int], nbins: int, full_nx: int, full_ny: int, full_nz: int
) -> np.ndarray:
    """Per-shell unfold-multiplicity counts: a pure shape function in
    host numpy (fava_tpu/ops/pallas_kernels.py:1198). Each folded cell
    stands for mx*my original (kx, ky) partners and carries the
    Hermitian kz weight wz; integer weights sum exactly. Read-only: the
    cached array is shared by every caller."""
    nxh, _rows, nzr = fshape
    nyh = full_ny // 2 + 1
    ix = np.arange(nxh, dtype=np.float32)
    jy = np.arange(nyh, dtype=np.float32)
    jz = np.arange(nzr, dtype=np.float32)

    def mult(idx, n):
        self_conj = idx == 0
        if n % 2 == 0:
            self_conj |= idx == n // 2
        return np.where(self_conj, 1.0, 2.0)

    k_abs = np.sqrt(ix[:, None, None] ** 2 + jy[None, :, None] ** 2 + jz[None, None, :] ** 2)
    shell = np.floor(k_abs + 0.5).astype(np.int64)
    shell = np.where(k_abs <= (nbins - 0.5), np.minimum(shell, nbins - 1), nbins)
    w = mult(ix, full_nx)[:, None, None] * mult(jy, full_ny)[None, :, None] * mult(jz, full_nz)
    counts = np.bincount(shell.ravel(), weights=w.ravel(), minlength=nbins + 1)[:nbins]
    counts.setflags(write=False)
    return counts


def shell_bin_sums_rfft(total, longi, nbins: int, full_nz: int):
    """(counts, sums[3]) Hermitian shell binning of rfft half-spectrum
    power volumes: fold, then folded values-only binning, with the
    static counts. sums = [total, longitudinal, transverse], transverse
    being total - longitudinal bin by bin (exact in exact arithmetic).

    Odd x or y extents need the unfolded binning kernel (fava_tpu's
    ``_shell_kernel``), which is not ported yet: they raise
    NotImplementedError (ROADMAP B10) on every device.
    """
    nx, ny, nzr = (int(s) for s in total.shape)
    if nx % 2 or ny % 2:
        raise NotImplementedError(
            f"shell binning of odd x/y extents {(nx, ny)} needs the unfolded "
            "binning kernel, not ported yet (ROADMAP B10)"
        )
    ft, fl = fold_quadrants_pair(total, longi)
    sums2 = shell_bin_values_folded(ft, fl, int(nbins), ny, full_nz)
    counts = torch.tensor(
        _folded_counts(tuple(ft.shape), int(nbins), nx, ny, full_nz),
        dtype=accum_dtype(),
        device=sums2.device,
    )
    return counts, torch.stack([sums2[0], sums2[1], sums2[0] - sums2[1]])
