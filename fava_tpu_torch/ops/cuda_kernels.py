"""Hand-written CUDA kernels, with their plain twins.

Counterpart of the Pallas kernels of fava_tpu on the flagship, AMR,
stage-4, out-of-core and fused-spectrum paths (sources and design notes
in ``fava_tpu_torch/csrc/``: ``flagship_kernels.cu`` for K1-K3 and the
launches of K4 and B11, ``amr_kernels.cu`` for K5-K7, ``spectra_kernels.cu``
for the launches of B10 and B6, ``shell_bins.cuh`` for the shell-binning
walk that K4, B11, B10 and B6 run and B9 shares, ``pdf2d_kernels.cu`` for
B8, ``fused_spectra_kernels.cu`` for B9 and ``dft_kernels.cu`` for B12):

================================  ==============================================
wrapper                           replaces (fava_tpu/ops/, fava_tpu/experiments/)
================================  ==============================================
``row_moments_volume``            ``pallas_kernels.py:_moments_kernel`` (:95)
``centered_row_moments``          ``pallas_kernels.py:_centered_kernel`` (:200)
``fold_quadrants_pair``           ``pallas_kernels.py:_fold_pair_kernel`` (:678)
``shell_bin_values_folded``       ``pallas_kernels.py:_shell_kernel_folded_v3`` (:955)
``shell_bin_values_folded_1ch``   the same, one channel (scalar spectra, :1282)
``shell_bin_sums_unfolded``       ``pallas_kernels.py:_shell_kernel`` (:515)
``shell_bin_values_rfft_chunk``   ``pallas_kernels.py:_shell_kernel_chunkx`` (:1291)
(``longi`` None)                  the same, one channel (the sharded scalar spectrum)
``block_row_moments``             ``pallas_kernels.py:_raw_rows_kernel`` (:331)
``block_centered_row_moments``    ``pallas_kernels.py:_centered_rows_kernel`` (:352)
``regrid_fields``                 ``pallas_regrid.py:_regrid_kernel`` (:78)
``pdf2d_counts`` (unweighted)     ``pallas_pdf2d.py:_pdf2d_kernel`` (:75)
``pdf2d_counts`` (weighted)       ``pallas_pdf2d.py:_pdf2d_weighted_kernel`` (:91)
``shell_bin_powers_fused``        ``pallas_kernels.py:_powers_fold_bin_kernel`` (:1539)
``shell_bin_sums_folded_onepass`` ``pallas_kernels.py:_shell_kernel_folded`` (:758)
``shell_bin_values_folded_rows``  ``pallas_kernels.py:_shell_kernel_folded_v2`` (:851)
``zy_rfft_planar``                ``pallas_dft.py:_zy_rfft_kernel`` (:53)
``_zy_rfft_dense``                the same, dense DFT (on no route; a yardstick)
================================  ==============================================

The shell binnings take 1 to WALK_MAX_BINS shells: past SHELL_MAX_BINS
their kernels run the wide path of the walk (``shell_bins.cuh``).
``shell_bin_values_folded_rows`` is an alias of
``shell_bin_values_folded`` (K4's kernel serves both Pallas kernels); it
counts as K4. Every wrapper takes the plain PyTorch version of its function (the
``_*_plain`` functions below) only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; any other device raises.
Kernels take float32 volumes and produce float64 sums (the regrid
copies float32 values; the joint histogram counts in int64; the fused
z+y transform writes float32). A successful launch adds one to the
kernel's count in ``launch_counts()`` (the two pdf2d variants count as
``pdf2d_counts`` and ``pdf2d_weighted``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import _build, dft
from fava_tpu_torch.utils import accum_dtype, debug, resolve_device
from fava_tpu_torch.utils.profiling import SPAN_BINNING, SPAN_POWERS, SPAN_SYNC_COUNTS, annotate

NMOM = 13  # raw row moments
NCEN = 9  # 6 centered covariances + 3 centered first moments
NRAW = 7  # block-stack raw row moments: d, v_i, d*v_i
REGRID_MAX_FIELDS = 8  # fields per regrid launch (kRegridMaxFields)

KERNELS = (
    "row_moments",
    "centered_row_moments",
    "fold_quadrants_pair",
    "shell_bin_values_folded",
    "block_row_moments",
    "block_centered_row_moments",
    "regrid_fields",
    "shell_bin_values_folded_1ch",
    "shell_bin_sums_unfolded",
    "pdf2d_counts",
    "pdf2d_weighted",
    "shell_bin_values_rfft_chunk",
    "shell_bin_values_rfft_chunk_1ch",
    "shell_bin_powers_fused",
    "shell_bin_sums_folded_onepass",
    "zy_rfft_planar",
    "zy_rfft_planar_dense",
)
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


def _launch(kernel: str, device: torch.device, fn, *args, wrote=()) -> None:
    """Launch ``fn(*args, stream)`` on the current stream and count it.
    ``wrote``: the tensors the launch writes, checked for NaN while
    ``utils.debug`` checks are on."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _build.library().fava_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")
    _LAUNCHES[kernel] += 1
    if debug.NAN_CHECKS:
        debug.check_outputs(f"the CUDA kernel of {kernel}", wrote)


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
        nx, row_len, _vec_ok(row_len, *fields), wrote=(out,),
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
        means.data_ptr(), out.data_ptr(), nx, row_len, _vec_ok(row_len, *fields), wrote=(out,),
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
        wrote=(to, lo),
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


def _shell_index(k2: torch.Tensor, nbins: int) -> torch.Tensor:
    """The shell of each integer |k|^2 (int64), as the kernels classify
    it: floor(|k| + 0.5), ``nbins`` for a cell beyond the last shell (|k| >
    nbins - 0.5). Up to SHELL_MAX_BINS shells |k| is taken in float32
    (fava_tpu's kernels' formula; k^2 is an exact integer there), beyond in
    float64: the exact shell of the integer k^2 (the wide walk)."""
    k = torch.sqrt(k2.to(torch.float32 if nbins <= SHELL_MAX_BINS else torch.float64))
    shell = torch.floor(k + 0.5).to(torch.int64)
    return torch.where(k <= nbins - 0.5, torch.clamp(shell, max=nbins - 1), nbins)


def _folded_shells(fshape, nbins: int, full_ny: int, device) -> torch.Tensor:
    """Shell index of every folded cell; ``nbins`` marks dropped cells."""
    nxh, rows, nzr = fshape
    i = torch.arange(nxh, device=device)[:, None, None]
    j = torch.arange(rows, device=device)[None, :, None]
    z = torch.arange(nzr, device=device)[None, None, :]
    return torch.where(j <= full_ny // 2, _shell_index(i * i + j * j + z * z, nbins), nbins)


def _shell_sums(total, longi, shell, wz, nbins) -> torch.Tensor:
    """(C, nbins) sums of wz-weighted values by shell (C = 2, or 1 when
    ``longi`` is None); shell index nbins drops a cell."""
    vols = [total] if longi is None else [total, longi]
    vals = torch.stack(vols).to(accum_dtype()) * wz
    out = torch.zeros((len(vols), nbins + 1), dtype=accum_dtype(), device=total.device)
    out.index_add_(1, shell.reshape(-1), vals.reshape(len(vols), -1))
    return out[:, :nbins]


def _shell_bin_folded_plain(total, longi, nbins, full_ny, full_nz) -> torch.Tensor:
    """(C, nbins) shell sums of the folded volumes: C = 2, or 1 when
    ``longi`` is None."""
    fshape = tuple(total.shape)
    shell = _folded_shells(fshape, nbins, full_ny, total.device)
    return _shell_sums(total, longi, shell, _z_weights(fshape[2], full_nz, total.device), nbins)


def _shell_bin_folded(name: str, vols, nbins: int, full_ny: int, full_nz: int) -> torch.Tensor:
    total = vols[0]
    if total.ndim != 3 or any(v.shape != total.shape for v in vols) or nbins < 1:
        raise ValueError(f"{name}: same-shaped 3D volumes and nbins >= 1 required")
    longi = vols[1] if len(vols) == 2 else None
    if _device_kind(name, *vols) == "cpu":
        return _shell_bin_folded_plain(total, longi, nbins, full_ny, full_nz)
    _check_cuda(name, *vols)
    nxh, rows, nzr = total.shape
    _check_bins(name, nbins, (nxh - 1) ** 2 + (full_ny // 2) ** 2)
    out = torch.zeros((len(vols), nbins), dtype=torch.float64, device=total.device)
    _launch(
        name, total.device, _build.library().fava_shell_bin_values_folded,
        total.data_ptr(), None if longi is None else longi.data_ptr(), out.data_ptr(), nxh, rows,
        nzr, int(nbins), full_ny, full_nz, len(vols),
        _walk_blocks("fava_shell_bin_folded_blocks_per_sm", (len(vols), 0), len(vols), nxh * rows,
                     int(nbins), total.device),
        wrote=(out,),
    )
    return out


# ---------------------------------------------------------------------------
# The launch of the shell-binning walk (csrc/shell_bins.cuh): B6/B10, K4,
# B11a and B9. Up to SHELL_MAX_BINS shells (the narrow walk) a block has as
# many warps (up to BIN_MAX_WARPS) as shared memory holds f64 histograms
# for; beyond (the wide walk, up to WALK_MAX_BINS) BIN_MAX_WARPS warps add
# their runs to the output with global atomics. A warp a walk; the grid is
# one wave.

BIN_MAX_WARPS = 8  # kBinMaxWarps
SHELL_MAX_BINS = 4095  # kMaxBins: the narrow walk; (nbins + 1)^2 <= 2^24, binned |k|^2 exact in f32
WALK_MAX_BINS = 46000  # kMaxWideBins: every k^2 the wide walk steps to stays below 2^31
WALK_MAX_K2 = 2**31 - 1  # the largest kx^2 + ky^2 of a walk's row (int32)


def _check_bins(name: str, nbins: int, row_k2: int = 0) -> None:
    """The shell-binning kernels take 1 .. WALK_MAX_BINS shells, on rows
    whose kx^2 + ky^2 (at most ``row_k2``) fits int32: |k|^2 is an int32
    on the card (extents up to 2 x 32767 on two axes)."""
    if not 1 <= int(nbins) <= WALK_MAX_BINS or int(row_k2) > WALK_MAX_K2:
        raise ValueError(f"{name}: the CUDA walk bins 1 to WALK_MAX_BINS = {WALK_MAX_BINS} "
                         f"shells on rows of kx^2 + ky^2 <= {WALK_MAX_K2}, got {nbins} shells "
                         f"and rows up to {row_k2}")


def walk_smem_bytes(warps: int, channels: int, nbins: int) -> int:
    """Dynamic shared bytes of a walk block (walk_smem_bytes in
    csrc/shell_bins.cuh): in the narrow walk each warp's histogram of
    ``channels`` f64 channels, then the nbins + 2 int class thresholds."""
    hist = 0 if nbins > SHELL_MAX_BINS else warps * channels * nbins * 8
    return hist + (nbins + 2) * 4


def bin_block_warps(channels: int, nbins: int, smem_optin: int) -> int:
    """Warps of a walk block (walk_block_warps): as many as BIN_MAX_WARPS
    whose histograms fit ``smem_optin`` shared bytes, BIN_MAX_WARPS in the
    wide walk (nbins > SHELL_MAX_BINS); 0 when not even one fits or nbins
    lies outside 1 .. WALK_MAX_BINS."""
    if not 1 <= nbins <= WALK_MAX_BINS:
        return 0
    fixed = walk_smem_bytes(0, channels, nbins)
    if smem_optin <= fixed:
        return 0
    if nbins > SHELL_MAX_BINS:
        return BIN_MAX_WARPS
    return min(BIN_MAX_WARPS, (smem_optin - fixed) // (8 * channels * nbins))


def _wave_blocks(nwalks: int, warps: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of a walk launch over ``nwalks`` walks: a walk for each warp,
    at most as many blocks as the card holds at once (the warps stride over
    the walks; each block zeroes and flushes its own histograms)."""
    return max(1, min(-(-nwalks // warps), blocks_per_sm * sms))


@lru_cache(maxsize=64)
def walk_blocks_per_sm(entry: str, args: Tuple[int, ...], nbins: int, index: int = 0) -> int:
    """Blocks of a walk kernel that fit one SM of card ``index`` at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), from the C entry
    ``entry`` with ``args`` (the kernel's variant) and nbins."""
    with torch.cuda.device(index):
        n = getattr(_build.library(), entry)(*args, int(nbins))
    if n <= 0:
        raise RuntimeError(f"{entry}{args}: no block fits an SM for {nbins} shells "
                           f"(occupancy query {n})")
    return n


def walk_launch(entry: str, args: Tuple[int, ...], channels: int, nwalks: int, nbins: int,
                device="cuda") -> Dict[str, int]:
    """A walk kernel's launch on ``device``: warps and dynamic shared
    bytes a block (``channels`` histogram channels), blocks an SM and the
    grid over ``nwalks`` walks."""
    index = torch.device(device).index or 0
    warps = bin_block_warps(channels, nbins, _smem_optin(index))
    bps = walk_blocks_per_sm(entry, tuple(args), nbins, index)
    return {"warps": warps, "smem": walk_smem_bytes(warps, channels, nbins), "blocks_per_sm": bps,
            "blocks": _wave_blocks(nwalks, warps, bps, _sm_count(index))}


def _walk_blocks(entry: str, args: Tuple[int, ...], channels: int, nwalks: int, nbins: int,
                 device) -> int:
    return walk_launch(entry, args, channels, nwalks, nbins, device)["blocks"]


def shell_bin_values_folded(total, longi, nbins: int, full_ny: int, full_nz: int):
    """(2, nbins) float64 Hermitian-weighted shell sums of the folded
    total and longitudinal power (values only: counts are the static
    ``_folded_counts``)."""
    return _shell_bin_folded("shell_bin_values_folded", (total, longi), nbins, full_ny, full_nz)


def shell_bin_values_folded_1ch(power, nbins: int, full_ny: int, full_nz: int):
    """(nbins,) float64 Hermitian-weighted shell sums of one folded power
    volume (scalar spectra): K4 with one channel."""
    return _shell_bin_folded("shell_bin_values_folded_1ch", (power,), nbins, full_ny, full_nz)[0]


def _hermitian_multiplicity(n_idx: int, n: int, device) -> torch.Tensor:
    """1 on an axis's self-conjugate indices (0 and, for even n, n/2), else 2."""
    idx = torch.arange(n_idx, device=device)
    self_conj = idx == 0
    if n % 2 == 0:
        self_conj |= idx == n // 2
    return torch.where(self_conj, 1.0, 2.0).to(torch.float64)


@lru_cache(maxsize=8)
def _folded_counts(
    fshape: Tuple[int, int, int], nbins: int, full_nx: int, full_ny: int, full_nz: int,
    device: str = "cpu",
) -> np.ndarray:
    """Per-shell unfold-multiplicity counts: a pure shape function
    (fava_tpu/ops/pallas_kernels.py:1198), computed on ``device`` a block
    of x planes at a time (at 1280^3 the table has 263 M cells: seconds
    on the host, milliseconds on the card). Each folded cell stands for
    mx*my original (kx, ky) partners and carries the Hermitian kz weight
    wz; each cell's shell is the kernels' (``_shell_index``), and the
    integer weights sum exactly. Read-only: the cached array is shared by
    every caller."""
    nxh, _rows, nzr = fshape
    nyh = full_ny // 2 + 1
    dev = torch.device(device)
    jy = torch.arange(nyh, device=dev)[:, None]
    jz = torch.arange(nzr, device=dev)[None, :]
    yz2 = jy * jy + jz * jz
    mx = _hermitian_multiplicity(nxh, full_nx, dev)
    wyz = _hermitian_multiplicity(nyh, full_ny, dev)[:, None] * _hermitian_multiplicity(
        nzr, full_nz, dev
    )[None, :]
    counts = torch.zeros(nbins + 1, dtype=torch.float64, device=dev)
    step = max(1, (1 << 24) // (nyh * nzr))  # x planes per block
    for x0 in range(0, nxh, step):
        ix = torch.arange(x0, min(nxh, x0 + step), device=dev)
        shell = _shell_index(ix[:, None, None] ** 2 + yz2, nbins)
        w = mx[x0 : x0 + ix.numel(), None, None] * wyz
        counts += torch.bincount(shell.reshape(-1), weights=w.reshape(-1), minlength=nbins + 1)
    out = counts[:nbins].cpu().numpy()
    out.setflags(write=False)
    return out


def _static_counts(shape, nbins: int, full_nz: int, device) -> torch.Tensor:
    """Hermitian shell counts of an (nx, ny, nzr) rfft half-spectrum (or
    full grid) of a volume of z extent ``full_nz``: a shape function,
    computed on ``device``."""
    nx, ny, _ = (int(s) for s in shape)
    fshape = (nx // 2 + 1, ny // 2 + 1, full_nz // 2 + 1)
    counts = _folded_counts(fshape, int(nbins), nx, ny, int(full_nz), str(torch.device(device)))
    with annotate(SPAN_SYNC_COUNTS):
        return torch.tensor(counts, dtype=accum_dtype(), device=device)


def _even_xy(shape) -> bool:
    return shape[0] % 2 == 0 and shape[1] % 2 == 0


def shell_bin_sums_rfft(total, longi, nbins: int, full_nz: int):
    """(counts, sums[3]) Hermitian shell binning of rfft half-spectrum
    power volumes, with the static counts. sums = [total, longitudinal,
    transverse], transverse being total - longitudinal bin by bin (exact
    in exact arithmetic). Even x and y extents fold the quadrants (K3)
    and bin the folded values (K4); an odd one bins the volumes
    unfolded (B10)."""
    with annotate(SPAN_BINNING):
        if _even_xy(total.shape):
            ft, fl = fold_quadrants_pair(total, longi)
            sums2 = shell_bin_values_folded(ft, fl, int(nbins), int(total.shape[1]), full_nz)
        else:
            sums2 = shell_bin_sums_unfolded(total, longi, int(nbins), full_nz)
        return _with_transverse(_static_counts(total.shape, nbins, full_nz, sums2.device), sums2)


def shell_bin_sums_rfft_scalar(p, nbins: int, full_nz: int):
    """(counts, sums) Hermitian shell binning of ONE rfft power volume
    (scalar spectra): fold with K3 (on the volume twice, as fava_tpu
    does) and the single-channel K4 for even x and y extents, the
    single-channel B10 otherwise."""
    if _even_xy(p.shape):
        folded, _ = fold_quadrants_pair(p, p)
        sums = shell_bin_values_folded_1ch(folded, int(nbins), int(p.shape[1]), full_nz)
    else:
        sums = shell_bin_sums_unfolded(p, None, int(nbins), full_nz)[0]
    return _static_counts(p.shape, nbins, full_nz, sums.device), sums


# ---------------------------------------------------------------------------
# B10: unfolded Hermitian shell binning (odd x or y extents)


def _unfolded_shells(shape, nbins: int, full_nz: int, device, kx0: int = 0, full_nx=None):
    """(shell index of every cell, nbins where dropped; Hermitian weight
    of every z plane) of an (nx, ny, nzr) half-spectrum, or of a full grid
    when nzr == full_nz; shells as the kernel takes them (``_shell_index``).
    Row i is the global row kx0 + i of a volume of x extent ``full_nx``
    (nx when None)."""
    nx, ny, nzr = shape
    half = nzr != full_nz
    full_nx = nx if full_nx is None else int(full_nx)
    i = _wavenumbers_int(full_nx, device)[kx0 : kx0 + nx, None, None]
    j = _wavenumbers_int(ny, device)[None, :, None]
    z = torch.arange(nzr, device=device) if half else _wavenumbers_int(nzr, device)
    shell = _shell_index(i * i + j * j + z[None, None, :] ** 2, nbins)
    if half:
        wz = _z_weights(nzr, full_nz, device)
    else:
        wz = torch.ones(nzr, dtype=accum_dtype(), device=device)
    return shell, wz


def _wavenumbers_int(n: int, device) -> torch.Tensor:
    """Signed integer FFT wavenumbers of an axis of length n."""
    k = torch.arange(n, device=device)
    return torch.where(k <= (n - 1) // 2, k, k - n)


def _shell_bin_unfolded_plain(total, longi, nbins, full_nz, kx0: int = 0, full_nx=None):
    """(C, nbins) plain twin of B10 (kx0 = 0, full_nx = nx) and of B6 (the
    rows kx0.. of a full_nx-wide volume)."""
    shell, wz = _unfolded_shells(tuple(total.shape), nbins, full_nz, total.device, kx0, full_nx)
    return _shell_sums(total, longi, shell, wz, nbins)


def _unfolded_launch_blocks(shape, full_nz: int, channels: int, nbins: int, device) -> int:
    """Blocks of a B6/B10 launch: one walk a row of a half-spectrum, two a
    row of a full grid."""
    nx, ny, nzr = (int(s) for s in shape)
    walks = nx * ny * (2 if nzr == full_nz else 1)
    return _walk_blocks("fava_shell_bin_unfolded_blocks_per_sm", (channels,), channels, walks,
                        nbins, device)


def shell_bin_sums_unfolded(total, longi: Optional[torch.Tensor], nbins: int, full_nz: int):
    """(C, nbins) float64 Hermitian-weighted shell sums of (nx, ny, nzr)
    power volumes, any extents: C = 2 (total, longitudinal) or 1 when
    ``longi`` is None. The volumes are rfft half-spectra of a volume of
    z extent ``full_nz``, or the full grid when nzr == full_nz. Counts
    are the shape function ``_static_counts``."""
    name = "shell_bin_sums_unfolded"
    vols = (total,) if longi is None else (total, longi)
    if total.ndim != 3 or any(v.shape != total.shape for v in vols) or nbins < 1:
        raise ValueError(f"{name}: same-shaped 3D volumes and nbins >= 1 required")
    nx, ny, nzr = (int(s) for s in total.shape)
    if nzr not in (full_nz, full_nz // 2 + 1):
        raise ValueError(f"{name}: z extent {nzr} is neither {full_nz} nor {full_nz // 2 + 1}")
    if _device_kind(name, *vols) == "cpu":
        return _shell_bin_unfolded_plain(total, longi, int(nbins), int(full_nz))
    _check_cuda(name, *vols)
    _check_bins(name, nbins, (nx // 2) ** 2 + (ny // 2) ** 2)
    out = torch.zeros((len(vols), nbins), dtype=torch.float64, device=total.device)
    _launch(
        name, total.device, _build.library().fava_shell_bin_sums_unfolded, total.data_ptr(),
        None if longi is None else longi.data_ptr(), out.data_ptr(), nx, ny, nzr, int(nbins),
        int(full_nz), len(vols),
        _unfolded_launch_blocks(total.shape, full_nz, len(vols), int(nbins), total.device),
        wrote=(out,),
    )
    return out


# ---------------------------------------------------------------------------
# B6: shell binning of an x-chunk of a half-spectrum (the streamed step)


def shell_bin_values_rfft_chunk(total, longi: Optional[torch.Tensor], nbins: int, full_nx: int,
                                full_nz: int, kx0: int):
    """(3, nbins) float64 Hermitian-weighted shell sums [total,
    longitudinal, transverse] of the rfft power volumes of an x-chunk:
    rows kx0 .. kx0+rows-1 of the (full_nx, ny, full_nz//2+1)
    half-spectrum. Values only: the chunks' sums add up to the whole
    volume's, whose counts are ``rfft_shell_counts``. Transverse is
    total - longitudinal shell by shell, as fava_tpu's kernel path
    forms it. With ``longi`` None, (1, nbins): the shell sums of one
    power volume (the sharded scalar spectrum), the kernel with one
    channel, counted as ``shell_bin_values_rfft_chunk_1ch``."""
    name = "shell_bin_values_rfft_chunk" if longi is not None else "shell_bin_values_rfft_chunk_1ch"
    vols = (total,) if longi is None else (total, longi)
    if total.ndim != 3 or any(v.shape != total.shape for v in vols) or nbins < 1:
        raise ValueError(f"{name}: same-shaped 3D volumes and nbins >= 1 required")
    rows, ny, nzr = (int(s) for s in total.shape)
    kx0, full_nx, full_nz = int(kx0), int(full_nx), int(full_nz)
    if nzr != full_nz // 2 + 1:
        raise ValueError(f"{name}: z extent {nzr} is not the half-spectrum's {full_nz // 2 + 1}")
    if kx0 < 0 or kx0 + rows > full_nx:
        raise ValueError(f"{name}: rows {kx0}..{kx0 + rows - 1} outside an x extent of {full_nx}")
    if _device_kind(name, *vols) == "cpu":
        sums = _shell_bin_unfolded_plain(total, longi, int(nbins), full_nz, kx0, full_nx)
    else:
        _check_cuda(name, *vols)
        _check_bins(name, nbins, (full_nx // 2) ** 2 + (ny // 2) ** 2)
        c = len(vols)
        sums = torch.zeros((c, nbins), dtype=torch.float64, device=total.device)
        _launch(
            name, total.device, _build.library().fava_shell_bin_sums_rfft_chunk, total.data_ptr(),
            None if longi is None else longi.data_ptr(), sums.data_ptr(), rows, ny, nzr,
            int(nbins), full_nx, full_nz, kx0, c,
            _unfolded_launch_blocks(total.shape, full_nz, c, int(nbins), total.device),
            wrote=(sums,),
        )
    if longi is None:
        return sums
    return torch.stack([sums[0], sums[1], sums[0] - sums[1]])


def rfft_shell_counts(full_shape: Tuple[int, int, int], nbins: int, device="cuda") -> torch.Tensor:
    """Static Hermitian shell counts of a whole volume's rfft
    half-spectrum, on ``device``: what the chunks' counts add up to
    (fava_tpu/ops/pallas_kernels.py:1504)."""
    nx, ny, nz = (int(s) for s in full_shape)
    return _static_counts((nx, ny, nz // 2 + 1), nbins, nz, resolve_device(device))


@lru_cache(maxsize=16)
def _chunk_counts(rows: int, ny: int, nbins: int, full_nx: int, full_nz: int, kx0: int):
    """Hermitian shell counts of the rows kx0.. of a half-spectrum (host
    numpy, read-only): a shape function, as the kernel computes no counts."""
    ones = torch.ones((rows, ny, full_nz // 2 + 1), dtype=torch.float64)
    counts = _shell_bin_unfolded_plain(ones, None, nbins, full_nz, kx0, full_nx)[0].numpy()
    counts.setflags(write=False)
    return counts


def shell_bin_sums_rfft_chunk(total, longi, nbins: int, full_nx: int, full_nz: int, kx0: int):
    """(counts, sums[3]) of an x-chunk of rfft powers
    (fava_tpu/ops/pallas_kernels.py:1715): the chunk's Hermitian shell
    counts (a shape function) and ``shell_bin_values_rfft_chunk``'s sums
    (one row with ``longi`` None). Counts and sums over all chunks equal
    the whole-volume binning."""
    sums = shell_bin_values_rfft_chunk(total, longi, nbins, full_nx, full_nz, kx0)
    rows, ny, _ = (int(s) for s in total.shape)
    counts = _chunk_counts(rows, ny, int(nbins), int(full_nx), int(full_nz), int(kx0))
    return torch.tensor(counts, dtype=accum_dtype(), device=total.device), sums


def _with_transverse(counts, sums2):
    """(counts, sums[3]): [total, longitudinal, transverse = total - longitudinal]."""
    return counts, torch.stack([sums2[0], sums2[1], sums2[0] - sums2[1]])


# ---------------------------------------------------------------------------
# B11: the one-pass folded binning with counts (fava_tpu's v1) and the
# row-chunked values-only one (v2), on folds with any row count >= ny/2+1


def _check_fold(name: str, total, longi, nbins: int, full_nx: int, full_ny: int, full_nz: int):
    """(nxh, rows, nzr) of two folds of a (full_nx, full_ny, full_nz) volume."""
    if total.ndim != 3 or longi.shape != total.shape or nbins < 1:
        raise ValueError(f"{name}: two same-shaped 3D volumes and nbins >= 1 required")
    nxh, rows, nzr = (int(s) for s in total.shape)
    if nxh != full_nx // 2 + 1 or nzr != full_nz // 2 + 1 or rows < full_ny // 2 + 1:
        raise ValueError(
            f"{name}: the fold of a ({full_nx}, {full_ny}, {full_nz}) volume is ({full_nx // 2 + 1}, "
            f">= {full_ny // 2 + 1}, {full_nz // 2 + 1}), got {tuple(total.shape)}"
        )
    return nxh, rows, nzr


def _onepass_plain(total, longi, nbins: int, full_nx: int, full_ny: int, full_nz: int):
    """(3, nbins) [counts, total, longi]: the static counts and K4's plain
    sums; rows past full_ny/2 bin nothing."""
    counts = _folded_counts(tuple(total.shape), nbins, full_nx, full_ny, full_nz,
                            str(total.device))
    counts = torch.tensor(counts, dtype=accum_dtype(), device=total.device)
    return torch.cat([counts[None], _shell_bin_folded_plain(total, longi, nbins, full_ny, full_nz)])


def shell_bin_sums_folded_onepass(total, longi, nbins: int, full_nx: int, full_ny: int,
                                  full_nz: int):
    """(counts, sums[3]) of folded total and longitudinal power volumes
    (nx//2+1, rows >= ny//2+1, nz//2+1) with the counts accumulated in the
    kernel (weight mx*my*wz): fava_tpu's one-pass folded binning
    (pallas_kernels.py:811). Rows past ny/2 (fava_tpu pads the fold to a
    multiple of 8) bin nothing, whatever they hold."""
    name = "shell_bin_sums_folded_onepass"
    nbins, full_nx, full_ny, full_nz = (int(a) for a in (nbins, full_nx, full_ny, full_nz))
    nxh, rows, nzr = _check_fold(name, total, longi, nbins, full_nx, full_ny, full_nz)
    if _device_kind(name, total, longi) == "cpu":
        out = _onepass_plain(total, longi, nbins, full_nx, full_ny, full_nz)
    else:
        _check_cuda(name, total, longi)
        _check_bins(name, nbins, (nxh - 1) ** 2 + (full_ny // 2) ** 2)
        out = torch.zeros((3, nbins), dtype=torch.float64, device=total.device)
        _launch(
            name, total.device, _build.library().fava_shell_bin_sums_folded_onepass,
            total.data_ptr(), longi.data_ptr(), out.data_ptr(), nxh, rows, nzr, nbins, full_nx,
            full_ny, full_nz,
            _walk_blocks("fava_shell_bin_folded_blocks_per_sm", (2, 1), 3, nxh * rows, nbins,
                         total.device),
            wrote=(out,),
        )
    return _with_transverse(out[0], out[1:])


def shell_bin_values_folded_rows(total, longi, nbins: int, full_nx: int, full_ny: int,
                                 full_nz: int):
    """(t_sum, l_sum): the values-only Hermitian shell sums of folded power
    volumes with any row count >= ny//2+1 (fava_tpu's row-chunked binning,
    pallas_kernels.py:1140). An alias of ``shell_bin_values_folded`` that
    checks the fold's shape: K4's kernel skips the rows past ny/2 unread,
    and its launch counts as K4's. Counts are the static ``_folded_counts``."""
    nbins, full_nx, full_ny, full_nz = (int(a) for a in (nbins, full_nx, full_ny, full_nz))
    _check_fold("shell_bin_values_folded_rows", total, longi, nbins, full_nx, full_ny, full_nz)
    sums = shell_bin_values_folded(total, longi, nbins, full_ny, full_nz)
    return sums[0], sums[1]


# ---------------------------------------------------------------------------
# B9: powers, fold and shell binning straight from the stacked transforms


def _dense_strides(shape) -> Tuple[int, ...]:
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= int(n)
    return tuple(reversed(strides))


def _stack_layout(name: str, re_stack, im_stack) -> int:
    """1 when re/im are the two halves of ``torch.view_as_real`` of one
    contiguous complex64 stack (read in place), 0 for two contiguous
    planar float32 stacks; raises for anything else."""
    for t in (re_stack, im_stack):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes torch.float32, got {t.dtype}")
    if re_stack.is_contiguous() and im_stack.is_contiguous():
        return 0
    halves = tuple(2 * s for s in _dense_strides(re_stack.shape))
    if (re_stack.stride() == halves and im_stack.stride() == halves
            and im_stack.data_ptr() == re_stack.data_ptr() + 4 and re_stack.data_ptr() % 8 == 0):
        return 1
    raise ValueError(
        f"{name}: the CUDA kernel takes contiguous planar stacks or the two halves of "
        "torch.view_as_real of one contiguous complex64 stack"
    )


def _powers_fused_plain(re_stack, im_stack, nbins: int, full_nz: int) -> torch.Tensor:
    """(3, nbins) [counts, total, longi] of the plain path: the power
    volumes (ops/spectra.py), K3's fold and K4's binning, in float64."""
    from fava_tpu_torch.ops.spectra import rfft_power_volumes

    _, nx, ny, nzr = (int(s) for s in re_stack.shape)
    adt = accum_dtype()
    ffts = [torch.complex(re_stack[c].to(adt), im_stack[c].to(adt)) for c in range(3)]
    total, longi = rfft_power_volumes(ffts, (nx, ny, full_nz))
    del ffts
    sums2 = _shell_bin_folded_plain(_fold_plain(total), _fold_plain(longi), nbins, ny, full_nz)
    counts = _static_counts((nx, ny, nzr), nbins, full_nz, re_stack.device)
    return torch.cat([counts[None], sums2])


def shell_bin_powers_fused(re_stack, im_stack, nbins: int, full_nz: int):
    """(counts, sums[3]) straight from the stacked rfft half-spectra of the
    three velocity components (fava_tpu/ops/pallas_kernels.py:1697):
    ``re_stack``/``im_stack`` are (3, nx, ny, nz//2+1), already normalized
    (1/ntot), with even nx and ny. The powers (with the Nyquist split),
    the +-kx/+-ky fold and the Hermitian shell binning in one pass; the
    power volumes are never formed. sums = [total, longitudinal,
    transverse = total - longitudinal]. On CUDA the stacks are float32,
    contiguous planar or the two ``torch.view_as_real`` halves of one
    contiguous complex64 stack (cuFFT's output, read in place); counts
    come from the kernel and equal the static counts, with no copy from
    the host. The launch and its output's zero-fill lie in the
    ``fava.powers`` span (the plain version's power volumes open it), the
    transverse row in ``fava.binning``."""
    name = "shell_bin_powers_fused"
    if re_stack.ndim != 4 or re_stack.shape[0] != 3 or im_stack.shape != re_stack.shape:
        raise ValueError(f"{name}: two (3, nx, ny, nzr) stacks required")
    _, nx, ny, nzr = (int(s) for s in re_stack.shape)
    nbins, full_nz = int(nbins), int(full_nz)
    if nx % 2 or ny % 2:
        raise ValueError(f"{name}: even x and y extents only, got ({nx}, {ny})")
    if nzr != full_nz // 2 + 1 or nbins < 1:
        raise ValueError(f"{name}: z extent {nzr} is not {full_nz // 2 + 1}, or nbins < 1")
    if _device_kind(name, re_stack, im_stack) == "cpu":
        out = _powers_fused_plain(re_stack, im_stack, nbins, full_nz)
    else:
        with annotate(SPAN_POWERS):
            interleaved = _stack_layout(name, re_stack, im_stack)
            _check_bins(name, nbins, (nx // 2) ** 2 + (ny // 2) ** 2)
            out = torch.zeros((3, nbins), dtype=torch.float64, device=re_stack.device)
            _launch(
                name, re_stack.device, _build.library().fava_shell_bin_powers_fused,
                re_stack.data_ptr(), None if interleaved else im_stack.data_ptr(), out.data_ptr(),
                nx, ny, nzr, nbins, full_nz, interleaved,
                _walk_blocks("fava_shell_bin_powers_fused_blocks_per_sm", (interleaved,), 3,
                             (nx // 2 + 1) * (ny // 2 + 1), nbins, re_stack.device),
                wrote=(out,),
            )
    with annotate(SPAN_BINNING):
        return _with_transverse(out[0], out[1:])


# ---------------------------------------------------------------------------
# B12: the fused z-rfft + y-DFT of a real volume. Every shape within
# ``zy_rfft_fits`` takes the cluster FFT kernel: y and z extents with a
# prime factor above 7 by Bluestein's algorithm (a chirp axis). The dense
# kernel stays callable (``_zy_rfft_dense``) on no route.

ZY_MAX_EXTENT = 1024  # largest y and z extent of both kernels (csrc/dft_kernels.cu)
ZY_MAX_SLABS = 65535  # largest x extent (the launch grid's y extent)
ZY_SMEM_MAX = 232448 - 256  # dynamic shared bytes of a block: sm_90's limit less static arrays
ZY_SMEM_HALF = 233472 // 2 - 1024 - 256  # the same when two blocks share an SM (1 KB reserved each)
ZY_MAX_STAGES = 10  # kMaxStages: FFT passes per axis
ZY_CLUSTERS = (16, 8, 4, 2, 1)  # cluster sizes, in the plan's order of preference
ZY_RADICES = (2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 15, 16)  # the kernel's register DFTs (Dft<R>)
ZY_DIVS = 2 * ZY_MAX_STAGES + 6  # kDivs: the mixed-radix kernel's divisors in its tables


def zy_rfft_fits(shape) -> bool:
    """Whether B12 takes a real volume of this shape: 3D, x extent
    1..65535, y and z extents 1..1024, any parity and any factors (the
    cluster FFT kernel, a chirp axis for a prime factor above 7)."""
    if len(shape) != 3:
        return False
    nx, ny, nz = (int(s) for s in shape)
    return 1 <= nx <= ZY_MAX_SLABS and 1 <= ny <= ZY_MAX_EXTENT and 1 <= nz <= ZY_MAX_EXTENT


# The route of a shape: every shape B12 takes goes through the cluster FFT kernel.
_zy_uses_fft = zy_rfft_fits


def _smooth7(n: int) -> bool:
    """Whether n >= 1 has no prime factor above 7."""
    if n < 1:
        return False
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def _chirp_length(n: int) -> int:
    """The length of the kernel's transform of an n-point axis: n itself
    when n is 7-smooth; otherwise (a chirp axis, Bluestein's algorithm)
    the circular convolution's length M >= 2n - 1: the 7-smooth number up
    to the power of two above 2n - 2 with the fewest passes, the smallest
    of those, or that power of two when it is within 1/8 of it and takes
    no more passes (504 -> 512, 1008 -> 1024: radix-8 and -16 passes cost
    less than odd ones; 601 -> 630 = 15 x 7 x 6, not 625 = 5^4). At most
    2048 for n <= 1024."""
    if _smooth7(n):
        return n
    lo = 2 * n - 1
    p2 = 1 << (lo - 1).bit_length()
    m = min((k for k in range(lo, p2 + 1) if _smooth7(k)), key=lambda k: (len(_radices(k)), k))
    return p2 if 8 * m > 7 * p2 and len(_radices(p2)) <= len(_radices(m)) else m


@lru_cache(maxsize=None)
def _radices(n: int) -> Tuple[int, ...]:
    """The radices of an n-point FFT's passes (n 7-smooth), first pass
    first: the fewest passes of the kernel's radices (``ZY_RADICES``,
    <= 16), the most even of those (the largest smallest radix, then the
    smallest largest), ordered by odd part, then size, largest first, so
    that the first pass's span n / R0 keeps n's powers of two (240 = 15 x
    16: the first pass's loads run along 16 consecutive values). Powers of
    two: 256 = 16 x 16, 512 = 8 x 8 x 8, 1024 = 16 x 8 x 8. Radix 32 would
    save a pass at 512 and 1024 but spills registers at two blocks an SM."""

    def factorings(m, top):
        if m == 1:
            yield ()
        for r in ZY_RADICES:
            if r <= top and m % r == 0:
                for rest in factorings(m // r, r):
                    yield (r,) + rest

    if not _smooth7(n):
        raise ValueError(f"{n} has a prime factor above 7")
    best = min(factorings(n, n), key=lambda f: (len(f), -min(f, default=1), max(f, default=1)))
    return tuple(sorted(best, key=lambda r: (r // (r & -r), r), reverse=True))  # odd part, size


@dataclass(frozen=True)
class ZyFftPlan:
    """How the cluster FFT kernel splits one x slab (csrc/dft_kernels.cu).

    A cluster of ``cluster`` blocks does one pass over ``passes`` ranges of
    column slots of one slab. Block (rank) r transforms the slab rows
    [r ny // C, (r+1) ny // C) (at most ``rows``) along z, ``batch`` rows at
    a time in its work buffer (row stride ``ws``), and stores each X[k] into
    the shared memory of the rank that owns slot k: rank r owns the slots
    [bound(p C + r), bound(p C + r + 1)) (at most ``tile``) and holds all
    ``my`` rows of them (row stride ``es``). After one cluster barrier each
    rank transforms its slots along y in place and writes them out (even
    nz: slot 0 split into kz = 0 and nz/2 after its transform). Odd nz
    pairs the rows of a batch (``batch`` even) as x[a] + i x[b] in one
    nz-point transform. Strides are odd, so lanes that step by them hit
    distinct banks. Cluster sizes and pass counts are powers of two; where
    ny and nz (>= 2) are too, so are batches and slot ranges, and the
    kernel splits its work items with shifts.

    A chirp axis (its transform length nt or ny has a prime factor above
    7) runs Bluestein's algorithm: the transform of length ``mz`` (or
    ``my``) > nt is a circular convolution with the chirp, whose tables sit
    in global memory when ``chirp_global`` and in shared memory otherwise;
    the other axis keeps mz = nt (my = ny)."""

    ny: int
    nz: int
    cluster: int
    passes: int
    rows: int
    batch: int
    tile: int
    ws: int
    es: int
    work: int  # float2 elements of the row-batch buffer
    smem: int  # dynamic shared bytes of a block
    radices_z: Tuple[int, ...]  # radix passes of the mz-point z transform
    radices_y: Tuple[int, ...]  # radix passes of the my-point y transform
    mz: int  # length of the z transform: nt, or a chirp axis's convolution
    my: int  # length of the y transform: ny, or a chirp axis's convolution
    chirp_global: bool  # the chirp axes' tables read from global memory

    @property
    def odd(self) -> bool:
        return self.nz % 2 == 1

    @property
    def nt(self) -> int:
        """Length of the z DFT: nz/2 complex values a row for even nz, nz
        for a pair of rows for odd nz."""
        return self.nz if self.odd else self.nz // 2

    @property
    def nslot(self) -> int:
        """Column slots: nz/2 for even nz (slot 0 holds the real columns kz
        = 0 and nz/2 packed as one complex column, slot u > 0 kz = u), and
        (nz+1)/2 for odd nz (slot u holds kz = u)."""
        return (self.nz + 1) // 2

    @property
    def chirp_z(self) -> bool:
        return self.mz != self.nt

    @property
    def chirp_y(self) -> bool:
        return self.my != self.ny

    def bound(self, u: int) -> int:
        """First column slot of range u of the passes * cluster ranges."""
        return u * self.nslot // (self.passes * self.cluster)

    def row_range(self, r: int) -> Tuple[int, int]:
        """Rows of the slab that rank r transforms along z."""
        return r * self.ny // self.cluster, (r + 1) * self.ny // self.cluster

    def as_ints(self) -> Tuple[int, ...]:
        """The int vector the C entry reads (struct ZyFftPlan)."""
        def pad(radices):
            return tuple(radices) + (0,) * (ZY_MAX_STAGES - len(radices))

        head = (self.ny, self.nz, self.cluster, self.passes, self.rows, self.batch, self.tile,
                self.ws, self.es, self.work, self.smem, len(self.radices_z), len(self.radices_y))
        return head + pad(self.radices_z) + pad(self.radices_y) + (self.mz, self.my,
                                                                   int(self.chirp_global))


def _zy_pad(n: int, radices: Tuple[int, ...]) -> Optional[int]:
    """Phase 1's rows carry one padding slot per 2^v values, 2^v the power
    of two in the first pass's span n / R0 (n the z transform's length,
    mz), when v >= 2 (zy_pad in the kernel): the post-process reads the
    digit-reversed result at strides of that span, which the padding makes
    odd. None: no padding (an odd span strides the banks already; for 2 a
    two-way conflict costs less than a third more buffer)."""
    span = n // radices[0] if radices else n
    v = (span & -span).bit_length() - 1
    return v if v >= 2 else None


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _fit_plan(ny: int, nz: int, cluster: int, passes: int, budget: int,
              chirp_global: bool = False) -> Optional[ZyFftPlan]:
    """The plan of this cluster size and pass count within ``budget``
    shared bytes, or None: a rank's slots (all ``my`` rows of them) and the
    largest batch of rows that fits beside the tables (the twiddles of the
    post-process (even nz) and of each pass, the kernel's divisors (8 bytes
    each, for plans with an extent that is not a power of two or nz = 1),
    then the z positions and the y rows in 16 bits (none on a chirp axis,
    which leaves natural order; its rows are not padded), 16-byte rounded; then
    a chirp axis's chirp (nt or ny entries) and filter (mz or my), unless
    ``chirp_global``: ``_zy_fft_tables``). Batches are the rank's most rows
    split into 1, 2, 4, ... even parts (rounded up to even for odd nz, whose
    batches hold pairs of rows); with a chirp axis, into the fewest even
    parts that fit (512x512x502 on an H100: 8 rows, 2.68 ms, against 4 rows,
    3.22; probe_zy_fft.py --chirp); ``passes`` is a power of two <= the slots,
    and every range of slots is ``tile`` or one less wide (0 or 1 when
    there are fewer slots than ranges). None too where the slot owners'
    dividend would pass 2^16 (plan_ok)."""
    odd = nz % 2
    nt, nslot = (nz if odd else nz // 2), (nz + 1) // 2
    if nslot * (passes * cluster + 1) > 1 << 16:
        return None
    mz, my = _chirp_length(nt), _chirp_length(ny)
    chirp = 8 * ((nt + mz) * (mz != nt) + (ny + my) * (my != ny))  # bytes of the chirp tables
    if chirp_global and not chirp:
        return None
    tile = -(-nslot // (passes * cluster))
    rows = -(-ny // cluster)
    radices_z, radices_y = _radices(mz), _radices(my)
    pad = _zy_pad(mz, radices_z) if mz == nt else None  # a chirp axis leaves natural order
    ws = (mz + ((mz - 1) >> pad if pad is not None else 0)) | 1
    es = tile | 1
    post = 0 if odd else nt
    divs = 0 if ny & (ny - 1) == 0 and nz & (nz - 1) == 0 and nz > 1 else ZY_DIVS
    tables = _round16(8 * (post + _pass_tables(mz, radices_z) + _pass_tables(my, radices_y) + divs)
                      + 2 * (nt * (mz == nt) + ny * (my == ny)))
    tables += 0 if chirp_global else _round16(chirp)
    room = budget - tables - 8 * my * es
    if chirp:
        most, need = room // (8 * ws), -(-rows // 2) if odd else rows  # sequences: fit, and all rows
        if most < 1:
            return None
        seqs = -(-need // -(-need // most))
        batch = 2 * seqs if odd else seqs
    else:
        parts = 1
        while True:
            batch = -(-rows // parts)
            batch += batch % 2 if odd else 0
            seqs = batch // 2 if odd else batch
            if 8 * seqs * ws <= room:
                break
            if seqs == 1:
                return None
            parts *= 2
    work = seqs * ws
    return ZyFftPlan(ny, nz, cluster, passes, rows, batch, tile, ws, es, work,
                     tables + 8 * (my * es + work), radices_z, radices_y, mz, my, chirp_global)


def _pass_tables(n: int, radices: Tuple[int, ...]) -> int:
    """Twiddle entries of an n-point transform's per-pass tables: a pass
    on sub-transforms of length L keeps W_L^(j t) for t < R, j < L/R."""
    total = 0
    for r in radices:
        total += n
        n //= r
    return total


@lru_cache(maxsize=64)
def _zy_fft_plan(ny: int, nz: int) -> ZyFftPlan:
    """The cluster FFT kernel's plan for 1 <= ny, nz <= 1024: the fewest
    passes over the slab; then two blocks an SM if they fit, else one;
    then the largest cluster (<= 16, <= ny; 1 for nz = 1, whose one slot
    leaves the other ranks idle: 512x512x1 on an H100 0.047 against 0.189
    ms) whose blocks' shared memory fits, a chirp axis's tables in global
    memory where that buys a larger row batch, else in shared memory. A
    chirp axis along y alone takes two blocks an SM over two passes before
    one block over one pass: its columns hold my >= 2 ny rows, and the z
    transforms the second pass repeats are short (512x502x512 on an H100:
    4.18 against 4.57 ms, probe_zy_fft.py --chirp). A shape no plan fits
    raises ValueError (none within the extents: tests/test_torch_zyfft.py)."""
    ny, nz = int(ny), int(nz)
    if not (1 <= ny <= ZY_MAX_EXTENT and 1 <= nz <= ZY_MAX_EXTENT):
        raise ValueError(f"the cluster FFT kernel takes y and z extents 1..{ZY_MAX_EXTENT}, "
                         f"got ({ny}, {nz})")
    nt, nslot = (nz if nz % 2 else nz // 2), (nz + 1) // 2
    order = [(passes, budget) for passes in (1 << i for i in range(nslot.bit_length()))
             if passes <= nslot for budget in (ZY_SMEM_HALF, ZY_SMEM_MAX)]
    if not _smooth7(ny) and _smooth7(nt) and (2, ZY_SMEM_HALF) in order:
        order.remove((2, ZY_SMEM_HALF))
        order.insert(1, (2, ZY_SMEM_HALF))
    for passes, budget in order:
        for cluster in ZY_CLUSTERS if nz > 1 else (1,):
            if cluster <= ny:
                fits = [p for p in (_fit_plan(ny, nz, cluster, passes, budget, home) for home in (False, True))
                        if p is not None]
                if fits:
                    return max(fits, key=lambda p: p.batch)  # ties: tables in shared memory
    raise ValueError(f"zy_rfft_planar: no cluster FFT plan fits ({ny}, {nz})")


def _twiddles(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """exp(-2 pi i m / n), m < n, computed in float64 and rounded once to
    ``dtype``'s complex type (the kernel's tables)."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = torch.complex(torch.tensor(np.cos(ang)), torch.tensor(-np.sin(ang)))
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return tw.to(device=device, dtype=cdt)


def _fft_positions(n: int, radices: Tuple[int, ...]) -> torch.Tensor:
    """Where the in-place decimation-in-frequency passes leave X[k]: the
    mixed-radix digit reversal of k (fft_pos in the kernel): digit i of k,
    k mod R_i after the lower digits, at span n / (R_0 ... R_i)."""
    pos = np.zeros(n, dtype=np.int64)
    k = np.arange(n)
    span = n
    for r in radices:
        span //= r
        pos += (k % r) * span
        k = k // r
    return torch.from_numpy(pos)


def _dif_passes(v: torch.Tensor, radices: Tuple[int, ...], table: torch.Tensor) -> torch.Tensor:
    """The kernel's radix passes along v's last axis (length n dividing
    the table's length T), in the same order: a radix-R pass on
    sub-transforms of length L takes x[g L + j + t L/R], t < R, does an
    R-point DFT and stores output s times W_L^(j s) at g L + s L/R + j.
    The output is in digit-reversed order (``_fft_positions``)."""
    n, big = v.shape[-1], table.numel()
    lead = v.shape[:-1]
    length = n
    for r in radices:
        sub = length // r
        t = torch.arange(r)
        dft_r = table[(t[:, None] * t[None, :] * (big // r)) % big]
        tw = table[t[:, None] * torch.arange(sub)[None, :] * (big // length)]
        u = v.reshape(*lead, n // length, r, sub)
        v = (torch.einsum("...tj,ts->...sj", u, dft_r) * tw).reshape(*lead, n)
        length = sub
    return v


def _dit_passes(v: torch.Tensor, radices: Tuple[int, ...], table: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_dif_passes`` on conjugated data, as the kernel's
    chirp route runs it (fft_pass with Dit): the passes in reverse order,
    each multiplying x[g L + j + t L/R] by W_L^(j t) and then taking the
    R-point DFT over t. Digit-reversed in, natural order out:
    ``_dit_passes(conj(_dif_passes(x)))`` is n conj(x)."""
    n, big = v.shape[-1], table.numel()
    lead = v.shape[:-1]
    lengths = [n]
    for r in radices[:-1]:
        lengths.append(lengths[-1] // r)
    for r, length in zip(reversed(radices), reversed(lengths)):
        sub = length // r
        t = torch.arange(r)
        dft_r = table[(t[:, None] * t[None, :] * (big // r)) % big]
        tw = table[t[:, None] * torch.arange(sub)[None, :] * (big // length)]
        u = v.reshape(*lead, n // length, r, sub) * tw
        v = torch.einsum("...tj,ts->...sj", u, dft_r).reshape(*lead, n)
    return v


def _chirp_tables(n: int, m: int, radices: Tuple[int, ...], dtype: torch.dtype, device):
    """(chirp, filter) of an n-point chirp axis transformed at length m,
    as the kernel's tables hold them: exp(-i pi k^2 / n) for k < n (k^2
    mod 2n in integers), and F = FFT_m(h) / m at the passes' digit-reversed
    positions, h[j] = h[m - j] = exp(i pi j^2 / n) for j < n, 0 between;
    float64, rounded once to ``dtype``'s complex type."""
    k = np.arange(n, dtype=np.int64)
    b = np.exp(1j * np.pi * ((k * k) % (2 * n)) / n)
    h = np.zeros(m, dtype=np.complex128)
    h[:n] = b
    h[m - n + 1:] = b[1:][::-1]
    filt = np.empty(m, dtype=np.complex128)
    filt[_fft_positions(m, radices).numpy()] = np.fft.fft(h) / m
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return (torch.from_numpy(b.conj()).to(device=device, dtype=cdt),
            torch.from_numpy(filt).to(device=device, dtype=cdt))


def _chirp_dft(v: torch.Tensor, m: int, radices: Tuple[int, ...], table: torch.Tensor, chirp: torch.Tensor,
               filt: torch.Tensor) -> torch.Tensor:
    """The n-point DFT along v's last axis by Bluestein's algorithm, as the
    kernel's chirp route (chirp_run) does it: premultiply by the chirp and
    pad to m, the m-point DIF passes, times the filter, conjugate, the
    inverse passes (``_dit_passes``), conjugate and postmultiply by the
    chirp. Natural order out."""
    n = v.shape[-1]
    a = torch.zeros(v.shape[:-1] + (m,), dtype=v.dtype, device=v.device)
    a[..., :n] = v * chirp
    d = _dit_passes((_dif_passes(a, radices, table) * filt).conj(), radices, table)
    return chirp * d[..., :n].conj()


def _zy_axis(plan: ZyFftPlan, axis: str, dtype: torch.dtype, device):
    """The transform of one axis of ``plan`` as the kernel runs it: a
    function of (..., n) complex rows, and where it leaves X[k] (the
    passes' digit-reversed positions, or natural order on a chirp axis)."""
    n, m, radices = ((plan.nt, plan.mz, plan.radices_z) if axis == "z" else
                     (plan.ny, plan.my, plan.radices_y))
    table = _twiddles(m, dtype, device)
    if m == n:
        return (lambda v: _dif_passes(v, radices, table)), _fft_positions(n, radices).to(device)
    chirp, filt = _chirp_tables(n, m, radices, dtype, device)
    return (lambda v: _chirp_dft(v, m, radices, table, chirp, filt)), torch.arange(n, device=device)


def _zy_rfft_fft_plain(x: torch.Tensor, plan: ZyFftPlan):
    """(re, im) of the z-rfft then y-DFT of every x slab, as the cluster
    FFT kernel computes them: plain torch, in x's dtype, walking the
    plan's ranks, passes, row batches and slot ranges. Phase 1, even nz:
    each row's nz reals as nz/2 complex values, the z passes, then X[k] =
    E[k] + W_nz^k O[k] from the digit-reversed result, with the real X[0]
    and X[nz/2] packed in slot 0; odd nz: rows 2s and 2s+1 of a batch (the
    last with zeros when the batch is odd) as one complex row C, the z
    passes, then X_2s = (C[k] + conj C[-k]) / 2 and X_2s+1 = (C[k] - conj
    C[-k]) / 2i; each rank's rows landing in the slots' owners. Phase 2:
    each rank's slots, all rows, the y passes, written out; even nz: slot 0
    split by Hermitian symmetry. A chirp axis goes through ``_chirp_dft``
    in place of the passes."""
    nx, ny, nz = (int(s) for s in x.shape)
    if (ny, nz) != (plan.ny, plan.nz):
        raise ValueError(f"plan for ({plan.ny}, {plan.nz}), volume {tuple(x.shape)}")
    nt, c = plan.nt, plan.cluster
    tz = _twiddles(nz, x.dtype, x.device)
    z_transform, pos_z = _zy_axis(plan, "z", x.dtype, x.device)
    y_transform, pos_y = _zy_axis(plan, "y", x.dtype, x.device)
    re = torch.empty((nx, ny, nz // 2 + 1), dtype=x.dtype, device=x.device)
    im = torch.empty_like(re)
    for p in range(plan.passes):
        cp0, cp1 = plan.bound(p * c), plan.bound(p * c + c)
        k = torch.arange(cp0, cp1, device=x.device)
        z = []
        for r in range(c):
            r0, r1 = plan.row_range(r)
            for b0 in range(r0, r1, plan.batch):
                rows = x[:, b0 : min(b0 + plan.batch, r1)]
                if plan.odd:
                    pairs = torch.nn.functional.pad(rows, (0, 0, 0, rows.shape[1] % 2))
                    zc = z_transform(torch.complex(pairs[:, 0::2], pairs[:, 1::2]))
                    a, b = zc[..., pos_z[k]], zc[..., pos_z[(-k) % nz]].conj()
                    out = torch.stack((0.5 * (a + b), -0.5j * (a - b)), dim=2)
                    z.append(out.reshape(nx, -1, cp1 - cp0)[:, : rows.shape[1]])
                    continue
                zc = z_transform(torch.complex(rows[..., 0::2], rows[..., 1::2]))
                a, b = zc[..., pos_z[k]], zc[..., pos_z[(nt - k) % nt]].conj()
                out = 0.5 * (a + b) - 0.5j * tz[k] * (a - b)
                if cp0 == 0:  # slot 0: X[0] + i X[nt], X[0] = Re A + Im A, X[nt] = Re A - Im A
                    a0 = a[..., 0]
                    out[..., 0] = torch.complex(a0.real + a0.imag, a0.real - a0.imag)
                z.append(out)
        z = torch.cat(z, dim=1)
        for r in range(c):
            cr0, cr1 = plan.bound(p * c + r), plan.bound(p * c + r + 1)
            if cr1 == cr0:
                continue
            y = y_transform(z[..., cr0 - cp0 : cr1 - cp0].transpose(1, 2))
            y = y[..., pos_y].transpose(1, 2)
            re[..., cr0:cr1], im[..., cr0:cr1] = y.real, y.imag
            if cr0 == 0 and not plan.odd:  # Y0 = (C[a] + conj C[-a]) / 2, Yn = (C[a] - conj C[-a]) / 2i
                ca, cb = y[..., 0], y[:, (-torch.arange(ny, device=x.device)) % ny, 0].conj()
                y0, yn = 0.5 * (ca + cb), -0.5j * (ca - cb)
                re[..., 0], im[..., 0], re[..., nt], im[..., nt] = y0.real, y0.imag, yn.real, yn.imag
    return re, im


def _zy_rfft_plain(x: torch.Tensor):
    """(re, im) of the dense z-rfft then y-DFT of every x slab, in x's
    dtype: ops/dft.py's matrices as matmuls (fava_tpu's contraction)."""
    nx, ny, nz = (int(s) for s in x.shape)
    name = str(x.dtype).split(".")[-1]
    czr, czi = (torch.tensor(m, device=x.device) for m in dft._rdft_mats(nz, name))
    wy = torch.tensor(dft._dft_mat(ny, name), device=x.device)
    wr, wi = wy.real.contiguous(), wy.imag.contiguous()
    zr, zi = x @ czr, x @ czi
    return wr @ zr - wi @ zi, wr @ zi + wi @ zr


def _zy_outputs(x: torch.Tensor):
    nx, ny, nz = (int(s) for s in x.shape)
    re = torch.empty((nx, ny, nz // 2 + 1), dtype=torch.float32, device=x.device)
    return re, torch.empty_like(re)


def _zy_check(name: str, x: torch.Tensor) -> str:
    if x.ndim != 3:
        raise ValueError(f"{name}: a 3D volume required, got {tuple(x.shape)}")
    kind = _device_kind(name, x)
    if kind == "cuda":
        _check_cuda(name, x)
        if not zy_rfft_fits(x.shape):
            raise ValueError(
                f"{name}: the CUDA kernels take x extents 1..{ZY_MAX_SLABS} and y, z extents "
                f"1..{ZY_MAX_EXTENT}, got {tuple(x.shape)}"
            )
    return kind


def _zy_rfft_dense(x: torch.Tensor):
    """B12's dense-DFT kernel (f32 products, O(n) work per output), the
    same function as ``zy_rfft_planar`` for every shape within
    ``zy_rfft_fits``. On no route since the cluster FFT kernel takes every
    shape (Bluestein for a prime factor above 7, nz = 1 with an empty z
    transform); kept as the time that route replaced. Counted as
    ``zy_rfft_planar_dense``; the plain matmuls on the CPU."""
    name = "zy_rfft_planar_dense"
    if _zy_check(name, x) == "cpu":
        return _zy_rfft_plain(x)
    nx, ny, nz = (int(s) for s in x.shape)
    re, im = _zy_outputs(x)
    _launch(name, x.device, _build.library().fava_zy_rfft, x.data_ptr(), re.data_ptr(),
            im.data_ptr(), nx, ny, nz, wrote=(re, im))
    return re, im


def _plan_ints(plan: ZyFftPlan):
    return (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())


@lru_cache(maxsize=16)
def _zy_fft_tables(plan: ZyFftPlan, device: str) -> torch.Tensor:
    """The plan's tables in device memory, built once per plan and card by
    the library (twiddles in double, rounded once to float); every block of
    the FFT kernel copies them into its shared memory. Read-only."""
    ints = _plan_ints(plan)
    lib = _build.library()
    nbytes = lib.fava_zy_fft_table_bytes(ctypes.addressof(ints))
    if nbytes < 0:
        raise ValueError(f"zy_rfft_planar: the kernel refuses the plan {plan}")
    out = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        err = lib.fava_zy_fft_tables(ctypes.addressof(ints), out.data_ptr(),
                                     torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"zy_rfft_planar: building the tables failed with error {err} "
                           f"({lib.fava_error_string(err).decode()})")
    return out


def zy_fft_active_clusters(plan: ZyFftPlan, device="cuda") -> int:
    """Clusters of the FFT kernel under ``plan`` that fit the card at once
    (cudaOccupancyMaxActiveClusters); 0 means the launch cannot run."""
    ints = _plan_ints(plan)
    with torch.cuda.device(torch.device(device)):
        n = _build.library().fava_zy_fft_clusters(ctypes.addressof(ints))
    if n < 0:
        raise RuntimeError(f"zy_rfft_planar: occupancy query failed with error {-n}")
    return n


def zy_rfft_planar(x: torch.Tensor):
    """(re, im), each (nx, ny, nz//2+1): the rfft along z then the DFT
    along y of a real (nx, ny, nz) volume, unnormalized, planar
    (fava_tpu/experiments/pallas_dft.py:92). On CUDA: float32, contiguous,
    within ``zy_rfft_fits``, through the cluster FFT kernel under
    ``_zy_fft_plan``: mixed radix for 7-smooth y and z, Bluestein's
    algorithm for an axis with a prime factor above 7, no z transform for
    nz = 1. On the CPU the plain dense matmuls."""
    name = "zy_rfft_planar"
    if _zy_check(name, x) == "cpu":
        return _zy_rfft_plain(x)
    return _zy_rfft_fft(x, _zy_fft_plan(int(x.shape[1]), int(x.shape[2])))


def _zy_rfft_fft(x: torch.Tensor, plan: ZyFftPlan):
    """The cluster FFT kernel on a checked CUDA volume under ``plan``."""
    nx = int(x.shape[0])
    ints = _plan_ints(plan)
    tables = _zy_fft_tables(plan, str(x.device))
    re, im = _zy_outputs(x)
    vec = int(x.data_ptr() % 8 == 0)  # float2 row loads
    _launch("zy_rfft_planar", x.device, _build.library().fava_zy_fft, x.data_ptr(), re.data_ptr(),
            im.data_ptr(), tables.data_ptr(), nx, ctypes.addressof(ints), vec, wrote=(re, im))
    return re, im


# ---------------------------------------------------------------------------
# K5 / K6: per-(block, row) moments of an AMR block stack


def _block_row_moments_plain(d, vx, vy, vz) -> torch.Tensor:
    d, vx, vy, vz = (a.to(accum_dtype()) for a in (d, vx, vy, vz))

    def rows(a):
        return a.sum(dim=(2, 3))

    return torch.stack(
        [rows(d), rows(vx), rows(vy), rows(vz), rows(d * vx), rows(d * vy), rows(d * vz)]
    )


def _block_centered_plain(d, vx, vy, vz, means) -> torch.Tensor:
    d, vx, vy, vz = (a.to(accum_dtype()) for a in (d, vx, vy, vz))
    means = means.to(accum_dtype())

    def rows(a):
        return a.sum(dim=(2, 3))

    cx = vx - means[0][..., None, None]
    cy = vy - means[1][..., None, None]
    cz = vz - means[2][..., None, None]
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


def _check_stack(name: str, fields) -> Tuple[int, int, int]:
    """(nblocks, ncx, ncy*ncz) of four same-shaped non-empty 4D stacks."""
    d = fields[0]
    if d.ndim != 4 or any(f.shape != d.shape for f in fields) or d.numel() == 0:
        raise ValueError(f"{name}: four non-empty same-shaped (nB, ncx, ncy, ncz) stacks required")
    nb, ncx, ncy, ncz = (int(s) for s in d.shape)
    return nb, ncx, ncy * ncz


def _row_blocks(nrows: int, device: torch.device) -> int:
    warps = 256 // 32
    return max(1, min(-(-nrows // warps), 32 * _sm_count(device.index or 0)))


def block_row_moments(dens, vx, vy, vz) -> torch.Tensor:
    """(7, nB, ncx) float64 raw moments [d, v_i, d*v_i] of each (block,
    x row) of a block stack (nB, ncx, ncy, ncz)."""
    name = "block_row_moments"
    fields = (dens, vx, vy, vz)
    nb, ncx, row_len = _check_stack(name, fields)
    if _device_kind(name, *fields) == "cpu":
        return _block_row_moments_plain(*fields)
    _check_cuda(name, *fields)
    nrows = nb * ncx
    out = torch.empty((NRAW, nb, ncx), dtype=torch.float64, device=dens.device)
    _launch(
        name, dens.device, _build.library().fava_block_row_moments, *(f.data_ptr() for f in fields),
        out.data_ptr(), nrows, row_len, _vec_ok(row_len, *fields), _row_blocks(nrows, dens.device),
        wrote=(out,),
    )
    return out


def block_centered_row_moments(dens, vx, vy, vz, means) -> torch.Tensor:
    """(9, nB, ncx) float64: [sum d*ci*cj (xx,xy,xz,yy,yz,zz), sum d*ci
    (3)] per (block, x row), ci = vi - means[i]; ``means`` is (3, nB,
    ncx), float64 on CUDA."""
    name = "block_centered_row_moments"
    fields = (dens, vx, vy, vz)
    nb, ncx, row_len = _check_stack(name, fields)
    if tuple(means.shape) != (3, nb, ncx):
        raise ValueError(f"{name}: means must be (3, {nb}, {ncx}), got {tuple(means.shape)}")
    if _device_kind(name, *fields, means) == "cpu":
        return _block_centered_plain(*fields, means)
    _check_cuda(name, *fields)
    _check_cuda(name, means, dtype=torch.float64)
    nrows = nb * ncx
    out = torch.empty((NCEN, nb, ncx), dtype=torch.float64, device=dens.device)
    _launch(
        name, dens.device, _build.library().fava_block_centered_row_moments,
        *(f.data_ptr() for f in fields), means.data_ptr(), out.data_ptr(), nrows, row_len,
        _vec_ok(row_len, *fields), _row_blocks(nrows, dens.device), wrote=(out,),
    )
    return out


# ---------------------------------------------------------------------------
# K7: AMR -> uniform regrid (injection prolongation)


def _regrid_flat_plain(leaf_table, offsets, scales, out_shape, origin, ncells, block_shape):
    """Flat source index and validity of every output cell: regrid.py's
    closed form (fava_tpu/ops/regrid.py:177-189)."""
    nx, ny, nz = out_shape
    ncx, ncy, ncz = ncells
    bx, by, bz = block_shape
    dev = leaf_table.device
    gx = (torch.arange(nx, device=dev) + origin[0])[:, None, None]
    gy = (torch.arange(ny, device=dev) + origin[1])[None, :, None]
    gz = (torch.arange(nz, device=dev) + origin[2])[None, None, :]
    blkid = leaf_table[gx // ncx, gy // ncy, gz // ncz].to(torch.int64)
    safe = torch.clamp(blkid, min=0)
    s = scales[safe]
    cx = torch.clamp((gx - offsets[safe, 0]) // s, 0, bx - 1)
    cy = torch.clamp((gy - offsets[safe, 1]) // s, 0, by - 1)
    cz = torch.clamp((gz - offsets[safe, 2]) // s, 0, bz - 1)
    flat = ((safe * bx + cx) * by + cy) * bz + cz
    return flat, blkid >= 0


def _regrid_plain(stacks, leaf_table, offsets, scales, out_shape, origin, ncells):
    block_shape = tuple(int(s) for s in stacks[0].shape[1:])
    flat, valid = _regrid_flat_plain(
        leaf_table, offsets, scales, out_shape, origin, ncells, block_shape
    )
    zero = torch.zeros((), dtype=stacks[0].dtype, device=stacks[0].device)
    return [torch.where(valid, torch.take(s, flat), zero) for s in stacks]


def _regrid_shifts(scales: torch.Tensor) -> torch.Tensor:
    """log2 of the block scales, which are powers of two (2^(lmax - level))."""
    shifts = torch.round(torch.log2(scales.double())).to(torch.int32)
    if not torch.equal(torch.ones_like(scales) << shifts.to(scales.dtype), scales):
        raise ValueError("regrid_fields: block scales must be powers of two")
    return shifts


REGRID_THREADS = 256  # threads of a K7 block (kRegridThreads in csrc/amr_kernels.cu)


REGRID_THREADS_Z = 16  # most threads along z: a thread takes every 16th 4-cell group of a row


def _regrid_threads(nz: int) -> int:
    """K7's threads along z: the least power of two that covers a row's
    4-cell groups (``_regrid_groups``), at most
    REGRID_THREADS_Z. The block holds REGRID_THREADS // this many rows;
    a thread takes every this-many-th group of its row, so the row's
    setup serves several groups (nz = 512: 16 rows a block, 8 groups a
    thread; faster than 32-256 threads along z on an NVIDIA H100 80GB
    HBM3 at 700 W, probe_bin_regrid.py)."""
    return min(REGRID_THREADS_Z, 1 << max(0, _regrid_groups(nz) - 1).bit_length())


def _regrid_groups(nz: int) -> int:
    """4-cell groups of a K7 output row: groups are aligned to the flat
    output, so rows start aligned when 4 divides nz, and otherwise 0-3
    cells into their first group."""
    return nz // 4 if nz % 4 == 0 else (nz + 6) // 4


def _regrid_blocks(nrows: int, threads: int) -> int:
    """Blocks of a K7 launch: one for each REGRID_THREADS // threads rows.
    Rows of coarse tiles cost less than rows of fine ones, so the card's
    block scheduler balances them better than a grid of one wave striding
    over the rows (full-domain regrid on an NVIDIA H100 80GB HBM3 at 700 W:
    1.652 against 1.912 ms, probe_bin_regrid.py)."""
    return max(1, -(-nrows // (REGRID_THREADS // threads)))


@lru_cache(maxsize=4)
def regrid_blocks_per_sm(wide: bool, index: int = 0) -> int:
    """Blocks of K7 (narrow or wide indices) that fit one SM of card
    ``index`` at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    with torch.cuda.device(index):
        n = _build.library().fava_regrid_blocks_per_sm(int(wide))
    if n <= 0:
        raise RuntimeError(f"regrid_fields: occupancy query failed ({n})")
    return n


def _regrid_wide(out_shape, origin, ncells, tile_shape) -> bool:
    """Whether K7 needs 64-bit coordinates (the C entry's test)."""
    (nx, ny, nz), (ox, oy, oz), (ncx, _ncy, ncz) = out_shape, origin, ncells
    ty, tz = tile_shape
    lim = 1 << 31
    return not (nx * ny < lim and ox + nx < lim and oy + ny < lim and oz + nz < lim
                and ty * tz * ((ox + nx) // ncx + 1) < lim and tz * ncz < lim)


def regrid_fields(stacks, leaf_table, offsets, scales, out_shape, origin, ncells):
    """Regrid each (nB, bx, by, bz) block stack onto the uniform grid.

    ``leaf_table`` (int32, one entry per fine-block tile; -1 where no
    source block) names the block covering each tile, ``offsets`` (int64,
    (nB, 3)) each block's first fine cell and ``scales`` (int64, (nB,))
    its power-of-two prolongation factor; ``out_shape`` and ``origin``
    give the output box in fine cells and ``ncells`` the tile extents.
    Returns one (nx, ny, nz) volume per stack, in the stacks' dtype.
    """
    name = "regrid_fields"
    stacks = list(stacks)
    first = stacks[0]
    if first.ndim != 4 or any(s.shape != first.shape for s in stacks):
        raise ValueError(f"{name}: same-shaped (nB, bx, by, bz) stacks required")
    out_shape = tuple(int(n) for n in out_shape)
    origin = tuple(int(o) for o in origin)
    ncells = tuple(int(c) for c in ncells)
    tables = (leaf_table, offsets, scales)
    if _device_kind(name, *stacks, *tables) == "cpu":
        return _regrid_plain(stacks, leaf_table, offsets, scales, out_shape, origin, ncells)
    _check_cuda(name, *stacks)
    _check_cuda(name, leaf_table, dtype=torch.int32)
    _check_cuda(name, offsets, scales, dtype=torch.int64)
    if leaf_table.ndim != 3 or tuple(offsets.shape) != (first.shape[0], 3):
        raise ValueError(f"{name}: a 3D leaf table and (nB, 3) block offsets required")
    shifts = _regrid_shifts(scales)
    nx, ny, nz = out_shape
    outs = [torch.empty(out_shape, dtype=first.dtype, device=first.device) for _ in stacks]
    if nx * ny * nz == 0:
        return outs
    _ty, ty, tz = (int(n) for n in leaf_table.shape)
    threads = _regrid_threads(nz)
    blocks = _regrid_blocks(nx * ny, threads)
    lib = _build.library()
    for k in range(0, len(stacks), REGRID_MAX_FIELDS):
        chunk = range(k, min(len(stacks), k + REGRID_MAX_FIELDS))
        srcs = (ctypes.c_void_p * len(chunk))(*(stacks[i].data_ptr() for i in chunk))
        dsts = (ctypes.c_void_p * len(chunk))(*(outs[i].data_ptr() for i in chunk))
        _launch(
            name, first.device, lib.fava_regrid_fields, ctypes.addressof(srcs),
            ctypes.addressof(dsts), len(chunk), leaf_table.data_ptr(), offsets.data_ptr(),
            shifts.data_ptr(), *out_shape, *origin, *ncells, ty, tz, *first.shape[1:], blocks,
            threads, wrote=[outs[i] for i in chunk],
        )
    return outs


# ---------------------------------------------------------------------------
# B8: the joint histogram (pdf2d)


def bin_index(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin of each value against monotone float64 ``edges`` with
    np.histogram's semantics (edges[b] <= v < edges[b+1], the last bin
    closed); -1 for values outside the edges and for NaN. Plain torch."""
    nb = edges.numel() - 1
    v = values.reshape(-1).to(torch.float64)
    idx = torch.searchsorted(edges, v, right=True) - 1
    idx = torch.where(v == edges[-1], nb - 1, idx)
    inside = (v >= edges[0]) & (v <= edges[-1])  # False for NaN
    return torch.where(inside, idx, -1)


def _host_edges(name: str, edges) -> np.ndarray:
    e = np.asarray(edges, dtype=np.float64).reshape(-1)
    if e.size < 2 or not (np.diff(e) >= 0).all():
        raise ValueError(f"{name}: edges must be >= 2 monotonically increasing values")
    return e


def _pdf2d_plain(x, y, xedges, yedges, weights=None) -> torch.Tensor:
    """Plain twin of ``pdf2d_counts`` on the tensors' device."""
    xe = torch.as_tensor(_host_edges("pdf2d", xedges), device=x.device)
    ye = torch.as_tensor(_host_edges("pdf2d", yedges), device=x.device)
    nbx, nby = xe.numel() - 1, ye.numel() - 1
    bx, by = bin_index(x, xe), bin_index(y, ye)
    keep = (bx >= 0) & (by >= 0)
    flat = (bx * nby + by)[keep]
    if weights is None:
        return torch.bincount(flat, minlength=nbx * nby).reshape(nbx, nby)
    out = torch.zeros(nbx * nby, dtype=torch.float64, device=x.device)
    out.index_add_(0, flat, weights.reshape(-1).to(torch.float64)[keep])
    return out.reshape(nbx, nby)


PDF2D_THREADS = 512  # threads of a B8 block (kThreads in csrc/pdf2d_kernels.cu)
PDF2D_SPAN = 8  # consecutive samples a lane bins per tile (kSpan)
PDF2D_TILE = 32 * PDF2D_SPAN  # samples a warp bins per tile
PDF2D_AXIS_HEAD = 5  # floats of an axis's head in the table (kAxisHead)
PDF2D_BLOCK_SAMPLES = 1 << 31  # samples a block may take: its uint32 counts never wrap
_F32_MAX_BINS = 1 << 22  # beyond this many bins an axis always searches its thresholds


def _ceil_f32(e: np.ndarray) -> np.ndarray:
    """The least float32 f with float64(f) >= e, elementwise."""
    with np.errstate(over="ignore"):
        f = np.asarray(e, dtype=np.float64).astype(np.float32)
    low = f.astype(np.float64) < e
    f[low] = np.nextafter(f[low], np.float32(np.inf))
    return f


def _floor_f32(e: np.ndarray) -> np.ndarray:
    """The largest float32 f with float64(f) <= e, elementwise."""
    with np.errstate(over="ignore"):
        f = np.asarray(e, dtype=np.float64).astype(np.float32)
    high = f.astype(np.float64) > e
    f[high] = np.nextafter(f[high], np.float32(-np.inf))
    return f


def _pdf2d_axis(edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One axis of B8's table: ``head`` = float32 [lo, hi, scale, fast_lo,
    fast_hi] and the float32 thresholds ``t`` (nb of them). For every
    float32 v: v >= edges[b] iff v >= t[b], and v <= edges[-1] iff v <= hi
    (lo = t[0]), so the bin of an inside v is the largest b with t[b] <= v.

    The kernel guesses b = floor(g), g = (v - lo) * scale in float32, and
    takes it without reading t when g < nb and g - b lies strictly between
    fast_lo and fast_hi. Why that is exact: with phi(u) = (u - lo) * scale
    in exact arithmetic, phi(t[b]) lies within D of b (D is measured here)
    and g within E of phi(v) (two float32 roundings of a value <= phi(hi),
    plus underflow); fast_lo >= D + E, fast_hi <= 1 - fast_lo. Then phi(v)
    lies strictly between phi(t[b]) and phi(t[b+1]), and phi is increasing.
    Edges far from uniform (D + E >= 1/4), non-finite thresholds or more
    than 2^22 bins switch the shortcut off (scale 0, fast_lo 1, fast_hi 0):
    the kernel then always searches t."""
    e = np.asarray(edges, dtype=np.float64)
    nb = e.size - 1
    t = _ceil_f32(e[:-1])
    lo, hi = t[0], _floor_f32(e[-1:])[0]
    span = float(hi) - float(lo)
    slack = np.inf
    with np.errstate(all="ignore"):
        scale = np.float32(nb / span) if span > 0 else np.float32(0.0)
        if nb < _F32_MAX_BINS and np.isfinite(t).all() and np.isfinite(hi) and np.isfinite(scale) \
                and scale > 0:
            s = float(scale)
            dev = float(np.abs((t.astype(np.float64) - float(lo)) * s - np.arange(nb)).max())
            slack = dev + 2.0**-22 * (span * s + 1.0) + 2.0**-148 * s + 1e-12 * (nb + 1)
    if slack < 0.25:
        fast_lo = _ceil_f32(np.array([slack]))[0]
        fast_hi = _floor_f32(np.array([1.0 - float(fast_lo)]))[0]
    else:
        scale, fast_lo, fast_hi = np.float32(0.0), np.float32(1.0), np.float32(0.0)
    return np.array([lo, hi, scale, fast_lo, fast_hi], dtype=np.float32), t


def _pdf2d_table(xedges: np.ndarray, yedges: np.ndarray) -> np.ndarray:
    """B8's float32 table: both axes' heads, then x's and y's thresholds."""
    (hx, tx), (hy, ty) = _pdf2d_axis(xedges), _pdf2d_axis(yedges)
    return np.concatenate([hx, hy, tx, ty])


def _threshold_bins(values: torch.Tensor, head: np.ndarray, t: np.ndarray) -> torch.Tensor:
    """The kernel's bin of each float32 value on one axis (``axis_bin`` in
    csrc/pdf2d_kernels.cu: the float32 guess where ``head`` certifies it,
    else the largest b with t[b] <= v), -1 outside and for NaN. Plain torch
    on the values' device; the tests hold it to ``bin_index``."""
    lo, hi, scale, fast_lo, fast_hi = (float(h) for h in head)
    nb = t.size
    v = values.reshape(-1).to(torch.float32)
    inside = (v >= lo) & (v <= hi)
    g = (v - lo) * scale  # two float32 roundings, as __fsub_rn and __fmul_rn
    b = torch.nan_to_num(g, nan=0.0).clamp(0.0, float(nb - 1)).to(torch.int64)
    f = g - b.to(torch.float32)
    fast = (g < nb) & (f > fast_lo) & (f < fast_hi)
    tt = torch.as_tensor(t, device=v.device)
    found = (torch.searchsorted(tt, v, right=True) - 1).clamp(0, nb - 1)
    return torch.where(inside, torch.where(fast, b, found), -1)


def _pdf2d_layout(nbx: int, nby: int, weighted: bool, optin: int) -> Tuple[bool, int]:
    """(histogram in shared memory, dynamic shared bytes a block) of an
    (nbx, nby) B8 launch on a card whose blocks may opt in to ``optin``
    shared bytes: the histogram (uint32 counts or f64 sums) and the table
    when both fit, else the table alone (the runs go to the output)."""
    table = 4 * (2 * PDF2D_AXIS_HEAD + nbx + nby)
    hist = nbx * nby * (8 if weighted else 4)
    if hist + table <= optin:
        return True, hist + table
    if table <= optin:
        return False, table
    raise ValueError(f"pdf2d: ({nbx}, {nby}) bins do not fit the kernel ({table} table bytes, "
                     f"{optin} shared bytes a block)")


def _pdf2d_blocks(n: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of a B8 launch over n samples: one wave (the blocks the card
    holds at once), fewer when there are fewer tiles than warps, and never
    so few that a block takes PDF2D_BLOCK_SAMPLES samples or more."""
    tiles = -(-int(n) // PDF2D_TILE)
    wave = max(1, min(-(-tiles // (PDF2D_THREADS // 32)), blocks_per_sm * sms))
    return max(wave, -(-int(n) // PDF2D_BLOCK_SAMPLES))


@lru_cache(maxsize=8)
def _smem_optin(index: int) -> int:
    """The dynamic shared bytes a block may opt in to on card ``index``."""
    with torch.cuda.device(index):
        n = _build.library().fava_pdf2d_smem_optin()
    if n <= 0:
        raise RuntimeError(f"shared memory query failed ({n})")
    return n


@lru_cache(maxsize=16)
def _pdf2d_blocks_per_sm(weighted: bool, shared: bool, smem: int, index: int = 0) -> int:
    """Blocks of B8's kernel (PDF2D_THREADS threads, ``smem`` dynamic
    shared bytes) that fit one SM of card ``index`` at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    with torch.cuda.device(index):
        n = _build.library().fava_pdf2d_blocks_per_sm(int(weighted), int(shared), int(smem))
    if n <= 0:
        raise RuntimeError(f"pdf2d: no block fits an SM with {smem} shared bytes (occupancy {n})")
    return n


def pdf2d_launch(n: int, nbx: int, nby: int, weighted: bool, device="cuda") -> Dict[str, int]:
    """B8's launch on ``device`` for n samples and (nbx, nby) bins:
    histogram in shared memory (1/0), dynamic shared bytes, blocks an SM
    and the grid."""
    index = torch.device(device).index or 0
    shared, smem = _pdf2d_layout(nbx, nby, weighted, _smem_optin(index))
    bps = _pdf2d_blocks_per_sm(weighted, shared, smem, index)
    return {"shared": int(shared), "smem": smem, "blocks_per_sm": bps,
            "blocks": _pdf2d_blocks(n, bps, _sm_count(index))}


def pdf2d_counts(x, y, xedges, yedges, weights=None) -> torch.Tensor:
    """Joint histogram of the samples (x, y) against float64 host edges,
    with np.histogram2d's semantics (half-open bins, the last closed;
    samples outside the edges and NaN dropped): (nbx, nby) exact int64
    counts, or float64 sums of ``weights`` per bin."""
    name = "pdf2d_counts" if weights is None else "pdf2d_weighted"
    samples = (x, y) if weights is None else (x, y, weights)
    if any(s.shape != x.shape for s in samples):
        raise ValueError(f"{name}: x, y (and weights) must share one shape")
    if _device_kind(name, *samples) == "cpu":
        return _pdf2d_plain(x, y, xedges, yedges, weights)
    _check_cuda(name, *samples)
    xe, ye = _host_edges(name, xedges), _host_edges(name, yedges)
    nbx, nby = xe.size - 1, ye.size - 1
    if nbx * nby >= 1 << 31:
        raise ValueError(f"{name}: {nbx} x {nby} bins exceed the kernel's int bin index")
    # From pinned memory, so the copy does not wait for the card to drain.
    table = torch.from_numpy(_pdf2d_table(xe, ye)).pin_memory().to(x.device, non_blocking=True)
    out_dtype = torch.int64 if weights is None else torch.float64
    out = torch.zeros((nbx, nby), dtype=out_dtype, device=x.device)
    n = x.numel()
    vec = int(all(s.data_ptr() % 16 == 0 for s in samples))  # float4 loads
    launch = pdf2d_launch(n, nbx, nby, weights is not None, x.device)
    _launch(
        name, x.device, _build.library().fava_pdf2d, x.data_ptr(), y.data_ptr(),
        None if weights is None else weights.data_ptr(), table.data_ptr(), out.data_ptr(), n, nbx,
        nby, vec, launch["shared"], launch["smem"], launch["blocks"], wrote=(out,),
    )
    return out


def pdf2d_hist_in_shared_memory(nbx: int, nby: int, weighted: bool, device="cuda") -> bool:
    """Whether the pdf2d kernel keeps an (nbx, nby) histogram in a block's
    shared memory on ``device`` (else it adds to the output in global
    memory)."""
    index = torch.device(device).index or 0
    return _pdf2d_layout(int(nbx), int(nby), weighted, _smem_optin(index))[0]
