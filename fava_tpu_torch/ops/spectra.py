"""Kinetic-energy and scalar power spectra: FFT + spherical shell binning.

Counterpart of fava_tpu/ops/spectra.py. The transforms are ``torch.fft``
(cuFFT on the card); fava_tpu's dense-DFT matmuls exist only for the
TPU. 3D volumes take real transforms and the Hermitian shell binning of
``ops/cuda_kernels.py``: the KE spectra of even x and y extents bin the
three transforms in one pass with B9 (powers, fold and binning, the
power volumes never formed); odd extents form the power volumes and bin
them with B10; the scalar spectra fold (K3) and bin (B4 or B10). 1D/2D
datasets take full complex transforms and a plain ``index_add_``
binning, as fava_tpu's generic branch does.

Over a device mesh (``parallel/``), ``sharded_power_spectra`` runs the
rank-local body ``local_spectra_fn``: the pencil transform of the
rank's x-slab, the powers of its y-slab, B6 on the transposed block at
the slab's global offset, then one all_reduce of the sums. It always
bins with B6's wrapper, whose plain twin serves CPU tensors: fava_tpu's
scatter-add branch and ``use_kernel_shell_binning`` exist for XLA's
trace cache and its TPU/interpret choice. ``scalar_spectrum(...,
mesh=)`` runs the same pencil transform on one field and bins the power
of the rank's y-slab with the one-channel B6 (``density_slab_shell_sums``,
which the sharded velocity spectra share).

Shell binning replicates ``scipy.stats.binned_statistic(..., "mean")``
with edges ``arange(max(n)//2) - 0.5``: right-inclusive last edge, NaN
for empty shells. Results are float64 numpy arrays on every device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.parallel.fft import _wavenumbers, pencil_rfft
from fava_tpu_torch.utils import accum_dtype
from fava_tpu_torch.utils.profiling import SPAN_POWERS, SPAN_TRANSFORMS, annotate


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
    ffts: Sequence[torch.Tensor], full_shape: Tuple[int, int, int], jx=None, kx=None, jy=None,
    ky=None,
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

    ``jx``/``kx`` (1D tensors of global x indices and their signed
    wavenumbers) give the rows of an x-chunk of the half-spectrum (the
    streamed step), and ``jy``/``ky`` the columns of a y-slab (a rank's
    share of the pencil transform); the Nyquist split applies where a
    global index is n/2, and only there.
    """
    with annotate(SPAN_POWERS):
        nx, ny, nz = full_shape
        nzr = ffts[0].shape[-1]
        rdt = ffts[0].real.dtype
        dev = ffts[0].device
        if kx is None:
            jx = torch.arange(nx, device=dev)
            kx = _wavenumbers(nx, rdt, dev)
        if ky is None:
            jy = torch.arange(ny, device=dev)
            ky = _wavenumbers(ny, rdt, dev)
        jx = jx.to(dev)[:, None, None]
        kx = kx.to(device=dev, dtype=rdt)[:, None, None]
        jy = jy.to(dev)[None, :, None]
        ky = ky.to(device=dev, dtype=rdt)[None, :, None]
        jz = torch.arange(nzr, device=dev)[None, None, :]
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


def kinetic_transforms(dens, vels) -> torch.Tensor:
    """The three normalized real transforms of sqrt(rho)*v of a 3D volume,
    as one contiguous (3, nx, ny, nz//2+1) complex stack, which B9 reads
    in place. Each transform writes its slot through ``out=``, scaled as
    it is written."""
    with annotate(SPAN_TRANSFORMS):
        nx, ny, nz = (int(s) for s in dens.shape)
        spec = torch.empty((3, nx, ny, nz // 2 + 1),
                           dtype=torch.promote_types(dens.dtype, torch.complex64),
                           device=dens.device)
        # The first two products go into the last slot, not yet written (a
        # half-spectrum holds a real volume), the third into sqrt(rho)'s
        # buffer: the stack costs no memory over three separate transforms.
        scratch = torch.view_as_real(spec[2]).view(-1)[: nx * ny * nz].view(nx, ny, nz)
        sqrt_d = torch.sqrt(dens)
        for c, v in enumerate(vels):
            w = sqrt_d.mul_(v) if c == 2 else torch.mul(sqrt_d, v, out=scratch)
            # A batch of one: cuFFT then writes the spectrum in row-major
            # order (without it, z-major), so the scaling into the slot is
            # one contiguous pass, not a transpose.
            torch.fft.rfftn(w[None], dim=(1, 2, 3), norm="forward", out=spec[c : c + 1])
        return spec


def kinetic_power_volumes(dens, vels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, longi) rfft power volumes of sqrt(rho)*v of a 3D volume:
    ``kinetic_transforms``, then ``rfft_power_volumes``."""
    return rfft_power_volumes(kinetic_transforms(dens, vels), tuple(int(s) for s in dens.shape))


def rfft_shell_sums(dens, vels, nbins: int):
    """(counts, sums[3]) of the kinetic-energy power of sqrt(rho)*v of a
    3D volume, shell-binned. Even x and y extents: the transforms'
    stack straight into B9 (powers, fold and binning in one pass, counts
    from the kernel). Odd ones: the power volumes and B10
    (``shell_bin_sums_rfft``)."""
    nx, ny, nz = (int(s) for s in dens.shape)
    if nx % 2 or ny % 2:
        total, longi = kinetic_power_volumes(dens, vels)
        return cuda_kernels.shell_bin_sums_rfft(total, longi, nbins, nz)
    parts = torch.view_as_real(kinetic_transforms(dens, vels))
    return cuda_kernels.shell_bin_powers_fused(parts[..., 0], parts[..., 1], nbins, nz)


def static_shell_counts(full_shape, nbins: int, device) -> torch.Tensor:
    """The Hermitian shell counts of a whole volume's rfft half-spectrum,
    a shape function: what every consumer of ``local_spectra_fn``
    substitutes for counts, since B6 bins values only."""
    return cuda_kernels.rfft_shell_counts(tuple(int(s) for s in full_shape), int(nbins), device)


def slab_shell_sums(ffts: Sequence[torch.Tensor], full_shape, lo: int, nbins: int) -> torch.Tensor:
    """(3, nbins) float64 shell sums [total, longitudinal, transverse] of
    one y-slab of the three normalized velocity half-spectra: ``ffts``
    are (nx, ny_l, nz//2+1), the columns ``lo .. lo+ny_l-1`` of the
    whole (nx, ny, nz//2+1) transforms. The powers, then B6 on the
    transposed block, whose slab axis is global y at offset ``lo``
    (fava_tpu/ops/spectra.py:191-209). The slabs' sums add up to the
    whole volume's."""
    nx, ny, nz = (int(s) for s in full_shape)
    nyl = int(ffts[0].shape[1])
    dev = ffts[0].device
    rdt = ffts[0].real.dtype
    jy = torch.arange(lo, lo + nyl, device=dev)
    ky = _wavenumbers(ny, rdt, dev)[lo : lo + nyl]
    total, longi = rfft_power_volumes(ffts, (nx, ny, nz), jy=jy, ky=ky)
    return cuda_kernels.shell_bin_values_rfft_chunk(
        total.transpose(0, 1).contiguous(),
        longi.transpose(0, 1).contiguous(),
        nbins,
        full_nx=ny,
        full_nz=nz,
        kx0=lo,
    )


def density_slab_shell_sums(p: torch.Tensor, full_shape, lo: int, nbins: int) -> torch.Tensor:
    """(1, nbins) float64 Hermitian-weighted shell sums of a real density
    ``p`` on one y-slab of a half-spectrum: ``p`` is (nx, ny_l,
    nz//2+1), the columns ``lo .. lo+ny_l-1`` of the whole (nx, ny,
    nz//2+1) grid. The rank-local body of every sharded one-density
    spectrum: the density transposed so that its slab axis is global y,
    binned by B6 with one channel at offset ``lo`` (any ``nbins``). The
    slabs' sums add up to the whole volume's."""
    _nx, ny, nz = (int(s) for s in full_shape)
    return cuda_kernels.shell_bin_values_rfft_chunk(p.transpose(0, 1).contiguous(), None, nbins,
                                                    full_nx=ny, full_nz=nz, kx0=lo)


def shell_means_from_sums(sums: torch.Tensor, full_shape, nbins: int) -> np.ndarray:
    """The shell means of joined (C, nbins) or (nbins,) Hermitian shell
    sums of a whole volume's half-spectrum: the static counts
    (``static_shell_counts``, any ``nbins``), NaN for empty shells."""
    return _shell_means(static_shell_counts(full_shape, nbins, sums.device), sums)


def scalar_spectrum_from_slabs(fhats: Sequence[torch.Tensor], full_shape,
                               ranks: runtime.SpaceRanks) -> Dict[str, np.ndarray]:
    """The scalar spectrum of a 3D volume from the y-slabs of its
    normalized half-spectrum that ``ranks`` plays (``fhats``, in that
    order): the power of each slab through ``density_slab_shell_sums``,
    one join of the sums, the static counts and the shell means."""
    full_shape = tuple(int(s) for s in full_shape)
    nbins = max(full_shape) // 2 - 1
    cols = full_shape[1] // ranks.d
    parts = [density_slab_shell_sums(_abs2(f), full_shape, r * cols, nbins)
             for f, r in zip(fhats, ranks.ranks)]
    k, factor = _shell_integral_factor(nbins, 3)
    return {"k": k, "power": shell_means_from_sums(ranks.reduce(parts)[0], full_shape, nbins) * factor}


def local_spectra_fn(full_shape, nbins: int, mesh, axis_name: str = runtime.SPACE_AXIS):
    """The rank-local spectra body over the ``axis_name`` axis of ``mesh``.

    Returns ``local(d_loc, *v_loc) -> (counts, sums[3])`` for the rank's
    x-slabs of one snapshot: rfft2 over (y, z), the x <-> y exchange, the
    FFT over x (the two ``norm="forward"`` factors make up 1/ntot), the
    powers and B6 binning of the local y-slab (``slab_shell_sums``), one
    all_reduce of the (3, nbins) float64 sums on the axis's group, and the
    static counts. Shared by ``sharded_power_spectra`` and the pod series
    step (flagship.sharded_series_analysis_step).
    """
    nx, ny, nz = (int(s) for s in full_shape)
    group = mesh.get_group(axis_name)
    d = runtime.axis_size(mesh, axis_name)
    lo = int(mesh.get_local_rank(axis_name)) * (ny // d)

    def local(d_loc, *v_loc):
        sqrt_d = torch.sqrt(d_loc)
        ffts = [pencil_rfft(sqrt_d * v, mesh, axis_name) for v in v_loc]
        sums = slab_shell_sums(ffts, (nx, ny, nz), lo, nbins)
        dist.all_reduce(sums, group=group)
        return static_shell_counts((nx, ny, nz), nbins, d_loc.device), sums

    return local


def sharded_power_spectra(dens, vels, mesh, nbins: int, axis_name: str = None):
    """(counts, sums[3]) of the shell-binned kinetic-energy powers of a
    volume slab-sharded over ``mesh``: ``dens`` and ``vels`` are the
    rank's x-slabs; every rank gets the whole volume's result."""
    axis_name = axis_name or runtime.SPACE_AXIS
    nxl, ny, nz = (int(s) for s in dens.shape)
    full = (nxl * runtime.axis_size(mesh, axis_name), ny, nz)
    return local_spectra_fn(full, nbins, mesh, axis_name)(dens, *vels)


def _wavenumber_grid(shape: Tuple[int, ...], dtype, device):
    """Unshifted integer wavenumber component grids for an ndim volume."""
    ks = []
    nd = len(shape)
    for axis, n in enumerate(shape):
        kshape = [1] * nd
        kshape[axis] = n
        ks.append(_wavenumbers(n, dtype, device).reshape(kshape))
    return ks


def _k_abs(shape: Tuple[int, ...], dtype, device) -> torch.Tensor:
    """|k| on the full unshifted wavenumber grid of a 1D/2D/3D volume."""
    ks = _wavenumber_grid(shape, dtype, device)
    return torch.sqrt(sum(k * k for k in ks)) if len(shape) > 1 else ks[0].abs()


def _full_grid_shell_sums(k_abs: torch.Tensor, powers, nbins: int):
    """(counts, sums[len(powers)]) of full-grid powers by shell
    floor(|k| + 0.5), shells past nbins - 0.5 dropped (plain torch)."""
    keep = (k_abs <= nbins - 0.5).reshape(-1)
    idx = torch.clamp(torch.floor(k_abs + 0.5).to(torch.int64), 0, nbins - 1).reshape(-1)[keep]
    adt = accum_dtype()
    counts = torch.zeros(nbins, dtype=adt, device=k_abs.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=adt))
    stacked = torch.stack([p.reshape(-1)[keep] for p in powers]).to(adt)
    sums = torch.zeros((len(powers), nbins), dtype=adt, device=k_abs.device)
    sums.index_add_(1, idx, stacked)
    return counts, sums


def _shell_means(counts: torch.Tensor, sums: torch.Tensor) -> np.ndarray:
    means = torch.where(counts > 0, sums / torch.clamp(counts, min=1), torch.nan)
    return means.cpu().numpy().astype(np.float64)


def _squeeze_trailing(arr: torch.Tensor, ndim: int) -> torch.Tensor:
    """Drop singleton trailing axes of low-dimensional datasets; raise
    (a named error, not an assert) when a trailing axis is not
    singleton."""
    if arr.ndim > ndim:
        if not all(s == 1 for s in arr.shape[ndim:]):
            raise ValueError(
                f"non-singleton trailing axes {tuple(arr.shape[ndim:])} for ndim={ndim}"
            )
        arr = arr.reshape(arr.shape[:ndim])
    return arr


def _shell_integral_factor(nbins: int, ndim: int):
    """(k, k^(d-1) * 2*pi*(d-1)): the shell factor of the reference
    (FlashUniform.py:295-302), shared by the KE and scalar spectra."""
    k = np.arange(nbins, dtype=np.float64)
    factor = k ** (ndim - 1)
    if ndim > 1:
        factor = factor * (2.0 * np.pi * (ndim - 1))
    return k, factor


def kinetic_energy_spectra(
    dens, vels: Sequence[torch.Tensor], ndim: int = None, mesh=None
) -> Dict[str, np.ndarray]:
    """Total/longitudinal/transverse KE spectra of sqrt(rho)*v:
    {"k", "total", "longitudinal", "transverse"}, with the reference's
    integral factor k^(d-1) * 2*pi*(d-1). For 1D/2D datasets (singleton
    trailing axes) pass ``ndim``.

    With ``mesh`` (whose space axis is larger than 1) ``dens`` and
    ``vels`` are the rank's x-slabs of a 3D volume the placement rule
    shards, and the spectra are ``sharded_power_spectra``'s. Unlike
    fava_tpu, the active mesh is not taken by default: a slab and a whole
    volume cannot be told apart by their shapes, so the caller that
    placed the volume says which it holds."""
    ndim = int(ndim) if ndim is not None else len(vels)
    if dens.ndim > ndim:
        dens = _squeeze_trailing(dens, ndim)
        vels = [v.reshape(v.shape[:ndim]) for v in vels]
    shape = tuple(int(s) for s in dens.shape)
    if mesh is not None and runtime.space_axis_size(mesh) > 1:
        if ndim != 3:
            raise ValueError("sharded spectra need a 3D volume")
        shape = (shape[0] * runtime.space_axis_size(mesh),) + shape[1:]
    else:
        mesh = None
    nbins = max(shape) // 2 - 1  # len(bins)-1 with bins = arange(max//2)-0.5
    if mesh is not None:
        counts, sums = sharded_power_spectra(dens, vels, mesh, nbins)
    elif ndim == 3:
        counts, sums = rfft_shell_sums(dens, vels, nbins)
    else:
        sqrt_d = torch.sqrt(dens)
        ffts = [torch.fft.fftn(sqrt_d * v, norm="forward") for v in vels]
        ks = _wavenumber_grid(shape, ffts[0].real.dtype, dens.device)
        k_abs = _k_abs(shape, ffts[0].real.dtype, dens.device)
        total = 0.5 * sum(_abs2(f) for f in ffts)
        proj = sum(k * f for k, f in zip(ks, ffts)) / torch.clamp(k_abs, min=1e-30)
        longi = _abs2(proj)
        counts, sums = _full_grid_shell_sums(k_abs, [total, longi, total - longi], nbins)
    means = _shell_means(counts, sums)
    k, factor = _shell_integral_factor(nbins, ndim)
    return {
        "k": k,
        "total": means[0] * factor,
        "longitudinal": means[1] * factor,
        "transverse": means[2] * factor,
    }


def scalar_spectrum(field, ndim: int = None, mesh=None) -> Dict[str, np.ndarray]:
    """Shell-binned power spectrum of ONE scalar field: {"k", "power"},
    with the KE spectra's transform, binning and integral factor. 3D
    volumes bin the rfft power with one channel (fold + single-channel
    K4, or B10).

    With ``mesh`` the field is the rank's x-slab of a 3D volume
    slab-sharded over the mesh's space axis (any size, 1 included): the
    pencil transform (``pencil_rfft``), the power of the rank's y-slab
    binned by B6 with one channel at its offset, one all_reduce of the
    sums and the static counts (``scalar_spectrum_from_slabs``; fava_tpu's
    ``pfft3`` path, fava_tpu/ops/spectra.py:423-446). Every rank gets the
    whole volume's spectrum."""
    if mesh is not None:
        if field.ndim != 3 or (ndim is not None and int(ndim) != 3):
            raise ValueError("the sharded scalar spectrum needs a 3D volume")
        d = runtime.space_axis_size(mesh)
        full = (int(field.shape[0]) * d,) + tuple(int(s) for s in field.shape[1:])
        ranks = runtime.SpaceRanks(mesh)
        return scalar_spectrum_from_slabs(ranks.pencil_rfft([field]), full, ranks)
    ndim = int(ndim) if ndim is not None else field.ndim
    field = _squeeze_trailing(field, ndim)
    shape = tuple(int(s) for s in field.shape)
    nbins = max(shape) // 2 - 1
    if ndim == 3:
        p = _abs2(torch.fft.rfftn(field, norm="forward")).contiguous()
        counts, sums = cuda_kernels.shell_bin_sums_rfft_scalar(p, nbins, shape[-1])
    else:
        p = _abs2(torch.fft.fftn(field, norm="forward"))
        counts, sums = _full_grid_shell_sums(_k_abs(shape, p.dtype, field.device), [p], nbins)
        sums = sums[0]
    k, factor = _shell_integral_factor(nbins, ndim)
    return {"k": k, "power": _shell_means(counts, sums) * factor}
