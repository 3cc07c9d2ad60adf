"""Spectral velocity-field diagnostics: Helmholtz decomposition,
vorticity, dilatation, the enstrophy, helicity, transfer, decomposed and
anisotropic spectra, and the turbulence summary.

Counterpart of fava_tpu/ops/velocity.py. The transforms
are ``torch.fft`` (cuFFT on the card): an unnormalised forward ``rfftn``
over every axis and an ``irfftn`` that carries the whole 1/N, so the two
round-trip exactly, as fava_tpu's ``rfftn_fast``/``irfftn_fast``. The 3D
spectra bin their density through ``cuda_kernels.shell_bin_sums_rfft_scalar``
(K3 + the single-channel walk for even x and y extents, B10 otherwise);
the density is formed in the field dtype (float32 on the card) and the
walk sums it in float64. 2D data bins by a plain Hermitian-weighted
``index_add_``, as fava_tpu's scatter. The summary's sums and moments are
float64 on every device. The summary of a volume slab-sharded over a
device mesh (``mesh=``, ROADMAP A11d) is rank-local: packed float64 sums
of each rank's x-slab joined by all_reduces, and the spectral sums of
its y-slab of the pencil transform (``turbulence_summary_ranked``). So
are the enstrophy, helicity, transfer, decomposed and anisotropic
spectra (A11e, ``*_ranked``): the pencil transforms of the rank's
x-slabs, each binned density on its y-slab through the one-channel B6
(``spectra.density_slab_shell_sums``; the line and ring sums by
``index_add_``), one all_reduce of the sums; the dealiased transfer
brings its filtered velocities back through the inverse pencil
transform. So are the Helmholtz parts, vorticity and dilatation (A11f.1,
``*_ranked``): the pencil transforms, the projection or curl on each
y-slab, and the inverse pencil transform gives each rank its x-slab of
each output field; a single device runs the same bodies on one slab
(``SpaceRanks()``).

Conventions (fava_tpu's, unchanged):

* Periodic boxes. Wavenumbers are the signed integer grid, scaled by
  2*pi/L_i per axis when ``lengths`` is given, else integer k (the
  2*pi-periodic unit box).
* Every spectral operator zeroes the Nyquist wavenumber of even axes, so
  the Nyquist modes join the k = 0 mode in the solenoidal part.
* Spectra are shell means over the integer-|k| grid with Hermitian
  weights, 1/N forward transforms, NaN for empty shells and the
  k^(d-1) * 2*pi*(d-1) integral factor of the KE spectra; transfer and
  flux are shell sums (they telescope).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.spectra import density_slab_shell_sums, shell_means_from_sums
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype

GUARD = 1e-30  # fava_tpu's floor of every divisor that is an energy, |k| or |k|^2


def _phys_factors(lengths: Optional[Sequence[float]], nd: int):
    """Per-axis 2*pi/L factors turning integer wavenumbers into physical
    ones (unit factors when no domain lengths are given)."""
    if lengths is None:
        return (1.0,) * nd
    if len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    return tuple(2.0 * np.pi / float(L) for L in lengths)


def _signed_host(n: int) -> np.ndarray:
    """Signed integer wavenumbers of an axis of length n (float64, host)."""
    j = np.arange(n)
    return np.where(j <= (n - 1) // 2, j, j - n).astype(np.float64)


def _axis_view(values: np.ndarray, axis: int, nd: int, dtype, device) -> torch.Tensor:
    kshape = [1] * nd
    kshape[axis] = len(values)
    return torch.as_tensor(values, dtype=dtype, device=device).reshape(kshape)


def _k_grids(shape: Tuple[int, ...], dtype, device, lengths, zero_nyquist: bool, cols=None):
    """Broadcastable wavenumber grids on the trailing-axis rfft
    half-spectrum of a 2D or 3D volume (computed in float64 on the host,
    then cast). ``zero_nyquist`` zeroes the Nyquist entry of even axes.
    ``cols`` = (lo, n) cuts the y grid of a 3D volume to the columns
    lo .. lo+n-1: a rank's y-slab of the pencil transform (``_slab_cols``;
    None in 2D)."""
    nd = len(shape)
    grids = []
    for axis, (n, f) in enumerate(zip(shape, _phys_factors(lengths, nd))):
        kv = np.arange(n // 2 + 1, dtype=np.float64) if axis == nd - 1 else _signed_host(n)
        kv = kv * f
        if zero_nyquist and n % 2 == 0:
            kv[n // 2] = 0.0
        if cols is not None and axis == 1:
            kv = kv[cols[0] : cols[0] + cols[1]]
        grids.append(_axis_view(kv, axis, nd, dtype, device))
    return grids


def _rfft(v: torch.Tensor) -> torch.Tensor:
    """Unnormalised forward real transform over every axis."""
    return torch.fft.rfftn(v)


def _irfft(spec: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of ``_rfft`` (carries the whole 1/N) onto ``shape``."""
    return torch.fft.irfftn(spec, s=shape)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real.square() + z.imag.square()


def _vorticity_hats(vhats, shape, lengths, cols=None):
    """i k x v̂ on the half-spectrum grid (Nyquist-zeroed k), or on its
    y-slab ``cols`` (``_k_grids``)."""
    kx, ky, kz = _k_grids(shape, vhats[0].real.dtype, vhats[0].device, lengths, True, cols)
    wx, wy, wz = vhats
    return (1j * (ky * wz - kz * wy), 1j * (kz * wx - kx * wz), 1j * (kx * wy - ky * wx))


def _check_vels(vels, lengths, what: str):
    """Common validation; returns (shape, lengths as a tuple or None)."""
    shape = tuple(int(s) for s in vels[0].shape)
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"{what} requires 2D or 3D velocity volumes, got {nd}D")
    if len(vels) != nd:
        raise ValueError(f"{what}: {nd}D flow needs {nd} velocity components, got {len(vels)}")
    for i, v in enumerate(vels[1:], start=1):
        # a broadcast-compatible mismatch (an unsqueezed (n, n, 1)
        # component) would silently give full-shaped wrong fields
        if tuple(int(s) for s in v.shape) != shape:
            raise ValueError(
                f"{what}: velocity component {i} shape {tuple(v.shape)} "
                f"does not match component 0 shape {shape}"
            )
    if lengths is not None and len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    key = None if lengths is None else tuple(float(L) for L in lengths)
    return shape, key


def _vels(velx, vely, velz):
    return (velx, vely) if velz is None else (velx, vely, velz)


def _compressive_hats(vhats, ks):
    """k (k . v̂) / |k|^2 per component: the compressive projection
    (|k|^2 floored at 1e-30, so k = 0 and the Nyquist modes stay out)."""
    k2 = sum(k * k for k in ks)
    div = sum(k * w for k, w in zip(ks, vhats)) / torch.clamp(k2, min=GUARD)
    return [k * div for k in ks]


def helmholtz_decompose(velx, vely, velz=None, lengths=None,
                        mesh=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Solenoidal/compressive split of a periodic velocity field.

    The compressive (curl-free) part is the spectral projection onto k̂;
    the solenoidal part is the remainder, so the two sum to the input
    exactly. The k = 0 and Nyquist modes land in the solenoidal part.
    2D flows pass two (nx, ny) components and ``velz=None``. Returns
    {"solenoidal": {velx, vely[, velz]}, "compressive": {...}} on the
    input's device. With ``mesh`` the components are the rank's x-slabs
    of a 3D volume slab-sharded over the mesh's space axis, and so are
    the parts (:func:`helmholtz_decompose_ranked`).
    """
    vels = _vels(velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "helmholtz_decompose")
    ranks = _mesh_ranks(shape, "Helmholtz decomposition", mesh)
    return helmholtz_decompose_ranked([list(vels)], ranks, key)[0]


def helmholtz_decompose_ranked(vel_slabs, ranks,
                               lengths) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """The Helmholtz split of the volume whose x-slabs ``ranks`` plays (a
    list of the components each; the whole volumes on a single device):
    the pencil transforms, the compressive projection on each y-slab, the
    inverse pencil transform of each compressive component (one at a
    time), and the solenoidal part as each slab minus its compressive
    part. One {"solenoidal": ..., "compressive": ...} of x-slabs a slab."""
    shape = _ranked_shape(vel_slabs, ranks)
    hats, cols = _pencil_hats(vel_slabs, ranks)
    rdt, dev = hats[0][0].real.dtype, hats[0][0].device
    comp_hats = [_compressive_hats([h[k] for h in hats],
                                   _k_grids(shape, rdt, dev, lengths, True, c))
                 for k, c in enumerate(cols)]
    del hats
    comp = [ranks.pencil_irfft(_take(comp_hats, c), shape) for c in range(len(shape))]
    names = ("velx", "vely", "velz")[: len(shape)]
    return [{"solenoidal": {n: v - comp[c][k] for c, (n, v) in enumerate(zip(names, vels))},
             "compressive": {n: comp[c][k] for c, n in enumerate(names)}}
            for k, vels in enumerate(vel_slabs)]


def _take(per_slab, c: int):
    """Entry ``c`` of each slab's list, dropped from it (so that a
    transform's y-slabs are freed once inverted)."""
    out = [lst[c] for lst in per_slab]
    for lst in per_slab:
        lst[c] = None
    return out


def vorticity(velx, vely, velz=None, lengths=None, mesh=None):
    """Vorticity ω = ∇ x v by spectral differentiation (periodic): the
    (ωx, ωy, ωz) tuple in 3D, the scalar ∂x vy - ∂y vx in 2D. With
    ``mesh`` the components are the rank's x-slabs of a 3D volume
    slab-sharded over the mesh's space axis, and so is ω
    (:func:`vorticity_ranked`)."""
    vels = _vels(velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "vorticity")
    return vorticity_ranked([list(vels)], _mesh_ranks(shape, "vorticity", mesh), key)[0]


def vorticity_ranked(vel_slabs, ranks, lengths):
    """The vorticity of the volume whose x-slabs ``ranks`` plays (a list
    of the components each): the pencil transforms, i k x v̂ on each
    y-slab, the inverse pencil transform of each component (one at a
    time). One (ωx, ωy, ωz) tuple of x-slabs a slab; in 2D (one device)
    the scalar ω."""
    shape = _ranked_shape(vel_slabs, ranks)
    hats, cols = _pencil_hats(vel_slabs, ranks)
    rdt, dev = hats[0][0].real.dtype, hats[0][0].device
    if len(shape) == 2:
        kx, ky = _k_grids(shape, rdt, dev, lengths, True)
        return ranks.pencil_irfft([1j * (kx * vy - ky * vx) for vx, vy in zip(*hats)], shape)
    whats = [list(_vorticity_hats([h[k] for h in hats], shape, lengths, c))
             for k, c in enumerate(cols)]
    del hats
    omega = [ranks.pencil_irfft(_take(whats, c), shape) for c in range(3)]
    return [tuple(w[k] for w in omega) for k in range(len(cols))]


def dilatation(velx, vely, velz=None, lengths=None, mesh=None) -> torch.Tensor:
    """Dilatation θ = ∇ . v by spectral differentiation (periodic). With
    ``mesh`` the components are the rank's x-slabs of a 3D volume
    slab-sharded over the mesh's space axis, and so is θ
    (:func:`dilatation_ranked`)."""
    vels = _vels(velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "dilatation")
    return dilatation_ranked([list(vels)], _mesh_ranks(shape, "dilatation", mesh), key)[0]


def dilatation_ranked(vel_slabs, ranks, lengths) -> List[torch.Tensor]:
    """The dilatation of the volume whose x-slabs ``ranks`` plays (a list
    of the components each): the pencil transforms, i k . v̂ on each
    y-slab, one inverse pencil transform. One x-slab a slab."""
    shape = _ranked_shape(vel_slabs, ranks)
    hats, cols = _pencil_hats(vel_slabs, ranks)
    rdt, dev = hats[0][0].real.dtype, hats[0][0].device
    div = [1j * sum(k * h[i] for k, h in zip(_k_grids(shape, rdt, dev, lengths, True, c), hats))
           for i, c in enumerate(cols)]
    del hats
    return ranks.pencil_irfft(div, shape)


def _hermitian_weights(shape: Tuple[int, ...], dtype, device) -> torch.Tensor:
    """Trailing-axis conjugate-pair weights on the rfft half grid (1 for
    the self-conjugate k = 0 and Nyquist planes, 2 otherwise)."""
    n_last = shape[-1]
    j = np.arange(n_last // 2 + 1)
    self_conj = j == 0
    if n_last % 2 == 0:
        self_conj = self_conj | (j == n_last // 2)
    return _axis_view(np.where(self_conj, 1.0, 2.0), len(shape) - 1, len(shape), dtype, device)


def _bin_rfft_stats(p: torch.Tensor, full_shape, nbins: int):
    """(counts, sums) float64 Hermitian-weighted shell statistics of one
    density on the trailing-axis half-spectrum. 3D: the scalar shell
    binning of ``cuda_kernels`` (K3 + single-channel walk, or B10); 2D: a
    Hermitian-weighted ``index_add_`` (shells floor(|k| + 0.5), cells past
    nbins - 0.5 dropped)."""
    if len(full_shape) == 3:
        return cuda_kernels.shell_bin_sums_rfft_scalar(p.contiguous(), nbins, full_shape[-1])
    adt = accum_dtype()
    ks = _k_grids(full_shape, adt, p.device, None, False)
    k_abs = torch.sqrt(sum(k * k for k in ks))
    weight = _hermitian_weights(full_shape, adt, p.device).expand(k_abs.shape)
    keep = (k_abs <= nbins - 0.5).reshape(-1)
    idx = torch.clamp(torch.floor(k_abs + 0.5).to(torch.int64), 0, nbins - 1).reshape(-1)[keep]
    w = weight.reshape(-1)[keep]
    counts = torch.zeros(nbins, dtype=adt, device=p.device).index_add_(0, idx, w)
    sums = torch.zeros(nbins, dtype=adt, device=p.device)
    sums.index_add_(0, idx, p.to(adt).reshape(-1)[keep] * w)
    return counts, sums


def _bin_rfft_power(p: torch.Tensor, full_shape, nbins: int) -> torch.Tensor:
    """Shell mean of one Hermitian density (NaN for empty shells)."""
    counts, sums = _bin_rfft_stats(p, full_shape, nbins)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1), torch.nan)


def _integral_factor(nbins: int, nd: int):
    k = np.arange(nbins, dtype=np.float64)
    return k, k ** (nd - 1) * (2.0 * np.pi * (nd - 1))


def _hats_density(vhats, shape, lengths, which: str, cols=None) -> torch.Tensor:
    """The enstrophy or helicity density of the normalized half-spectra
    ``vhats`` (their y-slab ``cols`` in 3D, ``_k_grids``)."""
    if len(shape) == 2:  # enstrophy only (helicity vanishes in 2D)
        kx, ky = _k_grids(shape, vhats[0].real.dtype, vhats[0].device, lengths, True)
        return 0.5 * _abs2(1j * (kx * vhats[1] - ky * vhats[0]))
    whats = _vorticity_hats(vhats, shape, lengths, cols)
    if which == "enstrophy":
        return 0.5 * sum(_abs2(w) for w in whats)
    return sum(v.real * w.real + v.imag * w.imag for v, w in zip(vhats, whats))


def spectrum_density(vels, shape, lengths, which: str) -> torch.Tensor:
    """The density the enstrophy ("enstrophy": 0.5 |ω̂|², 2D: the scalar
    out-of-plane ω) or helicity ("helicity": Re(v̂* . ω̂), signed) spectrum
    bins, on the rfft half-spectrum, 1/N forward transforms."""
    ntot = int(np.prod(shape))
    return _hats_density([_rfft(v) / ntot for v in vels], shape, lengths, which)


def _velocity_spectrum(vels, lengths, which: str, mesh=None) -> Dict[str, np.ndarray]:
    shape, key = _check_vels(vels, lengths, f"{which}_spectrum")
    if mesh is not None:
        return velocity_spectrum_ranked([list(vels)], _mesh_ranks(shape, f"{which} spectrum", mesh),
                                        key, which)
    nbins = max(shape) // 2 - 1
    mean = _bin_rfft_power(spectrum_density(vels, shape, key, which), shape, nbins).cpu().numpy()
    k, factor = _integral_factor(nbins, len(shape))
    return {"k": k, "power": mean * factor}


def enstrophy_spectrum(velx, vely, velz=None, lengths=None, mesh=None) -> Dict[str, np.ndarray]:
    """Shell-binned enstrophy spectrum 0.5 |ω̂|² (shell means, the KE
    spectra's binning and integral factor). 2D flows pass two components
    (ω is the scalar out-of-plane vorticity there). With ``mesh`` the
    components are the rank's x-slabs of a 3D volume slab-sharded over
    the mesh's space axis (any size, 1 included:
    :func:`velocity_spectrum_ranked`); every rank gets the whole
    volume's spectrum."""
    return _velocity_spectrum(_vels(velx, vely, velz), lengths, "enstrophy", mesh)


def helicity_spectrum(velx, vely, velz, lengths=None, mesh=None) -> Dict[str, np.ndarray]:
    """Shell-binned helicity spectrum Re(v̂* . ω̂): signed, so shells may
    be negative. 3D only (helicity vanishes identically in 2D flows).
    ``mesh`` as in :func:`enstrophy_spectrum`."""
    return _velocity_spectrum((velx, vely, velz), lengths, "helicity", mesh)


def _mesh_ranks(shape, what: str, mesh) -> runtime.SpaceRanks:
    """The ranks of an analysis of the rank's x-slabs (of ``shape``) of a
    3D volume slab-sharded over ``mesh``; the single device's with no
    mesh."""
    if mesh is not None and len(shape) != 3:
        raise ValueError(f"the sharded {what} needs a 3D volume")
    return runtime.SpaceRanks(mesh)


def _ranked_shape(vel_slabs, ranks) -> Tuple[int, ...]:
    """The whole shape of the volume whose x-slabs ``ranks`` plays (a
    list of the fields of each slab)."""
    rows, *rest = (int(s) for s in vel_slabs[0][0].shape)
    return (rows * ranks.d, *rest)


def _slab_cols(shape, ranks):
    """The (lo, columns) of the y-slab of each slab that ``ranks`` plays
    (``_k_grids``' ``cols``): the ky columns of its share of the pencil
    transform of a 3D volume; None in 2D (one device, no pencil)."""
    if len(shape) != 3:
        return [None] * len(ranks.ranks)
    n = shape[1] // ranks.d
    return [(r * n, n) for r in ranks.ranks]


def _pencil_hats(vel_slabs, ranks):
    """The y-slabs of the normalized half-spectra of each component:
    ``[c][k]``, component c of the slab k that ``ranks`` plays, and the
    (lo, columns) of each slab's y-slab (``_slab_cols``)."""
    shape = _ranked_shape(vel_slabs, ranks)
    hats = [ranks.pencil_rfft([s[c] for s in vel_slabs]) for c in range(len(vel_slabs[0]))]
    return hats, _slab_cols(shape, ranks)


def velocity_spectrum_ranked(vel_slabs, ranks, lengths, which: str) -> Dict[str, np.ndarray]:
    """The enstrophy or helicity spectrum of the 3D volume whose x-slabs
    ``ranks`` plays (a list of the three components each): the pencil
    transforms, the density on each y-slab, the one-channel B6 on it
    (``spectra.density_slab_shell_sums``), one join of the sums, the
    static counts' shell means."""
    shape = _ranked_shape(vel_slabs, ranks)
    nbins = max(shape) // 2 - 1
    hats, cols = _pencil_hats(vel_slabs, ranks)
    parts = [density_slab_shell_sums(_hats_density([h[k] for h in hats], shape, lengths, which, c),
                                     shape, c[0], nbins)
             for k, c in enumerate(cols)]
    del hats
    k, factor = _integral_factor(nbins, 3)
    return {"k": k, "power": shell_means_from_sums(ranks.reduce(parts)[0], shape, nbins) * factor}


def _dealias_keep(shape: Tuple[int, ...], device) -> torch.Tensor:
    """2/3-rule mask on the rfft half grid: keep only the modes with
    |k_i| < n_i/3 on every axis (bool, broadcast from the axes' masks)."""
    nd = len(shape)
    keep = None
    for axis, n in enumerate(shape):
        k = np.arange(n // 2 + 1, dtype=np.float64) if axis == nd - 1 else np.abs(_signed_host(n))
        m = _axis_view(k < (n / 3.0), axis, nd, torch.bool, device)
        keep = m if keep is None else keep & m
    return keep


def dealiased_nbins(shape: Tuple[int, ...]) -> int:
    """Shell count covering every mode the 2/3-rule mask keeps: the kept
    corner modes reach |k| = sqrt(sum_i m_i^2), m_i = (n_i - 1) // 3, past
    the default max(n)//2 - 1 shells."""
    kmax = float(np.sqrt(sum(((n - 1) // 3) ** 2 for n in shape)))
    return int(np.floor(kmax + 0.5)) + 1


def transfer_spectrum(velx, vely, velz=None, lengths=None, dealias: bool = False,
                      mesh=None) -> Dict[str, np.ndarray]:
    """Spectral kinetic-energy transfer T(k) and flux Π(k).

    T(k) = -Σ_shell Re(v̂*_i · i k_j F[u_i u_j]): the shell-summed
    (Hermitian-weighted) nonlinear transfer in conservative form, so for
    a divergence-free, alias-free field Σ_k T(k) = 0. Π(k) = -Σ_{k'≤k}
    T(k') is the flux through k (positive: forward cascade). No integral
    factor: these are shell sums. ``dealias`` applies the 2/3 rule to the
    velocities before the products are formed (from the filtered fields,
    after the inverse transforms) and bins ``dealiased_nbins`` shells.
    2D flows pass two components. Returns {"k", "transfer", "flux"}.
    With ``mesh`` the components are the rank's x-slabs of a 3D volume
    slab-sharded over the mesh's space axis (:func:`transfer_spectrum_ranked`).
    """
    vels = _vels(velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "transfer_spectrum")
    if mesh is not None:
        return transfer_spectrum_ranked([list(vels)], _mesh_ranks(shape, "transfer spectrum", mesh),
                                        key, dealias)
    nbins = dealiased_nbins(shape) if dealias else max(shape) // 2 - 1
    _, sums = _bin_rfft_stats(transfer_density(vels, shape, key, dealias), shape, nbins)
    return _transfer_out(sums, nbins)


def _transfer_out(sums: torch.Tensor, nbins: int) -> Dict[str, np.ndarray]:
    """{"k", "transfer", "flux"} of the whole volume's transfer shell sums:
    the flux is minus their running sum."""
    stacked = torch.stack([sums, -torch.cumsum(sums, 0)]).cpu().numpy()
    return {"k": np.arange(nbins, dtype=np.float64), "transfer": stacked[0], "flux": stacked[1]}


def transfer_spectrum_ranked(vel_slabs, ranks, lengths, dealias: bool) -> Dict[str, np.ndarray]:
    """The transfer spectrum of the 3D volume whose x-slabs ``ranks``
    plays (a list of the three components each). The velocities'
    pencil transforms; with ``dealias`` the 2/3-rule mask on each y-slab
    and the filtered velocities back on the x-slabs through the inverse
    pencil transform (``ranks.pencil_irfft``). Then the six products
    u_i u_j formed on each x-slab and their pencil transforms, the
    advection terms and the transfer density on each y-slab, the
    one-channel B6 on it, one join of the sums; the flux is taken from
    the joined sums."""
    shape = _ranked_shape(vel_slabs, ranks)
    nbins = dealiased_nbins(shape) if dealias else max(shape) // 2 - 1
    vhats, cols = _pencil_hats(vel_slabs, ranks)
    if dealias:
        keep = _dealias_keep(shape, vel_slabs[0][0].device)
        vhats = [[w * keep[:, lo : lo + n] for w, (lo, n) in zip(h, cols)] for h in vhats]
        # The products must be formed from the FILTERED fields.
        filtered = [ranks.pencil_irfft(h, shape) for h in vhats]
        vel_slabs = [[f[k] for f in filtered] for k in range(len(cols))]
        del filtered
    rdt = vhats[0][0].real.dtype
    ks = [_k_grids(shape, rdt, vhats[0][0].device, lengths, True, c) for c in cols]
    adv = [[None] * 3 for _ in cols]
    for i in range(3):
        for j in range(i, 3):
            qs = ranks.pencil_rfft([v[i] * v[j] for v in vel_slabs])
            for k, q in enumerate(qs):
                for row, kk in [(i, ks[k][j])] + ([(j, ks[k][i])] if i != j else []):
                    adv[k][row] = kk * q if adv[k][row] is None else adv[k][row] + kk * q
            del qs
    del vel_slabs
    parts = []
    for k, (lo, _n) in enumerate(cols):
        density = sum(vhats[i][k].real * adv[k][i].imag - vhats[i][k].imag * adv[k][i].real
                      for i in range(3))
        adv[k] = None
        parts.append(density_slab_shell_sums(density, shape, lo, nbins))
        del density
    return _transfer_out(ranks.reduce(parts)[0], nbins)


def transfer_density(vels, shape, lengths, dealias: bool) -> torch.Tensor:
    """The transfer density -Re(v̂*_i · i k_j F[u_i u_j]) on the rfft
    half-spectrum that ``transfer_spectrum`` shell-sums (2/3-rule
    filtered velocities when ``dealias``)."""
    ntot = int(np.prod(shape))
    nd = len(shape)
    raw = [_rfft(v) for v in vels]  # unnormalised forward
    if dealias:
        keep = _dealias_keep(shape, vels[0].device)
        raw = [w * keep for w in raw]
        # The products must be formed from the FILTERED fields, or the
        # masked triads come back through aliasing.
        vels = [_irfft(w, shape) for w in raw]
    vhats = [w / ntot for w in raw]
    del raw
    ks = _k_grids(shape, vhats[0].real.dtype, vels[0].device, lengths, True)
    # adv_i = Σ_j k_j Q̂_ij, Q_ij = u_i u_j symmetric: each product
    # transform is added to the rows it feeds, then dropped.
    adv = [None] * nd
    for i in range(nd):
        for j in range(i, nd):
            q = _rfft(vels[i] * vels[j]) / ntot
            rows = [(i, ks[j])] + ([(j, ks[i])] if i != j else [])
            for row, k in rows:
                adv[row] = k * q if adv[row] is None else adv[row] + k * q
            del q
    t_density = None
    for i in range(nd):
        # -Re(conj(v̂_i) * (i adv_i)) = Re(v̂_i) Im(adv_i) - Im(v̂_i) Re(adv_i)
        term = vhats[i].real * adv[i].imag - vhats[i].imag * adv[i].real
        t_density = term if t_density is None else t_density + term
        adv[i] = None
    return t_density


def decomposed_ke_spectra(velx, vely, velz=None, dens=None, lengths=None,
                          mesh=None) -> Dict[str, np.ndarray]:
    """Solenoidal/compressive decomposition of the KE spectrum: the
    Helmholtz projection in spectral space, each power shell-binned with
    the KE spectra's conventions. The split is pointwise orthogonal, so
    total == solenoidal + compressive shell by shell. With ``dens`` the
    variable w = sqrt(rho) u is transformed instead. The k = 0 and
    Nyquist modes land in the solenoidal part. 2D flows pass two
    components. Returns {"k", "total", "solenoidal", "compressive"}.
    With ``mesh`` the fields are the rank's x-slabs of a 3D volume
    slab-sharded over the mesh's space axis
    (:func:`decomposed_ke_spectra_ranked`).
    """
    vels = _vels(velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "decomposed_ke_spectra")
    if dens is not None and tuple(int(s) for s in dens.shape) != shape:
        raise ValueError(f"dens shape {tuple(dens.shape)} does not match velocity shape {shape}")
    if mesh is not None:
        return decomposed_ke_spectra_ranked([list(vels)],
                                            _mesh_ranks(shape, "decomposed spectra", mesh),
                                            None if dens is None else [dens], key)
    nd = len(shape)
    nbins = max(shape) // 2 - 1
    ntot = int(np.prod(shape))
    if dens is not None:
        sq = torch.sqrt(dens)
        vels = [sq * v for v in vels]
        del sq
    vhats = [_rfft(v) / ntot for v in vels]
    del vels
    ks = _k_grids(shape, vhats[0].real.dtype, vhats[0].device, key, True)
    p_tot, p_sol, p_comp = _decomposed_powers(vhats, ks)
    del vhats
    stacked = torch.stack([_bin_rfft_power(p, shape, nbins) for p in (p_tot, p_sol, p_comp)])
    return _decomposed_out(stacked.cpu().numpy(), nbins, nd)


def _decomposed_powers(vhats, ks):
    """The total, solenoidal and compressive powers of the normalized
    half-spectra ``vhats`` on the wavenumber grids ``ks``."""
    comp_hats = _compressive_hats(vhats, ks)
    p_tot = p_sol = p_comp = None
    for w, c in zip(vhats, comp_hats):
        pt, ps, pc = 0.5 * _abs2(w), 0.5 * _abs2(w - c), 0.5 * _abs2(c)
        p_tot = pt if p_tot is None else p_tot + pt
        p_sol = ps if p_sol is None else p_sol + ps
        p_comp = pc if p_comp is None else p_comp + pc
    return p_tot, p_sol, p_comp


def _decomposed_out(means: np.ndarray, nbins: int, nd: int) -> Dict[str, np.ndarray]:
    k, f = _integral_factor(nbins, nd)
    return {"k": k, "total": means[0] * f, "solenoidal": means[1] * f, "compressive": means[2] * f}


def decomposed_ke_spectra_ranked(vel_slabs, ranks, dens=None, lengths=None) -> Dict[str, np.ndarray]:
    """The decomposed spectra of the 3D volume whose x-slabs ``ranks``
    plays (a list of the three components each; ``dens`` a list of the
    density slabs, which transforms sqrt(rho) u on each slab): the
    pencil transforms, the three powers on each y-slab, the one-channel
    B6 on each (three launches a slab), one join of the (3, nbins) sums,
    the static counts' shell means."""
    shape = _ranked_shape(vel_slabs, ranks)
    nbins = max(shape) // 2 - 1
    if dens is not None:
        vel_slabs = [[torch.sqrt(d) * v for v in vels] for vels, d in zip(vel_slabs, dens)]
    hats, cols = _pencil_hats(vel_slabs, ranks)
    del vel_slabs
    parts = []
    for k, c in enumerate(cols):
        vh = [h[k] for h in hats]
        powers = _decomposed_powers(vh, _k_grids(shape, vh[0].real.dtype, vh[0].device, lengths,
                                                 True, c))
        parts.append(torch.cat([density_slab_shell_sums(p, shape, c[0], nbins) for p in powers]))
        del vh, powers
    del hats
    return _decomposed_out(shell_means_from_sums(ranks.reduce(parts), shape, nbins), nbins, 3)


def _axis_bins(shape: Tuple[int, ...], axis: int) -> np.ndarray:
    """Bin (integer |k_axis|) of each index of the line along ``axis``:
    bins 0..n//2 inclusive, so the sums cover every mode."""
    n = shape[axis]
    if axis == len(shape) - 1:
        return np.arange(n // 2 + 1)
    return np.abs(_signed_host(n)).astype(np.int64)


def _perp_bin_index(shape: Tuple[int, ...], axis: int):
    """Flattened ring-bin index of the plane perpendicular to ``axis``
    (integer-rounded cylindrical radius) and its bin count; covers every
    mode."""
    nd = len(shape)
    grids = []
    for a in (a for a in range(nd) if a != axis):
        n = shape[a]
        grids.append(np.arange(n // 2 + 1, dtype=np.float64) if a == nd - 1
                     else np.abs(_signed_host(n)))
    if len(grids) == 1:
        r = grids[0]
    else:
        r = np.sqrt(grids[0][:, None] ** 2 + grids[1][None, :] ** 2)
    bidx = np.floor(r + 0.5).astype(np.int64)
    return bidx.ravel(), int(bidx.max()) + 1


def anisotropic_ke_spectra(velx, vely, velz=None, axis: int = 0, lengths=None,
                           mesh=None) -> Dict[str, np.ndarray]:
    """Axis-resolved kinetic-energy spectra relative to ``axis``:
    parallel E(k_par) (summed over each perpendicular plane, binned by
    integer |k_axis|, bins 0..n/2) and perpendicular E(k_perp) (summed
    along the axis, binned by the rounded cylindrical radius), each split
    into the ``axis`` velocity component (axial) and the others
    (transverse). Exact sums over every Hermitian mode, so sum(par_total)
    == sum(perp_total) == 0.5*mean(|u|^2). ``lengths`` is accepted for API
    symmetry (the binning is geometric). 2D flows pass two components.

    Returns {"k_par", "par_total", "par_axial", "par_transverse",
    "k_perp", "perp_total", "perp_axial", "perp_transverse"}.
    With ``mesh`` the components are the rank's x-slabs of a 3D volume
    slab-sharded over the mesh's space axis
    (:func:`anisotropic_ke_spectra_ranked`).
    """
    vels = _vels(velx, vely, velz)
    shape, _ = _check_vels(vels, lengths, "anisotropic_ke_spectra")
    nd = len(shape)
    if not 0 <= axis < nd:
        raise ValueError(f"axis must be in [0, {nd}), got {axis}")
    if mesh is not None:
        return anisotropic_ke_spectra_ranked([list(vels)],
                                             _mesh_ranks(shape, "anisotropic spectra", mesh),
                                             axis)
    ntot = int(np.prod(shape))
    packed = _line_ring_sums((_rfft(v) / ntot for v in vels), shape, axis, None).cpu().numpy()
    return _anisotropic_out(packed, shape, axis)


def _line_ring_sums(vhats, shape, axis: int, cols) -> torch.Tensor:
    """The packed float64 [par_axial, perp_axial, par_transverse,
    perp_transverse] sums of the normalized half-spectra ``vhats`` (an
    iterable of the components, read once), or of their y-slab ``cols``
    = (lo, n) of a 3D volume: the Hermitian-weighted power of the
    ``axis`` component and of the others, each summed over the planes
    perpendicular to ``axis`` and binned by |k_axis| (the line), and
    summed along ``axis`` and binned by ring (the plane). The bins are
    the host's (``_axis_bins``, ``_perp_bin_index``), cut to the slab's
    ky rows."""
    nd = len(shape)
    adt = accum_dtype()
    p_ax = p_tr = None
    for i, w in enumerate(vhats):
        q = 0.5 * _abs2(w) * _hermitian_weights(shape, w.real.dtype, w.device)
        del w
        if i == axis:
            p_ax = q if p_ax is None else p_ax + q
        else:
            p_tr = q if p_tr is None else p_tr + q
        del q
    dev = p_ax.device
    npar = shape[axis] // 2 + 1
    line_host = _axis_bins(shape, axis)
    ring_host, nperp = _perp_bin_index(shape, axis)
    if cols is not None:
        lo, n = cols
        if axis == 1:
            line_host = line_host[lo : lo + n]
        else:
            plane = [shape[a] if a != nd - 1 else shape[a] // 2 + 1 for a in range(nd) if a != axis]
            ring_host = ring_host.reshape(plane)
            ring_host = (ring_host[lo : lo + n] if axis == 0 else ring_host[:, lo : lo + n]).ravel()
    line_bins = torch.as_tensor(line_host, device=dev)
    ring = torch.as_tensor(ring_host, device=dev)
    perp_axes = tuple(a for a in range(nd) if a != axis)

    def one(p):
        # float64 sums of the density: the line over the perpendicular
        # planes, binned by |k_axis|; the plane along the axis, by ring.
        line = p.sum(dim=perp_axes, dtype=adt)
        epar = torch.zeros(npar, dtype=adt, device=dev).index_add_(0, line_bins, line)
        plane = p.sum(dim=axis, dtype=adt).reshape(-1)
        eperp = torch.zeros(nperp, dtype=adt, device=dev).index_add_(0, ring, plane)
        return epar, eperp

    return torch.cat([*one(p_ax), *one(p_tr)])


def anisotropic_ke_spectra_ranked(vel_slabs, ranks, axis: int = 0) -> Dict[str, np.ndarray]:
    """The anisotropic spectra of the 3D volume whose x-slabs ``ranks``
    plays (a list of the three components each): the pencil transforms,
    each y-slab's line and ring sums (``_line_ring_sums``, its ky rows
    of the host bins, ``index_add_``), one join of the packed
    (2 npar + 2 nperp) vector."""
    shape = _ranked_shape(vel_slabs, ranks)
    hats, cols = _pencil_hats(vel_slabs, ranks)
    parts = [_line_ring_sums((h[k] for h in hats), shape, axis, c) for k, c in enumerate(cols)]
    del hats
    return _anisotropic_out(ranks.reduce(parts).cpu().numpy(), shape, axis)


def _anisotropic_out(packed: np.ndarray, shape, axis: int) -> Dict[str, np.ndarray]:
    npar = shape[axis] // 2 + 1
    nperp = (len(packed) - 2 * npar) // 2
    par_ax, perp_ax = packed[:npar], packed[npar : npar + nperp]
    par_tr, perp_tr = packed[npar + nperp : 2 * npar + nperp], packed[2 * npar + nperp :]
    return {
        "k_par": np.arange(npar, dtype=np.float64),
        "par_total": par_ax + par_tr,
        "par_axial": par_ax,
        "par_transverse": par_tr,
        "k_perp": np.arange(nperp, dtype=np.float64),
        "perp_total": perp_ax + perp_tr,
        "perp_axial": perp_ax,
        "perp_transverse": perp_tr,
    }


def summary_names(has_dens: bool, has_pres: bool) -> Tuple[str, ...]:
    """Entry order of the packed turbulence-summary vector."""
    names = ["u_rms", "kinetic_energy"]
    if has_dens:
        names += ["kinetic_energy_density", "mean_s", "sigma_s"]
    if has_pres:
        names += ["mach_rms", "mach_max", "sound_speed_mean"]
    names += ["integral_scale", "taylor_scale", "compressive_fraction", "solenoidal_fraction",
              "dilatation_rms", "vorticity_rms"]
    return tuple(names)


def _summary_real_parts(vels, dens, pres, gamma):
    """A rank's pass-1 float64 sums (sum u^2; with dens sum rho u^2, sum
    rho; with pres sum M^2, sum c_s) and, with pres, the max of M^2."""
    adt = accum_dtype()
    u2 = sum(v.to(adt).square() for v in vels)
    sums = [u2.sum()]
    m2_max = None
    if dens is not None:
        da = dens.to(adt)
        sums += [(da * u2).sum(), da.sum()]
    if pres is not None:
        cs2 = gamma.to(adt) * pres.to(adt) / dens.to(adt)
        m2 = u2 / cs2
        sums += [m2.sum(), torch.sqrt(cs2).sum()]
        m2_max = m2.max()[None]
        del cs2, m2
    return torch.stack(sums), m2_max


def summary_spectral_sums(vhats, full_shape, lo: int, lengths) -> torch.Tensor:
    """The spectral body of the summary: (7,) float64 Hermitian sums
    [E, E(k = 0), E/|k|, k^2 E, compressive E, dilatation^2, enstrophy]
    of one y-slab of the normalized velocity half-spectra (``vhats``
    (nx, ny_l, nz//2+1), the columns lo .. lo+ny_l-1 of the whole 3D
    transforms; the whole half-spectra in 2D, ``lo`` 0). The k = 0 term
    is the slab's that holds ky = 0. The slabs' sums add up to the
    whole volume's."""
    nd = len(full_shape)
    adt = accum_dtype()
    rdt = vhats[0].real.dtype
    dev = vhats[0].device
    hw = _hermitian_weights(full_shape, adt, dev)
    ks = _k_grids(full_shape, rdt, dev, lengths, True)
    if nd == 3:
        ks[1] = ks[1][:, lo : lo + int(vhats[0].shape[1])]
    k2 = sum(k * k for k in ks)
    kmag = torch.sqrt(k2)
    e_mode = sum((0.5 * _abs2(w)).to(adt) for w in vhats) * hw
    e_sum = e_mode.sum()
    # The moments leave out the k = 0 (mean-flow) mode, where 1/k diverges.
    e_k0 = e_mode.reshape(-1)[0] if lo == 0 else torch.zeros((), dtype=adt, device=dev)
    inv_k = torch.where(kmag > 0, 1.0 / torch.clamp(kmag, min=GUARD), 0.0).to(adt)
    m_inv = (e_mode * inv_k).sum()
    k2a = k2.to(adt)
    m_2 = (e_mode * k2a).sum()
    del e_mode, inv_k, kmag
    # Exact Helmholtz energy split (k = 0 and Nyquist: solenoidal).
    div_amp2 = _abs2(sum(k * w for k, w in zip(ks, vhats))).to(adt) / torch.clamp(k2a, min=GUARD)
    comp_e = (0.5 * div_amp2 * hw).sum()
    # Enstrophy and dilatation by Parseval (Nyquist-zeroed derivatives).
    dil = (div_amp2 * k2a * hw).sum()
    del div_amp2, k2a
    if nd == 3:
        kx, ky, kz = ks
        wx, wy, wz = vhats
        whats = (1j * (ky * wz - kz * wy), 1j * (kz * wx - kx * wz), 1j * (kx * wy - ky * wx))
        ens = sum(_abs2(w).to(adt) for w in whats) * hw
    else:
        kx, ky = ks
        ens = _abs2(1j * (kx * vhats[1] - ky * vhats[0])).to(adt) * hw
    return torch.stack([e_sum, e_k0, m_inv, m_2, comp_e, dil, ens.sum()])


def turbulence_summary_ranked(vel_slabs, ranks, dens=None, pres=None, gamma=None,
                              lengths=None) -> torch.Tensor:
    """The packed float64 summary (``summary_names`` order) of the volume
    whose x-slabs ``ranks`` plays (a list of velocity components each;
    the whole volumes on a single device), with ``dens``, ``pres`` and
    ``gamma`` lists of the same slabs (a scalar gamma: the same 0-d
    tensor in each) or None. Pass 1: the pointwise sums, one packed
    all_reduce (and a MAX for the Mach number); pass 2 the sum of s =
    ln(rho/<rho>) and pass 3 of (s - <s>)^2, one all_reduce each; then
    the spectral sums of each slab's share of the transforms
    (``ranks.pencil_rfft``, ``summary_spectral_sums``), one all_reduce."""
    nd = len(vel_slabs[0])
    shape = [int(s) for s in vel_slabs[0][0].shape]
    shape[0] *= ranks.d
    shape = tuple(shape)
    adt = accum_dtype()
    ntot = float(np.prod(shape))
    count = len(vel_slabs)
    dens = dens if dens is not None else [None] * count
    pres = pres if pres is not None else [None] * count
    gamma = gamma if gamma is not None else [None] * count
    firsts = [_summary_real_parts(v, d, p, g) for v, d, p, g in zip(vel_slabs, dens, pres, gamma)]
    sums = ranks.reduce([f[0] for f in firsts]) / ntot
    out = {"u_rms": torch.sqrt(sums[0]), "kinetic_energy": 0.5 * sums[0]}
    k = 1
    if dens[0] is not None:
        out["kinetic_energy_density"] = 0.5 * sums[1]
        rho_mean = sums[2]
        k = 3
        # log-density contrast moments, float64 on every device
        logs = [torch.log(d.to(adt) / rho_mean) for d in dens]
        mu_s = ranks.reduce([s.sum()[None] for s in logs])[0] / ntot
        var_s = ranks.reduce([(s - mu_s).square().sum()[None] for s in logs])[0] / ntot
        del logs
        out["mean_s"] = mu_s
        out["sigma_s"] = torch.sqrt(var_s)
    if pres[0] is not None:
        out["mach_rms"] = torch.sqrt(sums[k])
        out["mach_max"] = torch.sqrt(ranks.reduce([f[1] for f in firsts], "max")[0])
        out["sound_speed_mean"] = sums[k + 1]
    del firsts

    # Spectral moments: one forward-transform set, Hermitian sums.
    cols = shape[1] // ranks.d
    vh = [ranks.pencil_rfft([s[c] for s in vel_slabs]) for c in range(nd)]
    parts = [summary_spectral_sums([vh[c][i] for c in range(nd)], shape, r * cols, lengths)
             for i, r in enumerate(ranks.ranks)]
    del vh
    e_sum, e_k0, m_inv, m_2, comp_e, dil, ens = ranks.reduce(parts)
    e_fluct = e_sum - e_k0
    # L = (3 pi/4) int E/k dk / int E dk, lambda^2 = 5 int E dk / int k^2 E dk
    # (pi/2 and 2 in 2D).
    out["integral_scale"] = ((3.0 * np.pi / 4.0 if nd == 3 else np.pi / 2.0) * m_inv
                             / torch.clamp(e_fluct, min=GUARD))
    out["taylor_scale"] = torch.sqrt((5.0 if nd == 3 else 2.0) * e_fluct
                                     / torch.clamp(m_2, min=GUARD))
    out["compressive_fraction"] = comp_e / torch.clamp(e_sum, min=GUARD)
    out["solenoidal_fraction"] = 1.0 - out["compressive_fraction"]
    out["dilatation_rms"] = torch.sqrt(dil)
    out["vorticity_rms"] = torch.sqrt(ens)
    names = summary_names(dens[0] is not None, pres[0] is not None)
    return torch.stack([out[k].to(adt) for k in names])


def turbulence_summary_device(velx, vely, velz=None, dens=None, pres=None, gamma=5.0 / 3.0,
                              lengths=None, mesh=None) -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """:func:`turbulence_summary` without the host fetch: the packed
    float64 vector on the input's device and its name order (series
    drivers stack many of these and fetch once). With ``mesh`` the
    fields are the rank's x-slabs of a 3D volume slab-sharded over the
    mesh's space axis (``turbulence_summary_ranked``); every rank gets
    the whole volume's summary."""
    vels = _vels(velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "turbulence_summary")
    if mesh is not None and len(shape) != 3:
        raise ValueError("the sharded turbulence summary needs a 3D volume")
    if pres is not None and dens is None:
        raise ValueError("mach statistics need BOTH pres and dens")
    for name, f in (("dens", dens), ("pres", pres)):
        if f is not None and tuple(int(s) for s in f.shape) != shape:
            raise ValueError(f"{name} shape {tuple(f.shape)} does not match velocity shape {shape}")
    g = None
    if pres is not None:
        # A scalar gamma stays 0-d (in float64: it is not rounded to the
        # card's float32); a per-cell field must match the volumes.
        if isinstance(gamma, (int, float)):
            g = torch.tensor(float(gamma), dtype=accum_dtype(), device=vels[0].device)
        else:
            g = torch.as_tensor(gamma, dtype=vels[0].dtype, device=vels[0].device)
        if g.ndim != 0 and tuple(int(s) for s in g.shape) != shape:
            raise ValueError(f"gamma shape {tuple(g.shape)} does not match velocity shape {shape}")
    ranks = runtime.SpaceRanks(mesh)
    vec = turbulence_summary_ranked([list(vels)], ranks, None if dens is None else [dens],
                                    None if pres is None else [pres], None if g is None else [g],
                                    key)
    return vec, summary_names(dens is not None, pres is not None)


def turbulence_summary(velx, vely, velz=None, dens=None, pres=None, gamma=5.0 / 3.0,
                       lengths=None, mesh=None) -> Dict[str, float]:
    """One-call scalar turbulence report: ``u_rms``, specific
    ``kinetic_energy``; with ``dens`` the ``kinetic_energy_density``
    0.5<rho u^2> and the log-density moments ``mean_s``/``sigma_s``; with
    ``pres`` + ``dens`` the per-cell Mach statistics (c_s = sqrt(gamma p /
    rho), ``gamma`` a scalar or a per-cell field like FLASH's gamc); and
    from the same forward transforms the integral scale (3 pi/4) sum
    E/|k| / sum E (pi/2 in 2D), the Taylor scale sqrt(5 sum E / sum k^2 E)
    (factor 2 in 2D), the exact solenoidal/compressive energy fractions
    and the vorticity and dilatation rms. The scale moments leave out
    the k = 0 mode. Every sum is float64. ``mesh`` as in
    :func:`turbulence_summary_device`."""
    vec, names = turbulence_summary_device(velx, vely, velz, dens=dens, pres=pres, gamma=gamma,
                                           lengths=lengths, mesh=mesh)
    return dict(zip(names, vec.cpu().numpy().astype(np.float64).tolist()))
