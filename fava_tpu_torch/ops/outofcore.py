"""Out-of-core analyses for volumes beyond the card's memory.

Counterpart of fava_tpu/ops/outofcore.py: the flagship step
(``streamed_uniform_analysis``), the turbulence summary
(``streamed_turbulence_summary``), the Karman-Howarth velocity
correlations (``streamed_velocity_correlations``), the axis lines of a
scalar's two-point correlation (``streamed_two_point_lines``) and the
velocity-gradient statistics (``streamed_gradient_stats``). By the
in-core step's memory rule (``mesh.flash_uniform.streams_out_of_core``)
an 80 GB card runs 1024^3 float32 in core and streams from about 1152^3
up. Each result dict matches its in-core analysis: same keys, same math.

Stage A, one pass over x-slabs (host -> device by ``_slab_stream``): per
velocity component, w = sqrt(rho) * v (the flagship) or the raw field
(summary, correlations, lines) and its (y, z) transform
(``torch.fft.rfft2``), written into one of the complex64 zy buffers of
shape (nx, ny, nz/2+1), the dominant memory cost. On a uniform volume
every x row is one profile bin inside its slab, so the flagship's raw
and centered row moments (K5/K6 on ``slab[None]``) finish in the same
pass; the summary takes its real-space float64 sums per slab there.

x-transform: cuFFT along x, in place on each buffer one y-column chunk
at a time, so the extra memory peaks at one chunk. fava_tpu's dense-DFT
matmul over kx chunks and its planar re/im buffers exist for the TPU
(ROADMAP A12). The three transforms' ``norm="forward"`` together apply
the 1/(nx*ny*nz) of the in-core step.

Stage B, per kx chunk (``chunk_rows`` rows, a view of the buffers): the
flagship forms the power volumes with the global ``jx``/``kx`` (the
Nyquist split where a global row is nx/2) and bins them with B6 at
``kx0``, the counts being the static whole-volume shape function; the
summary adds the chunk's Hermitian spectral moments into a float64
vector; the correlations and lines add the chunk's float64 power
marginals (x, y and z plane sums) and take the k = 0 corner from the
same values, so that the mean removal cancels exactly.

The gradient statistics need no transform: one pass over halo slabs
(each loads its two periodic neighbour rows), central moments per slab
on the card in float64 and their exact Chan/Pebay combination on the
host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from fava_tpu_torch.io.ingest import DeviceCopier, prefetched
from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.gradients import (
    _DIV_PAIRS,
    _ROT_PAIRS,
    _gradient,
    _spacings,
    assemble_gradient_stats,
)
from fava_tpu_torch.ops.profiles import assemble_profile_stats
from fava_tpu_torch.ops.spectra import rfft_power_volumes
from fava_tpu_torch.ops.twopoint import _integral_scale, assemble_karman_howarth
from fava_tpu_torch.ops.velocity import GUARD, _abs2, _hermitian_weights, _k_grids, summary_names
from fava_tpu_torch.utils import accum_dtype, field_dtype, resolve_device

# field_slab(name, x0, x1) -> host array of shape (x1-x0, ny, nz), which
# may be a permuted view of its stored layout (io/flash_file.read_field_slab)
SlabLoader = Callable[[str, int, int], np.ndarray]

FIELDS = ("dens", "velx", "vely", "velz")


def _slab_stream(
    field_slab: SlabLoader,
    names,
    nx: int,
    slab_rows: int,
    device,
    *,
    depth: int = 2,
    wire_dtype=None,
):
    """Double-buffered slab iterator: yields ``(x0, [device slabs])`` in x
    order while ``depth`` background workers read the next slabs and copy
    them to the device under the current slab's compute (the design of
    ``io/ingest.DeviceCopier``: pinned staging, a side stream, an event
    the consumer's stream waits on).

    ``wire_dtype`` (e.g. ``torch.bfloat16``) casts on the host and widens
    on the device, at the cost of its rounding of the raw fields. The
    device holds ``depth + 1`` slab sets at most.
    """
    # depth <= 0 would prime an empty window; 1 still overlaps the next
    # read with the current compute.
    depth = max(1, int(depth))
    copier = DeviceCopier(device, wire_dtype, slots=depth + 1)
    starts = list(range(0, nx, slab_rows))

    def load(i: int):
        x0 = starts[i]
        tensors, event, _ = copier.put(i, [field_slab(n, x0, x0 + slab_rows) for n in names])
        return tensors, event

    # A consumer that raises (e.g. out of device memory mid-stage) or stops
    # early cancels the window: pending loads would keep copying slabs into
    # a full card and pin them through the caller's recovery.
    with contextlib.closing(prefetched(load, len(starts), depth)) as slabs:
        for x0, (tensors, event) in zip(starts, slabs):
            yield x0, copier.take(tensors, event)


def _zy_buffers(ncomp: int, shape: Tuple[int, int, int], device):
    """The complex (nx, ny, nz/2+1) zy-spectra buffers, one per component;
    stage A writes every x row of each."""
    nx, ny, nz = shape
    cdt = torch.complex64 if field_dtype(device) == torch.float32 else torch.complex128
    return [torch.empty((nx, ny, nz // 2 + 1), dtype=cdt, device=device) for _ in range(ncomp)]


def _check_divisible(nx: int, slab_rows: int, chunk_rows: int) -> None:
    if nx % slab_rows != 0 or nx % chunk_rows != 0:
        raise ValueError(
            f"slab_rows ({slab_rows}) and chunk_rows ({chunk_rows}) must divide "
            f"nx ({nx}); the mesh wrappers round to the nearest divisor"
        )


def _stage_a_moments(d, vx, vy, vz):
    """Raw (7, rows) and centered (9, rows) moments of a slab's x rows,
    each a whole profile bin (K5/K6 on a one-block stack)."""
    slabs = (d[None], vx[None], vy[None], vz[None])
    raw = cuda_kernels.block_row_moments(*slabs)
    means = (raw[1:4] / (d.shape[1] * d.shape[2])).contiguous()
    cen = cuda_kernels.block_centered_row_moments(*slabs, means)
    return raw[:, 0, :], cen[:, 0, :]


def _x_transform(buf: torch.Tensor, ycols: int) -> None:
    """Forward FFT along x (1/nx), in place, ``ycols`` y columns at a time."""
    ny = buf.shape[1]
    for y0 in range(0, ny, ycols):
        cols = buf[:, y0 : y0 + ycols]
        cols.copy_(torch.fft.fft(cols, dim=0, norm="forward"))


def _chunk_wavenumbers(kx0: int, rows: int, nx: int, device):
    jx = torch.arange(kx0, kx0 + rows, device=device)
    return jx, torch.where(jx <= (nx - 1) // 2, jx, jx - nx)


def streamed_uniform_analysis(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    device="cuda",
    wire_dtype=None,
    prefetch_depth: int = 2,
    stage_ms=None,
) -> Dict[str, np.ndarray]:
    """Spectra + Reynolds/Favre x-profiles, streamed from the host.

    Matches ``flagship.uniform_analysis_step``'s output dict for volumes
    that cannot be resident. ``slab_rows``/``chunk_rows`` must divide nx.
    Slabs are double-buffered (``prefetch_depth`` background read and
    copy workers); ``wire_dtype=torch.bfloat16`` halves the bytes copied.
    ``stage_ms``, a dict, receives the device milliseconds of stage A,
    the x-transform and stage B (CUDA events; on the CUDA device only).
    """
    dev = resolve_device(device)
    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, chunk_rows)
    nbins = max(nx, ny, nz) // 2 - 1
    timed = stage_ms is not None and dev.type == "cuda"
    if timed:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()

    # --- Stage A: per x-slab (y, z) transforms and row moments ---------
    bufs = _zy_buffers(3, (nx, ny, nz), dev)
    raws, cens = [], []
    for x0, (d, *vels) in _slab_stream(
        field_slab, FIELDS, nx, slab_rows, dev, depth=prefetch_depth, wire_dtype=wire_dtype
    ):
        sqrt_d = torch.sqrt(d)
        for buf, v in zip(bufs, vels):
            torch.fft.rfft2(sqrt_d * v, norm="forward", out=buf[x0 : x0 + slab_rows])
        del sqrt_d
        raw, cen = _stage_a_moments(d, *vels)
        raws.append(raw)
        cens.append(cen)
    raw = torch.cat(raws, dim=-1)  # (7, nx)
    cen = torch.cat(cens, dim=-1)  # (9, nx)
    if timed:
        events[1].record()

    # --- x-transform, in place, one y-column chunk at a time -----------
    ycols = max(1, ny * chunk_rows // nx)
    for buf in bufs:
        _x_transform(buf, ycols)
    if timed:
        events[2].record()

    # --- Stage B: per kx chunk, powers and the chunk binning (B6) ------
    sums = torch.zeros((3, nbins), dtype=accum_dtype(), device=dev)
    for kx0 in range(0, nx, chunk_rows):
        ws = [buf[kx0 : kx0 + chunk_rows] for buf in bufs]
        jx, kx = _chunk_wavenumbers(kx0, chunk_rows, nx, dev)
        total, longi = rfft_power_volumes(ws, (nx, ny, nz), jx=jx, kx=kx)
        sums += cuda_kernels.shell_bin_values_rfft_chunk(total, longi, nbins, nx, nz, kx0)
        del ws, total, longi
    counts = cuda_kernels.rfft_shell_counts((nx, ny, nz), nbins, dev)
    if timed:
        events[3].record()
    del bufs

    # --- The flagship output dict ---------------------------------------
    layer = float(ny * nz)
    d_row = raw[0]
    means = raw[1:4] / layer  # rows are the bins: slab means are bin means
    stress, favre_mean, favre_rms = assemble_profile_stats(d_row, means, cen[6:9], cen[:6], layer)
    out = {
        "spectra_counts": counts,
        "spectra_total": sums[0],
        "spectra_longitudinal": sums[1],
        "spectra_transverse": sums[2],
        "mean_dens": d_row / layer,
        "reynolds_stress": stress,
        "favre_mean": favre_mean,
        "favre_rms": favre_rms,
        "total_mass": d_row.sum(),
    }
    result = {k: v.cpu().numpy() for k, v in out.items()}
    if timed:
        stage_ms.update(
            {n: events[i].elapsed_time(events[i + 1])
             for i, n in enumerate(("stage_a", "x_transform", "stage_b"))}
        )
    return result


def _raw_zy_spectra(field_slab, names, transformed, shape, slab_rows, chunk_rows, dev, *,
                    depth, wire_dtype, on_slab=None):
    """Stage A on raw fields plus the x-transform: the whole-volume
    transforms (1/ntot, as ``_rfft(v) / ntot``) of the slabs at indices
    ``transformed`` of ``names``; ``on_slab(slabs)`` runs on every slab
    set as it arrives (real-space sums)."""
    nx, ny, _ = shape
    bufs = _zy_buffers(len(transformed), shape, dev)
    for x0, slabs in _slab_stream(field_slab, names, nx, slab_rows, dev, depth=depth,
                                  wire_dtype=wire_dtype):
        for buf, c in zip(bufs, transformed):
            torch.fft.rfft2(slabs[c], norm="forward", out=buf[x0 : x0 + slab_rows])
        if on_slab is not None:
            on_slab(slabs)
    ycols = max(1, ny * chunk_rows // nx)
    for buf in bufs:
        _x_transform(buf, ycols)
    return bufs


def _summary_slab_sums(d, vx, vy, vz, pres=None, gamma=None) -> torch.Tensor:
    """float64 real-space sums of one slab: [sum u^2, sum rho u^2, sum rho,
    sum log rho, sum (log rho)^2] (+ [sum M^2, max M^2, sum c_s] with
    ``pres``). The log-density moments are shift-invariant (sigma_s^2 =
    Var[log rho]; mean_s = E[log rho] - log E[rho]), so one pass suffices
    though s = log(rho/<rho>) refers to the global mean."""
    adt = accum_dtype()
    u2 = vx.to(adt).square() + vy.to(adt).square() + vz.to(adt).square()
    da = d.to(adt)
    ld = torch.log(da)
    acc = [u2.sum(), (da * u2).sum(), da.sum(), ld.sum(), ld.square().sum()]
    if pres is not None:
        cs2 = gamma.to(adt) * pres.to(adt) / da
        m2 = u2 / cs2
        acc += [m2.sum(), m2.max(), torch.sqrt(cs2).sum()]
    return torch.stack(acc)


def _summary_chunk_sums(ws, kx0: int, shape, lengths) -> torch.Tensor:
    """float64 [e_sum, mean_e, m_inv, m_2, comp_e, dil_sum, ens_sum] of one
    kx chunk of the three velocity spectra: the Hermitian sums of
    ``velocity._summary_vector`` (same k conventions, Nyquist-zeroed)."""
    adt = accum_dtype()
    rows = ws[0].shape[0]
    rdt, dev = ws[0].real.dtype, ws[0].device
    kxg, ky, kz = _k_grids(shape, rdt, dev, lengths, True)
    kx = kxg[kx0 : kx0 + rows]
    hw = _hermitian_weights(shape, adt, dev)
    k2 = kx * kx + ky * ky + kz * kz
    kmag = torch.sqrt(k2)
    e_mode = sum((0.5 * _abs2(w)).to(adt) for w in ws) * hw
    # the k = (0,0,0) mean-flow mode by grid INDEX (the zero-Nyquist
    # convention also zeroes k at the Nyquist indices)
    mean_e = e_mode[0, 0, 0] if kx0 == 0 else torch.zeros((), dtype=adt, device=dev)
    inv_k = torch.where(kmag > 0, 1.0 / torch.clamp(kmag, min=GUARD), 0.0).to(adt)
    k2a = k2.to(adt)
    m_inv = (e_mode * inv_k).sum()
    m_2 = (e_mode * k2a).sum()
    e_sum = e_mode.sum()
    del e_mode, inv_k, kmag
    div_amp2 = _abs2(kx * ws[0] + ky * ws[1] + kz * ws[2]).to(adt) / torch.clamp(k2a, min=GUARD)
    comp_e = (0.5 * div_amp2 * hw).sum()
    dil_sum = (div_amp2 * k2a * hw).sum()
    del div_amp2
    wx, wy, wz = ws
    ens = sum((_abs2(c).to(adt) * hw).sum()
              for c in (ky * wz - kz * wy, kz * wx - kx * wz, kx * wy - ky * wx))
    return torch.stack([e_sum, mean_e, m_inv, m_2, comp_e, dil_sum, ens])


def streamed_turbulence_summary(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    device="cuda",
    gamma=5.0 / 3.0,
    lengths=None,
    with_mach: bool = False,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, float]:
    """Out-of-core twin of ``ops/velocity.turbulence_summary`` (3D, with
    dens): raw-velocity zy buffers, the real-space sums per slab (float64
    vectors on the card, fetched once) and the Hermitian spectral moments
    kx chunk by kx chunk. ``with_mach`` also streams ``pres`` and ``gamc``
    for the Mach statistics; ``gamma`` is the ratio used when the loader
    raises KeyError for gamc (probed once, before the slab workers start).
    Keys and formulas are the in-core summary's."""
    dev = resolve_device(device)
    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, chunk_rows)
    ntot = nx * ny * nz
    adt = accum_dtype()
    names = FIELDS
    has_gamc = False
    if with_mach:
        names = names + ("pres",)
        try:  # probe ONCE: a probe inside the slab workers would race
            field_slab("gamc", 0, min(1, nx))
            has_gamc = True
            names = names + ("gamc",)
        except KeyError:
            pass
    g = torch.tensor(float(gamma), dtype=adt, device=dev) if with_mach and not has_gamc else None

    real_accs = []

    def on_slab(slabs):
        extra = [slabs[4], slabs[5] if has_gamc else g] if with_mach else []
        real_accs.append(_summary_slab_sums(*slabs[:4], *extra))

    bufs = _raw_zy_spectra(field_slab, names, (1, 2, 3), (nx, ny, nz), slab_rows, chunk_rows, dev,
                           depth=prefetch_depth, wire_dtype=wire_dtype, on_slab=on_slab)
    key = None if lengths is None else tuple(float(L) for L in lengths)
    acc = torch.zeros(7, dtype=adt, device=dev)
    for kx0 in range(0, nx, chunk_rows):
        acc += _summary_chunk_sums([b[kx0 : kx0 + chunk_rows] for b in bufs], kx0, (nx, ny, nz), key)
    del bufs
    packed = torch.cat([acc, torch.stack(real_accs).reshape(-1)]).cpu().numpy().astype(np.float64)
    e_sum, mean_e, m_inv, m_2, comp_e, dil_sum, ens_sum = packed[:7].tolist()
    per_slab = packed[7:].reshape(len(real_accs), -1)
    real = per_slab.sum(axis=0)

    # --- assemble (the formulas of velocity._summary_vector) -----------
    sum_u2, sum_du2, sum_d, sum_ld, sum_ld2 = real[:5]
    out = {
        "u_rms": float(np.sqrt(sum_u2 / ntot)),
        "kinetic_energy": float(0.5 * sum_u2 / ntot),
        "kinetic_energy_density": float(0.5 * sum_du2 / ntot),
    }
    mu_ld = sum_ld / ntot
    out["mean_s"] = float(mu_ld - np.log(sum_d / ntot))
    out["sigma_s"] = float(np.sqrt(max(sum_ld2 / ntot - mu_ld**2, 0.0)))
    if with_mach:
        out["mach_rms"] = float(np.sqrt(real[5] / ntot))
        out["mach_max"] = float(np.sqrt(per_slab[:, 6].max()))  # a max, not a sum
        out["sound_speed_mean"] = float(real[7] / ntot)
    e_fluct = e_sum - mean_e
    out["integral_scale"] = float((3.0 * np.pi / 4.0) * m_inv / max(e_fluct, 1e-30))
    out["taylor_scale"] = float(np.sqrt(5.0 * e_fluct / max(m_2, 1e-30)))
    out["compressive_fraction"] = float(comp_e / max(e_sum, 1e-30))
    out["solenoidal_fraction"] = 1.0 - out["compressive_fraction"]
    out["dilatation_rms"] = float(np.sqrt(dil_sum))
    out["vorticity_rms"] = float(np.sqrt(ens_sum))
    return {k: out[k] for k in summary_names(True, with_mach)}


def _corr_marginals(bufs, shape: Tuple[int, int, int], chunk_rows: int) -> torch.Tensor:
    """Per component, the float64 power marginals [x (nx), y (ny), z
    (nz/2+1)] and the k = 0 corner power, packed component-major on the
    card. The x and y marginals are Hermitian-weighted plane sums over
    signed kx/ky; the trailing-axis marginal stays half-layout (irfft
    applies the pair weights). The corner is the same float64 value the
    marginals hold, so its removal cancels exactly, even under a strong
    mean flow."""
    adt = accum_dtype()
    nx = shape[0]
    hw = _hermitian_weights(shape, adt, bufs[0].device)
    packed = []
    for buf in bufs:
        mx, my, mz, corner = [], None, None, None
        for kx0 in range(0, nx, chunk_rows):
            w = buf[kx0 : kx0 + chunk_rows]
            p = w.real.to(adt).square() + w.imag.to(adt).square()
            ph = p * hw
            mx.append(ph.sum(dim=(1, 2)))
            my = ph.sum(dim=(0, 2)) if my is None else my + ph.sum(dim=(0, 2))
            mz = p.sum(dim=(0, 1)) if mz is None else mz + p.sum(dim=(0, 1))
            if kx0 == 0:
                corner = p[0, 0, 0].reshape(1)  # hw is 1 there
            del p, ph
        packed += mx + [my, mz, corner]
    return torch.cat(packed)


def _axis_lines_from_marginals(marg, shape: Tuple[int, int, int]):
    """Host finalisation of one component's per-axis lines from its packed
    float64 marginals [x, y, z, corner]: subtract the k = 0 corner (each
    marginal counts it once), fold the SIGNED x and y axes to rfft layout
    (even part), inverse transform and scale. The port's transforms carry
    1/ntot, so the raw <u'(x) u'(x+r)> line is n times the irfft (fava_tpu:
    n/ntot^2 on unnormalised transforms). Returns [R_x, R_y, R_z]."""
    nx, ny, nz = shape
    marg_x = marg[:nx].copy()
    marg_y = marg[nx : nx + ny].copy()
    marg_z = marg[nx + ny : nx + ny + nz // 2 + 1].copy()
    corner = marg[-1]
    marg_x[0] -= corner
    marg_y[0] -= corner
    marg_z[0] -= corner

    def fold_signed(m, n):
        return (0.5 * (m + np.roll(m[::-1], 1)))[: n // 2 + 1]

    margs = (fold_signed(marg_x, nx), fold_signed(marg_y, ny), marg_z)
    return [np.fft.irfft(m, n=n)[: n // 2 + 1] * float(n) for m, n in zip(margs, (nx, ny, nz))]


def _streamed_lines(field_slab, names, shape, slab_rows, chunk_rows, dev, depth, wire_dtype):
    """[comp][axis] raw half lines of the fields ``names``."""
    bufs = _raw_zy_spectra(field_slab, names, tuple(range(len(names))), shape, slab_rows,
                           chunk_rows, dev, depth=depth, wire_dtype=wire_dtype)
    packed = _corr_marginals(bufs, shape, chunk_rows)
    del bufs
    per = packed.cpu().numpy().astype(np.float64).reshape(len(names), -1)
    return [_axis_lines_from_marginals(m, shape) for m in per]


def streamed_velocity_correlations(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    device="cuda",
    lengths=None,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, np.ndarray]:
    """Out-of-core twin of ``ops/twopoint.velocity_correlations`` (3D):
    raw-velocity zy buffers (dens is never read: the correlations are
    unweighted), then per kx chunk the float64 power marginals, whose 1D
    inverse transforms are the axis lines; no correlation volume and no
    inverse volume transform exists. The component means are removed by
    subtracting the k = 0 corner power of the same data."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    _check_divisible(shape[0], slab_rows, chunk_rows)
    lines = _streamed_lines(field_slab, ("velx", "vely", "velz"), shape, slab_rows, chunk_rows,
                            dev, prefetch_depth, wire_dtype)
    return assemble_karman_howarth(lines, shape, lengths)


def streamed_two_point_lines(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    field: str = "dens",
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    device="cuda",
    lengths=None,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, np.ndarray]:
    """Out-of-core axis-line two-point correlation of one scalar field:
    the line subset of ``ops/twopoint.two_point_correlation`` (``variance``,
    ``r_<ax>``, ``R_<ax>``, ``integral_scale_<ax>``), by the power
    marginals of ``streamed_velocity_correlations``. The shell curve
    R(|r|) needs the full correlation volume, which streaming avoids, and
    is not produced."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    _check_divisible(shape[0], slab_rows, chunk_rows)
    (lines,) = _streamed_lines(field_slab, (field,), shape, slab_rows, chunk_rows, dev,
                               prefetch_depth, wire_dtype)
    ls = tuple(float(L) for L in lengths) if lengths is not None else (1.0,) * 3
    var = float(lines[0][0])
    scale = var if var > 0 else 1.0
    out: Dict[str, np.ndarray] = {"variance": var}
    for a, (line, n, ax) in enumerate(zip(lines, shape, "xyz")):
        dx = ls[a] / n
        out[f"r_{ax}"] = np.arange(line.size, dtype=np.float64) * dx
        out[f"R_{ax}"] = line / scale
        out[f"integral_scale_{ax}"] = _integral_scale(line, dx)
    return out


# --- streamed velocity-gradient statistics ------------------------------


def _gradient_slab_stats(vels_e, spacings) -> torch.Tensor:
    """Slab-local gradient statistics of halo-extended x-slabs ((rows + 2,
    ny, nz), one periodic neighbour row on each side): per g_ij its mean
    and the sums of its centred 2nd-4th powers, the rotation and
    divergence cross sums, and per component its mean and centred sum of
    squares, float64. The x differences are the interior central
    differences of the extended slab; y and z wrap inside the rows, as the
    in-core ``gradients._gradient`` (the same float32 operations)."""
    adt = accum_dtype()

    def grad(i, j):
        u = vels_e[i]
        if j == 0:
            return ((u[2:] - u[:-2]) / (2.0 * spacings[0])).to(adt)
        return _gradient(u[1:-1], j, spacings[j], False).to(adt)

    fl, means = {}, {}
    for i in range(3):
        for j in range(3):
            g = grad(i, j)
            means[(i, j)] = g.mean()
            fl[(i, j)] = g.sub_(means[(i, j)])
    acc = []
    for i in range(3):
        for j in range(3):
            f = fl[(i, j)]
            f2 = f * f
            acc += [means[(i, j)], f2.sum(), (f2 * f).sum(), (f2 * f2).sum()]
            del f2
    acc += [(fl[(a, b)] * fl[(b, a)]).sum() for a, b in _ROT_PAIRS[3]]
    acc += [(fl[(i, i)] * fl[(j, j)]).sum() for i, j in _DIV_PAIRS[3]]
    del fl
    for c in range(3):
        u = vels_e[c][1:-1].to(adt)
        um = u.mean()
        acc += [um, (u - um).square().sum()]
    return torch.stack(acc)


def _chan_combine(n_a, stats_a, n_b, stats_b):
    """Exact pairwise combination of (mean, S2, S3, S4) partition statistics
    (Chan et al. 1979 / Pebay 2008), vectorised over entries; S_p = sum
    (x - mean)^p over the partition."""
    mA, M2A, M3A, M4A = stats_a
    mB, M2B, M3B, M4B = stats_b
    n = n_a + n_b
    d = mB - mA
    mean = mA + d * (n_b / n)
    M2 = M2A + M2B + d**2 * (n_a * n_b / n)
    M3 = (
        M3A
        + M3B
        + d**3 * (n_a * n_b * (n_a - n_b) / n**2)
        + 3.0 * d * (n_a * M2B - n_b * M2A) / n
    )
    M4 = (
        M4A
        + M4B
        + d**4 * (n_a * n_b * (n_a**2 - n_a * n_b + n_b**2) / n**3)
        + 6.0 * d**2 * (n_a**2 * M2B + n_b**2 * M2A) / n**2
        + 4.0 * d * (n_a * M3B - n_b * M3A) / n
    )
    return mean, M2, M3, M4


def _combine_gradient_slabs(per_slab: np.ndarray, n_slab: float) -> np.ndarray:
    """Exact float64 combination of the slabs' statistics into the in-core
    packed layout of central-moment MEANS (``gradients.packed_names``)."""
    rot_pairs, div_pairs = _ROT_PAIRS[3], _DIV_PAIRS[3]
    n_g, n_rot, n_div = 36, len(rot_pairs), len(div_pairs)  # 9 x [mean, S2, S3, S4]
    state = None  # (n, means(9,), M2, M3, M4, rot(3,), div(3,), u_mean(3,), u_M2(3,))
    for row in per_slab:
        g = row[:n_g].reshape(9, 4)
        rot = row[n_g : n_g + n_rot]
        div = row[n_g + n_rot : n_g + n_rot + n_div]
        u = row[n_g + n_rot + n_div :].reshape(3, 2)
        b = (n_slab, g[:, 0], g[:, 1], g[:, 2], g[:, 3], rot, div, u[:, 0], u[:, 1])
        if state is None:
            state = b
            continue
        nA, nB = state[0], n_slab
        n = nA + nB
        mean, M2, M3, M4 = _chan_combine(nA, state[1:5], nB, b[1:5])

        # covariance: C = CA + CB + dx dy nA nB / n, dx and dy the mean
        # gaps of the two constituent gradients
        def gap(i, j):
            return b[1][i * 3 + j] - state[1][i * 3 + j]

        rot_c = np.array([state[5][p] + b[5][p] + gap(a, bb) * gap(bb, a) * nA * nB / n
                          for p, (a, bb) in enumerate(rot_pairs)])
        div_c = np.array([state[6][p] + b[6][p] + gap(i, i) * gap(j, j) * nA * nB / n
                          for p, (i, j) in enumerate(div_pairs)])
        du = b[7] - state[7]
        u_mean = state[7] + du * (nB / n)
        u_M2 = state[8] + b[8] + du**2 * (nA * nB / n)
        state = (n, mean, M2, M3, M4, rot_c, div_c, u_mean, u_M2)

    ntot, mean, M2, M3, M4, rot_c, div_c, u_mean, u_M2 = state
    packed = []
    for k in range(9):
        packed += [mean[k], M2[k] / ntot, M3[k] / ntot, M4[k] / ntot]
    packed += list(rot_c / ntot) + list(div_c / ntot)
    for c in range(3):
        packed += [u_mean[c], u_M2[c] / ntot]
    return np.asarray(packed)


def streamed_gradient_stats(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    device="cuda",
    lengths=None,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, "np.ndarray | float"]:
    """Out-of-core twin of ``ops/gradients.velocity_gradient_statistics``
    (3D, periodic): one pass over halo-extended x-slabs (each slab loads
    its two periodic neighbour rows, so the x differences need no state
    across slabs); per-slab central moments on the card, their exact
    float64 Chan/Pebay combination on the host. Same report as the
    in-core analysis."""
    dev = resolve_device(device)
    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, slab_rows)
    key = None if lengths is None else tuple(float(L) for L in lengths)
    spacings = _spacings((nx, ny, nz), key)

    def halo_loader(name: str, x0: int, x1: int) -> np.ndarray:
        lo = np.asarray(field_slab(name, (x0 - 1) % nx, (x0 - 1) % nx + 1))
        mid = np.asarray(field_slab(name, x0, x1))
        hi = np.asarray(field_slab(name, x1 % nx, x1 % nx + 1))
        return np.concatenate([lo, mid, hi], axis=0)

    accs = [
        _gradient_slab_stats(slabs, spacings)
        for _x0, slabs in _slab_stream(halo_loader, ("velx", "vely", "velz"), nx, slab_rows, dev,
                                       depth=prefetch_depth, wire_dtype=wire_dtype)
    ]
    per_slab = torch.stack(accs).cpu().numpy().astype(np.float64)  # one fetch
    return assemble_gradient_stats(_combine_gradient_slabs(per_slab, float(slab_rows * ny * nz)), 3)
