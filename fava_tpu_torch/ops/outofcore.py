"""Out-of-core flagship analysis for volumes beyond the card's memory.

Counterpart of fava_tpu/ops/outofcore.py (the flagship driver; the
streamed summary, correlations, two-point lines and gradient statistics
are ROADMAP A8). By the in-core step's memory rule
(``mesh.flash_uniform.streams_out_of_core``) an 80 GB card runs 1024^3
float32 in core and streams from about 1152^3 up. The result dict
matches ``flagship.uniform_analysis_step``'s: same keys, same math.

Stage A, one pass over x-slabs (host -> device by ``_slab_stream``): per
velocity component, w = sqrt(rho) * v and its (y, z) transform
(``torch.fft.rfft2``), written into one of three complex64 zy buffers
of shape (nx, ny, nz/2+1), the dominant memory cost. On a uniform
volume every x row is one profile bin inside its slab, so the slab's
raw and centered row moments (K5/K6 on ``slab[None]``) finish in the
same pass.

x-transform: cuFFT along x, in place on each buffer one y-column chunk
at a time, so the extra memory peaks at one chunk. fava_tpu's dense-DFT
matmul over kx chunks and its planar re/im buffers exist for the TPU
(ROADMAP A12). The three transforms' ``norm="forward"`` together apply
the 1/(nx*ny*nz) of the in-core step.

Stage B, per kx chunk (``chunk_rows`` rows, a view of the buffers): the
power volumes with the global ``jx``/``kx`` (the Nyquist split where a
global row is nx/2), then the chunk shell binning B6 with ``kx0``; the
counts are the static whole-volume shape function.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from fava_tpu_torch.io.ingest import DeviceCopier, prefetched
from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.ops.profiles import assemble_profile_stats
from fava_tpu_torch.ops.spectra import rfft_power_volumes
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
