"""Flagship analysis step: kinetic-energy spectra plus Reynolds-stress
and Favre x-profiles of one uniform snapshot.

Counterpart of fava_tpu/flagship.py. PyTorch runs eagerly, so the step
is a sequence of cuFFT transforms, plain tensor ops and the hand-written
kernels of ``ops/cuda_kernels.py``: K1 and K2 for the profiles, and B9,
which forms the powers, folds and shell-bins them in one pass over the
transforms (for odd x or y extents, the power volumes and the unfolded
binning B10); ``series_analysis_step`` is a Python loop over snapshots
where fava_tpu used ``lax.scan``.

With a device mesh (``parallel/``) the inputs are the rank's x-slabs:
the spectra come from the pencil transform and B6 on each rank's
y-slab (``ops/spectra.sharded_power_spectra``), and the profiles from
K1 and K2 on the local x-slab, whose rows are whole on the rank, then
one all_gather of the row statistics on the space group
(``ops/profiles.uniform_row_stats``, which the sharded profiles share). ``sharded_series_analysis_step``
runs that step over the rank's snapshots of a snap x space batch; the
series driver that collects them over the snap axis is ROADMAP A11c.

Outputs are float64 on every device (fava_tpu's are float32 on the TPU).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from fava_tpu_torch.ops.profiles import assemble_profile_stats, uniform_row_stats
from fava_tpu_torch.ops.spectra import rfft_shell_sums, sharded_power_spectra
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import field_dtype, resolve_device
from fava_tpu_torch.utils.profiling import SPAN_PROFILES, annotate


def uniform_analysis_step(dens, velx, vely, velz, mesh=None) -> Dict[str, torch.Tensor]:
    """Spectra + Reynolds/Favre x-profiles of one uniform snapshot; with
    ``mesh``, of the volume whose x-slabs on the mesh's space axis the
    inputs are (every rank gets the whole volume's outputs)."""
    nx, ny, nz = (int(s) for s in dens.shape)
    if mesh is not None:
        nx *= runtime.space_axis_size(mesh)
    nbins = max(nx, ny, nz) // 2 - 1
    vels = (velx, vely, velz)

    # --- Spectra: real input, so rfft halves the transform and binning
    # work; Hermitian weights in the binning make the result equal to the
    # full-grid computation.
    if mesh is None:
        counts, sums3 = rfft_shell_sums(dens, vels, nbins)
    else:
        counts, sums3 = sharded_power_spectra(dens, vels, mesh, nbins)

    # --- Profiles along x (uniform grid: rows are the bins). Two passes:
    # raw first moments, then second moments centered on the row means,
    # which avoids the cancellation of the one-pass expansion. Under a
    # mesh every row is whole on one rank, so both passes are local.
    layer = float(ny * nz)
    with annotate(SPAN_PROFILES):
        moments, centered = uniform_row_stats(
            [(dens, *vels)], None if mesh is None else runtime.SpaceRanks(mesh))
        d_row = moments[0]
        means = moments[1:4] / layer
        stress, favre_mean, favre_rms = assemble_profile_stats(
            d_row, means, centered[6:9], centered[:6], layer
        )
        mean_dens = d_row / layer
        # Row sums already hold every cell once: the total mass without
        # another pass over the density volume.
        total_mass = d_row.sum()

    return {
        "spectra_counts": counts,
        "spectra_total": sums3[0],
        "spectra_longitudinal": sums3[1],
        "spectra_transverse": sums3[2],
        "mean_dens": mean_dens,
        "reynolds_stress": stress,
        "favre_mean": favre_mean,
        "favre_rms": favre_rms,
        "total_mass": total_mass,
    }


def series_analysis_step(dens, velx, vely, velz) -> Dict[str, torch.Tensor]:
    """Flagship step over a leading snapshot axis; outputs gain a
    leading snapshot axis. The working set stays one snapshot wide
    (inputs aside)."""
    outs = [uniform_analysis_step(*snap) for snap in zip(dens, velx, vely, velz)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def sharded_series_analysis_step(dens, velx, vely, velz, mesh) -> Dict[str, torch.Tensor]:
    """Flagship step over the rank's share of a snapshot batch on a snap
    x space mesh (fava_tpu/flagship.py:197).

    The inputs are this rank's (B/snap, nx/space, ny, nz) block of a (B,
    nx, ny, nz) batch: its snap row's snapshots, each as its x-slab on
    the space axis. Each snapshot runs ``uniform_analysis_step`` with the
    mesh (collectives on the space group only: snap rows never talk).
    Returns the local snapshots' outputs with a leading snapshot axis.
    """
    outs = [uniform_analysis_step(*snap, mesh=mesh) for snap in zip(dens, velx, vely, velz)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _synth_fields(n: int, dtype, device, s: float, out=None):
    """Deterministic multi-frequency trig fields (no RNG), the same
    formula as fava_tpu/flagship.py:306-325, written into ``out`` when
    given so a batch is built without per-snapshot copies."""
    ax = torch.arange(n, dtype=dtype, device=device) / n
    x, y, z = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    two_pi = 2.0 * math.pi

    def mix(a, b, c, p):
        return (
            torch.sin(two_pi * (a * x + b * y + c * z) + p + s)
            + 0.5 * torch.cos(two_pi * (b * x + c * y + a * z) + 2 * p + s)
            + 0.25 * torch.sin(two_pi * (c * x + a * y + b * z) + 3 * p - s)
        )

    makers = (
        lambda: 1.3 + 0.3 * torch.cos(two_pi * (x + 2 * y - z) + s) * torch.sin(two_pi * (3 * x - y) - s),
        lambda: mix(3, 7, 2, 0.3),
        lambda: mix(5, 1, 6, 1.1),
        lambda: mix(2, 4, 9, 2.7),
    )
    if out is None:
        return tuple(make() for make in makers)
    for dst, make in zip(out, makers):
        dst.copy_(make())
    return out


def make_example_fields(n: int = 64, seed: int = 0, device="cuda"):
    """Deterministic synthetic turbulence-like fields ``(dens, velx,
    vely, velz)``, each (n, n, n), built on ``device`` in its field
    dtype."""
    dev = resolve_device(device)
    return _synth_fields(int(n), field_dtype(dev), dev, float(seed))


def make_example_field_batch(nsnap: int, n: int = 64, device="cuda"):
    """Stacked example snapshots ``(dens, velx, vely, velz)``, each
    (nsnap, n, n, n), synthesized directly into the batch buffers.
    Snapshot ``i`` equals ``make_example_fields(n, seed=i)``."""
    dev = resolve_device(device)
    dtype = field_dtype(dev)
    batch = tuple(torch.empty((nsnap, n, n, n), dtype=dtype, device=dev) for _ in range(4))
    for i in range(nsnap):
        _synth_fields(int(n), dtype, dev, float(i), out=[b[i] for b in batch])
    return batch
