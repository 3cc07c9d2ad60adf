"""Reynolds-stress and Favre profile assembly (counterpart of
fava_tpu/ops/profiles.py:531-561)."""

from __future__ import annotations

from typing import Tuple

import torch

# Velocity-pair order shared by every profile consumer: xx,xy,xz,yy,yz,zz.
VEL_PAIRS: Tuple[Tuple[int, int], ...] = tuple((i, j) for i in range(3) for j in range(i, 3))
_DIAG = tuple(VEL_PAIRS.index((i, i)) for i in range(3))


def assemble_profile_stats(d_row, means, c1, cov, layer):
    """Reynolds stress + Favre mean/RMS from centered per-bin moments.

    Inputs are stacked rows: d_row (nx,), means (3, nx) volume-mean
    velocities, c1 (3, nx) = sum(d*(v-mu)), cov (6, nx) = sum(d*ci*cj)
    in VEL_PAIRS order, layer = cells/bin.

    favre_mean = mu + c1/sum(d); the RMS variance is the centered
    covariance shifted to the Favre mean. A vacuum bin (sum(d) == 0)
    has c1 == cov == 0, so dividing by the guarded 1 yields
    favre_mean == means and rms == 0 instead of NaN.
    """
    stress = cov / layer
    safe_d = torch.where(d_row > 0, d_row, torch.ones_like(d_row))
    favre_mean = means + c1 / safe_d
    di = favre_mean - means
    diag_cov = cov[list(_DIAG)]
    var = (diag_cov - 2.0 * di * c1 + di * di * d_row) / safe_d
    favre_rms = torch.sqrt(torch.clamp(var, min=0.0))
    return stress, favre_mean, favre_rms
