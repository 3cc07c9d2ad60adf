"""Space-time cross correlation (Naka et al. 2015;
fava_tpu/analysis/cross_correlation.py).

Correlates a set of sample particles' spatial field at time t with one
point-of-interest particle's temporal field at t+dt over the
``[ibeg, iend)`` window of a particle-file series, centred on the
window's middle file (Lagrangian tracking mode). Host numpy in float64,
as in fava_tpu.
"""

from __future__ import annotations

from math import floor
from typing import List, Optional

import numpy as np

from fava_tpu_torch.analysis._catalogs import particle_series_indices
from fava_tpu_torch.mesh.flash_particles import rows_for_tags
from fava_tpu_torch.models.model import Model


@Model.register_analysis(use_timer=True)
def cross_correlation(
    self,
    spatial_field: str,
    temporal_field: str,
    sample_points: np.ndarray,
    poi_idx: int,
    *args,
    **kwargs,
) -> Optional[np.ndarray]:
    tvar = temporal_field
    svar = spatial_field
    fields: List[str] = [svar, tvar]

    file_type = kwargs.setdefault("file_type", "prt")
    indices = particle_series_indices(self, file_type)
    nfiles = len(indices)
    sample_points = np.asarray(sample_points)
    npts = sample_points.size

    ibeg = int(kwargs.pop("ibeg", 0))
    iend = int(kwargs.pop("iend", nfiles))
    if not (0 <= ibeg < iend <= nfiles):
        raise ValueError(
            f"invalid series window [ibeg={ibeg}, iend={iend}) over {nfiles} particle files"
        )
    nwin = iend - ibeg
    if nwin < 2:
        raise ValueError("cross correlation needs at least 2 snapshots in the window")
    imid = ibeg + floor(nwin / 2)

    lagrangian_tracking = kwargs.pop("lagrangian_tracking", None)
    if lagrangian_tracking is None:
        return None

    tagvar = kwargs.pop("tag_field", None)
    if tagvar is None:
        raise ValueError(
            "Lagrangian particle tracking selected but no name given for the particle ID tag field"
        )

    samp_data = np.zeros((nwin, npts), dtype=float)
    temp_data = np.zeros((nwin, 1), dtype=float)

    def grab(i: int):
        # The tag column is always loaded and every file's rows are
        # resolved from its own tag column: the table order is not
        # stable across snapshots, and the loader sorts only by a column
        # literally named "tag".
        self.load(file_index=i, fields=[*fields, tagvar], *args, **kwargs)
        return np.asarray(self.particles.data.get(tagvar))

    wanted = np.concatenate(([poi_idx], sample_points.ravel()))

    # The midpoint first, then the rest of the window; only files inside
    # [ibeg, iend) are loaded.
    for p in (imid, *(j for j in range(ibeg, iend) if j != imid)):
        rows = rows_for_tags(grab(indices[p]), wanted, label=tagvar)
        temp_data[p - ibeg] = self.particles.data[tvar][rows[0]]
        samp_data[p - ibeg, :] = self.particles.data[svar][rows[1:]]

    smean = samp_data[:-1, ...].mean(axis=0)
    tmean = temp_data[1:].mean()
    sstd = samp_data[:-1, ...].std(axis=0)
    tstd = temp_data[1:].std()

    Rts = np.sum(temp_data[1:] * samp_data[:-1, :], axis=0) / float(nwin - 1)
    Kts = Rts - smean * tmean
    rho = Kts / (sstd * tstd)
    return rho
