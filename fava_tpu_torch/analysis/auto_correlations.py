"""Eulerian and Lagrangian autocorrelation time series
(fava_tpu/analysis/auto_correlations.py).

Eulerian: fixed sample points (random finest-grid cell centres) sampled
across a mesh series through the mesh's ``sample_fields`` (the gather on
the device, the point lookup on the host). Lagrangian: the particle
tables of a part-file series, matched by tag. The correlation sums are
host numpy in float64, as in fava_tpu.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence, Tuple

import numpy as np

from fava_tpu_torch.analysis._catalogs import mesh_series_paths, particle_series_indices
from fava_tpu_torch.models.model import Model

LOGGER = logging.getLogger(__name__)


def _sample_grid_points(mesh, nsamples: int, rng: np.random.Generator) -> np.ndarray:
    """Random finest-grid cell centres, drawn from ``rng`` axis by axis."""
    lref_cells = 2 ** (mesh.refine_level_max - 1)
    dims = [
        int(nb * bl * lref_cells)
        for nb, bl in zip(mesh.nCellsVec[: mesh.ndim], mesh.nBlksVec[: mesh.ndim])
    ]
    dom = mesh.domain_bounds
    points = np.empty((nsamples, mesh.ndim), dtype=np.float64)
    for nd in range(mesh.ndim):
        delta = (dom[nd, 1] - dom[nd, 0]) / float(dims[nd] + 1)
        ipnts = rng.integers(low=0, high=dims[nd], size=nsamples)
        points[:, nd] = np.linspace(dom[nd, 0] + 0.5 * delta, dom[nd, 1] - 0.5 * delta, dims[nd])[ipnts]
    return points


@Model.register_analysis(use_timer=True)
def eulerian_autocorrelation(
    self, nsamples: int, fields: Sequence[str], seed: int = 0, *args, **kwargs
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    if "file_type" not in kwargs:
        kwargs["file_type"] = "plt"

    indices, _ = mesh_series_paths(self, kwargs["file_type"])
    nfiles = len(indices)
    time_seps = np.zeros(nfiles, dtype=float)
    results: Dict[str, np.ndarray] = {field: np.zeros(nfiles, dtype=float) for field in fields}

    self.load(file_index=indices[0], fields=list(fields), *args, **kwargs)
    if self.mesh is None:
        msg = "Eulerian autocorrelation requires an Eulerian mesh!"
        if self.particles is not None:
            msg += " Particles were loaded, possibly by mistake; Lagrangian autocorrelation uses particles."
        raise RuntimeError(msg)

    rng = np.random.default_rng(seed)
    points = _sample_grid_points(self.mesh, nsamples, rng)

    init_data: Dict[str, np.ndarray] = {}
    init_sum: Dict[str, float] = {}

    for i, idx in enumerate(indices):
        try:
            self.load(file_index=idx, fields=list(fields), *args, **kwargs)
        except Exception:
            # A corrupt or mid-write file in the series: warn and mark its
            # slot NaN. An in-band (t=0, corr=0) sample would corrupt
            # decay fits downstream.
            LOGGER.warning("eulerian_autocorrelation: skipping bad file index=%d", idx, exc_info=True)
            time_seps[i] = np.nan
            for field in fields:
                results[field][i] = np.nan
            continue
        time_seps[i] = self.mesh.time

        values, vol_frac, _found = self.mesh.sample_fields(points, fields)
        current = {field: values[field] * vol_frac for field in fields}

        if not init_data:
            # The reference point is the first readable file.
            init_data = {field: current[field].copy() for field in fields}
            init_sum = {field: float(np.sqrt(np.sum(v**2))) for field, v in init_data.items()}

        for field in fields:
            results[field][i] += np.sum(init_data[field] * current[field]) / (
                init_sum[field] * np.sqrt(np.sum(current[field] ** 2))
            )

    return time_seps, results


@Model.register_analysis(use_timer=True)
def lagrangian_autocorrelation(
    self, nsamples: int, fields: Sequence[str], *args, **kwargs
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    if "file_type" not in kwargs:
        kwargs["file_type"] = "prt"

    indices = particle_series_indices(self, kwargs["file_type"])
    nfiles = len(indices)
    time_seps = np.zeros(nfiles, dtype=float)
    results: Dict[str, np.ndarray] = {field: np.zeros(nfiles, dtype=float) for field in fields}

    # The tag column is always loaded: the loader sorts rows by tag only
    # when it is present, and the table order of FLASH snapshots is not
    # stable (particles migrate between ranks).
    load_fields = list(dict.fromkeys([*fields, "tag"]))

    self.load(file_index=indices[0], fields=load_fields, *args, **kwargs)
    if self.particles is None:
        msg = "Lagrangian autocorrelation requires Lagrangian Particles!"
        if self.mesh is not None:
            msg += " Only a mesh was loaded, possibly by mistake; Eulerian autocorrelation uses a mesh."
        raise RuntimeError(msg)

    init_data: Dict[str, np.ndarray] = {}
    init_sum: Dict[str, float] = {}

    for i, idx in enumerate(indices):
        self.load(file_index=idx, fields=load_fields, *args, **kwargs)

        if i == 0:
            init_data = {field: np.copy(self.particles.data[field]) for field in fields}
            init_sum = {field: float(np.sqrt(np.sum(v**2))) for field, v in init_data.items()}

        time_seps[i] = self.particles.time

        for field in fields:
            cur = self.particles.data[field]
            results[field][i] += np.sum(init_data[field] * cur) / (
                init_sum[field] * np.sqrt(np.sum(cur**2))
            )

    return time_seps, results
