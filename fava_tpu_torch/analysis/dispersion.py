"""Lagrangian dispersion statistics over a tracer-particle series
(fava_tpu/analysis/dispersion.py).

* Single-particle (Taylor) dispersion <|x_i(t) - x_i(0)|^2> over every
  tag present at t = 0.
* Pair (Richardson) dispersion <|d_ij(t)|^2> over ``npairs`` seeded
  anchor particles, each paired with its nearest neighbour at t = 0.

Particles are tracked by tag (``rows_for_tags``, a hard error on a
missing tag); displacements are raw coordinate differences (no periodic
unwrapping). The per-snapshot sums are host numpy, as in fava_tpu.

The nearest-neighbour search is one float64 sweep on the device at
every problem size: per chunk of anchors, difference-form squared
distances sum((a - b)^2) and ``argmin``. That is exact to float64, so it
needs no candidate list and no host re-decision. The difference form
matters: the matmul identity |a|^2 + |b|^2 - 2 a.b cancels for close
pairs and picks wrong partners in clustered tracers. ``_nn_host`` is
fava_tpu's float64 numpy brute force, kept as the plain twin the tests
hold the sweep to.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.analysis._catalogs import particle_series_indices
from fava_tpu_torch.mesh.flash_particles import rows_for_tags
from fava_tpu_torch.models.model import Model

_POS_FIELDS = ("posx", "posy", "posz")

_NN_CHUNK = 256
# float64 elements of one (anchors, particles) distance block of the sweep.
_NN_BLOCK_ELEMENTS = 1 << 25


def _nn_host(coords: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Chunked O(A*N) numpy brute force in float64 (matmul identity)."""
    sq = (coords**2).sum(axis=1)
    partners = np.empty(anchors.size, dtype=np.int64)
    for s in range(0, anchors.size, _NN_CHUNK):
        a = anchors[s : s + _NN_CHUNK]
        d2 = sq[a, None] + sq[None, :] - 2.0 * coords[a] @ coords.T
        d2[np.arange(a.size), a] = np.inf  # exclude self
        partners[s : s + _NN_CHUNK] = np.argmin(d2, axis=1)
    return partners


def nn_sweep(coords: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Index of each anchor's nearest other particle: ``coords`` an (ndim,
    N) float64 tensor, ``anchors`` int64 rows, both on one device.

    Per chunk of anchors, d2 = sum over axes of (c - a)^2 in float64
    (difference form), self excluded, then ``argmin`` (the first index
    of a tie, as numpy's)."""
    ndim, n = coords.shape
    chunk = max(1, _NN_BLOCK_ELEMENTS // max(n, 1))
    out = torch.empty(anchors.numel(), dtype=torch.int64, device=coords.device)
    for s in range(0, anchors.numel(), chunk):
        a = anchors[s : s + chunk]
        d2 = torch.sub(coords[0][None, :], coords[0, a][:, None]).square_()
        for ax in range(1, ndim):
            d2.add_(torch.sub(coords[ax][None, :], coords[ax, a][:, None]).square_())
        d2[torch.arange(a.numel(), device=coords.device), a] = float("inf")
        out[s : s + chunk] = torch.argmin(d2, dim=1)
    return out


def _nearest_neighbor_pairs(coords: np.ndarray, anchors: np.ndarray, device) -> np.ndarray:
    """``nn_sweep`` of host (N, ndim) coordinates on ``device``."""
    c = torch.as_tensor(np.ascontiguousarray(coords.T, dtype=np.float64), device=device)
    a = torch.as_tensor(np.asarray(anchors, dtype=np.int64), device=device)
    return nn_sweep(c, a).cpu().numpy()


@Model.register_analysis(use_timer=True)
def dispersion_statistics(
    self,
    npairs: int = 256,
    seed: int = 0,
    file_indices: Optional[Sequence[int]] = None,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Taylor single-particle + Richardson pair dispersion vs time.

    Returns {"time", "single_msd", "pair_msd",
    "initial_pair_separation_sq", "npairs"}; ``single_msd`` averages
    over every tag present at t = 0 (hard error if one later
    disappears), ``pair_msd`` over the nearest-neighbour pairs.
    """
    file_type = kwargs.setdefault("file_type", "prt")
    indices = particle_series_indices(self, file_type, file_indices)
    if len(indices) < 2:
        raise ValueError("dispersion statistics need at least 2 particle snapshots")

    load_fields = [*_POS_FIELDS, "tag"]
    self.load(file_index=indices[0], fields=load_fields, **kwargs)
    if self.particles is None:
        raise RuntimeError("dispersion statistics require Lagrangian particles")
    ndim = min(self.particles.ndim or 3, 3)
    pos_fields = _POS_FIELDS[:ndim]

    def coords_and_tags():
        p = self.particles.data
        return np.stack([np.asarray(p[f], dtype=np.float64) for f in pos_fields], axis=1), np.asarray(
            p["tag"]
        )

    x0, tags0 = coords_and_tags()
    nparticles = x0.shape[0]
    npairs_eff = min(int(npairs), nparticles)
    rng = np.random.default_rng(seed)
    anchors = rng.choice(nparticles, size=npairs_eff, replace=False)
    partners = _nearest_neighbor_pairs(x0, anchors, self.particles.device)

    delta0 = x0[anchors] - x0[partners]
    out: Dict[str, np.ndarray] = {
        "time": np.zeros(len(indices)),
        "single_msd": np.zeros(len(indices)),
        "pair_msd": np.zeros(len(indices)),
        "initial_pair_separation_sq": float((delta0**2).sum(axis=1).mean()),
        "npairs": npairs_eff,
    }

    for j, i in enumerate(indices):
        if j > 0:
            self.load(file_index=i, fields=load_fields, **kwargs)
        x, tags = coords_and_tags()
        rows = rows_for_tags(tags, tags0, label="tag")
        xt = x[rows]  # aligned with the t = 0 tag order
        out["time"][j] = self.particles.time
        out["single_msd"][j] = (((xt - x0) ** 2).sum(axis=1)).mean()
        delta = xt[anchors] - xt[partners]
        out["pair_msd"][j] = ((delta**2).sum(axis=1)).mean()
    return out
