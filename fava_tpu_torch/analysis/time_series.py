"""Multi-snapshot time-series drivers on the async ingest.

Counterpart of fava_tpu/analysis/time_series.py, single device: the
flagship, Reynolds-stress and Favre series. ``io/ingest.SnapshotPrefetcher``
overlaps the read and the copy to the card of snapshot N+1 with the
compute on snapshot N. The pod branch of ``flagship_series`` is ROADMAP
A11; the summary, gradient and particle series wait for their analyses
(A8, A9).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.analysis._catalogs import mesh_series_paths
from fava_tpu_torch.io.ingest import Snapshot, SnapshotPrefetcher
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.ops import profiles as profile_ops

logger = logging.getLogger(__name__)

FIELDS = ["dens", "velx", "vely", "velz"]


def _geometry_from_snapshot(snap: Snapshot, raxis: int) -> profile_ops.ProfileGeometry:
    ints = snap.scalars["integer"]
    rints = snap.runtime_parameters["integer"]
    reals = snap.runtime_parameters["real"]
    node_type = snap.metadata.get("node type", np.ones(1, dtype=np.int64))
    refine_level = snap.metadata.get("refine level", np.ones(1, dtype=np.int64))
    return profile_ops.ProfileGeometry(
        block_bounds=snap.metadata["bounding box"],
        refine_level=np.asarray(refine_level),
        blocklist=np.nonzero(np.asarray(node_type) == 1)[0],
        domain_bounds=np.array(
            [
                [reals.get("xmin", 0.0), reals.get("xmax", 1.0)],
                [reals.get("ymin", 0.0), reals.get("ymax", 1.0)],
                [reals.get("zmin", 0.0), reals.get("zmax", 1.0)],
            ],
            dtype=np.float64,
        ),
        ncells_vec=np.array([ints["nxb"], ints["nyb"], ints["nzb"]], dtype=np.int64),
        nblks_vec=np.array(
            [rints.get("nblockx", 1), rints.get("nblocky", 1), rints.get("nblockz", 1)],
            dtype=np.int64,
        ),
        ndim=int(ints["dimensionality"]),
        raxis=raxis,
    )


def _ensure_block_axis(fields: Dict) -> Dict:
    return {k: (v[None] if v.ndim == 3 else v) for k, v in fields.items()}


def _uniform_volume(snap: Snapshot, name: str, what: str):
    """A snapshot field as a bare volume (single-block files only)."""
    v = snap.fields.get(name)
    if v is None:
        return None
    if v.ndim == 4:
        if v.shape[0] != 1:
            raise ValueError(
                f"{what} needs single-block uniform volumes; got {v.shape[0]} blocks from "
                f"{snap.path} — use favre_series/reynolds_series for AMR series, or regrid "
                "with from_amr first."
            )
        v = v[0]
    return v


def series_input_budget(device) -> float:
    """Bytes of resident batch inputs ``flagship_series`` sizes its auto
    batch against: 7/16 of the card's memory (fava_tpu's 7e9 bytes of a
    16 GB chip, scaled), or 7e9 on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 7e9
    return 7 / 16 * torch.cuda.get_device_properties(device).total_memory


def auto_batch(per_snapshot_bytes: int, budget: float) -> int:
    """Snapshots per dispatch for ``batch=0``: the budget's worth, 1-8."""
    return int(np.clip(budget // max(per_snapshot_bytes, 1), 1, 8))


@Model.register_analysis(use_timer=True)
def favre_series(
    self,
    file_type: str = "plt",
    raxis: int = 0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Favre means + mass-weighted RMS profiles over a snapshot series:
    stacked (nfiles, nfine) profiles per velocity component, the times
    and the common span."""
    _indices, paths = mesh_series_paths(self, file_type, file_indices)
    times = []
    stacked: Dict[str, list] = {}
    span = None
    for snap in SnapshotPrefetcher(paths, FIELDS, depth=prefetch_depth, device=self.device):
        geom = _geometry_from_snapshot(snap, raxis)
        out = profile_ops.favre_profiles(_ensure_block_axis(snap.fields), geom)
        times.append(snap.time)
        span = out["span"]
        for a in "xyz"[: geom.ndim]:
            stacked.setdefault(f"favre_mean_vel{a}", []).append(out["favre_mean"][f"vel{a}"])
            stacked.setdefault(f"favre_rms_vel{a}", []).append(out["favre_rms"][f"vel{a}"])
        stacked.setdefault("mean_dens", []).append(out["mean_dens"])
    result: Dict[str, np.ndarray] = {k: np.stack(v) for k, v in stacked.items()}
    result["times"] = np.asarray(times)
    result["span"] = span
    return result


@Model.register_analysis(use_timer=True)
def reynolds_series(
    self,
    file_type: str = "plt",
    raxis: int = 0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Reynolds-stress profiles over a snapshot series (async ingest)."""
    _indices, paths = mesh_series_paths(self, file_type, file_indices)
    times = []
    stacked: Dict[str, list] = {}
    radius = None
    for snap in SnapshotPrefetcher(paths, FIELDS, depth=prefetch_depth, device=self.device):
        geom = _geometry_from_snapshot(snap, raxis)
        radius, stress, means = profile_ops.reynolds_stress(_ensure_block_axis(snap.fields), geom)
        times.append(snap.time)
        for k, v in stress.items():
            stacked.setdefault(k, []).append(v)
        for k, v in means.items():
            stacked.setdefault(f"mean_{k}", []).append(v)
    result: Dict[str, np.ndarray] = {k: np.stack(v) for k, v in stacked.items()}
    result["times"] = np.asarray(times)
    result["radius"] = radius
    return result


@Model.register_analysis(use_timer=True)
def flagship_series(
    self,
    file_type: str = "uni",
    batch: int = 0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Flagship spectra + Reynolds/Favre profiles over a uniform series,
    ``batch`` snapshots per ``flagship.series_analysis_step`` call;
    outputs carry a leading snapshot axis.

    ``batch=0`` sizes the batch from the snapshot footprint against
    ``series_input_budget`` (``auto_batch``); a short final batch runs
    as it is. A batch that runs out of device memory is halved and
    retried, and the smaller batch holds for the rest of the series.
    """
    from fava_tpu_torch import flagship

    _indices, paths = mesh_series_paths(self, file_type, file_indices)

    def vol(snap: Snapshot, name: str):
        v = _uniform_volume(snap, name, "flagship_series")
        if v is None:
            raise KeyError(f"{snap.path}: missing required field {name!r}")
        return v

    times: list = []
    chunks: Dict[str, list] = {}
    pending: list = []
    batch_cap = [0]  # the batch that fits, once an OOM has shown it (0: none yet)

    def flush_once(group):
        stacked = []
        try:
            for f in FIELDS:
                stacked.append(torch.stack([vol(s, f) for s in group]))
            out = flagship.series_analysis_step(*stacked)
        finally:
            # Drop the stacked batch before an OOM unwinds: the traceback
            # would pin it through the retries.
            stacked.clear()
        for k, v in out.items():
            chunks.setdefault(k, []).append(v.cpu().numpy())

    def flush(group):
        if batch_cap[0] and len(group) > batch_cap[0]:
            for k in range(0, len(group), batch_cap[0]):
                flush(group[k : k + batch_cap[0]])
            return
        half = 0
        try:
            flush_once(group)
        except torch.cuda.OutOfMemoryError:
            if len(group) <= 1:
                raise
            half = batch_cap[0] = (len(group) + 1) // 2
            logger.warning(
                "flagship_series: batch %d exhausted device memory; falling back to batches "
                "of %d for the rest of the series", len(group), half,
            )
        if half:
            # Retry OUTSIDE the except block: the live exception's traceback
            # pins the failed batch's tensors; leaving the handler releases
            # them, and empty_cache returns their memory to the card.
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            flush(group[:half])
            flush(group[half:])

    for snap in SnapshotPrefetcher(paths, FIELDS, depth=prefetch_depth, device=self.device):
        if batch <= 0:
            per_snap = sum(vol(snap, f).nbytes for f in FIELDS)
            batch = auto_batch(per_snap, series_input_budget(self.device))
            logger.info("flagship_series: auto batch %d", batch)
        times.append(snap.time)
        pending.append(snap)
        if len(pending) >= batch:
            flush(pending)
            pending = []
    if pending:
        flush(pending)

    result: Dict[str, np.ndarray] = {k: np.concatenate(v) for k, v in chunks.items()}
    result["times"] = np.asarray(times)
    return result
