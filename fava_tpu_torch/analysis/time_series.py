"""Multi-snapshot time-series drivers on the async ingest.

Counterpart of fava_tpu/analysis/time_series.py: the flagship,
Reynolds-stress, Favre, turbulence-summary, gradient-statistics and
particle series. ``io/ingest.SnapshotPrefetcher`` overlaps the read and
the copy to the card of snapshot N+1 with the compute on snapshot N (the
mesh series).

Under a snap x space mesh (``parallel.runtime.is_pod_mesh``)
``flagship_series`` takes the pod branch: each batch is padded to a
multiple of the snap axis by repeating its last snapshot, snap row s
takes the batch's snapshots s, s + n_snap, ... and rank (s, r) runs
``flagship.sharded_series_analysis_step`` on them, each as its x-slab r
(B6, K1 and K2 a rank); one all_gather on the snap group joins the rows'
outputs, so every rank returns the same dict, and the pad is trimmed.
Deviations from fava_tpu, which reads each snapshot split over all
devices and restacks it to ``P(snap, space)`` over the interconnect
(fava_tpu/analysis/time_series.py:25-36): each rank reads from the file
only the slabs its step takes, so each field byte is read once, by the
rank that uses it, with no restack; and a row's share is strided rather
than a contiguous block, so that halving a batch in whole snap rows
after an out-of-memory error leaves every rank's snapshots its own (the
ranks of a space group run the same shapes, so such an error strikes
them alike; one that struck a single rank would leave its peers in the
step's collectives until ``runtime.COLLECTIVE_TIMEOUT``). The
eligibility of every file (nx and ny multiples of the space axis) is
decided from the file headers before the series starts, so a series
falls back to the single-device scan as a whole, with fava_tpu's
warning. ``reynolds_series`` and ``favre_series`` read each snapshot
whole; under a mesh of more than one rank their AMR profiles split the
leaf blocks over every rank (``ops/profiles.py``). ``particle_series``
runs unsharded under a mesh, as in fava_tpu.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fava_tpu_torch.analysis._catalogs import mesh_series_paths
from fava_tpu_torch.io import flash_file, h5lite
from fava_tpu_torch.io.ingest import Snapshot, SnapshotPrefetcher
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.ops import profiles as profile_ops
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import field_dtype

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
def particle_series(
    self,
    fields: Optional[Sequence[str]] = None,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Per-snapshot particle statistics (mean/RMS/min/max, float64 on the
    device through ``FlashParticles.statistics``) over the part-file
    series: {"<field>_<stat>": (nfiles,), "times"}."""
    indices = (
        sorted(self.prt_files["by index"].keys()) if file_indices is None else list(file_indices)
    )
    times = []
    stacked: Dict[str, list] = {}
    for i in indices:
        self.load(file_index=i, file_type="prt", fields=list(fields) if fields else None)
        times.append(self.particles.time)
        stats = self.particles.statistics(fields)
        for fname, s in stats.items():
            for key, val in s.items():
                stacked.setdefault(f"{fname}_{key}", []).append(val)
    out = {k: np.asarray(v) for k, v in stacked.items()}
    out["times"] = np.asarray(times)
    return out


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
    Under a snap x space mesh the batches run on the pod (module
    docstring): the auto batch is ``auto_batch(...) * n_snap``, and a
    batch is halved in whole snap rows.
    """
    from fava_tpu_torch import flagship

    _indices, paths = mesh_series_paths(self, file_type, file_indices)
    mesh = runtime.get_mesh()
    if runtime.is_pod_mesh(mesh) and paths:
        headers = [_volume_header(p) for p in paths]
        d = runtime.space_axis_size(mesh)
        bad = next((shape for _t, shape in headers if shape[0] % d or shape[1] % d), None)
        if bad is None:
            return _pod_flagship_series(self, paths, headers, batch, prefetch_depth, mesh)
        logger.warning(
            "flagship_series: volume extents %s do not divide the space axis %d; falling back "
            "to the single-chip series scan", bad, d,
        )

    times: list = []

    def batches(batch):
        pending = []
        for snap in SnapshotPrefetcher(paths, FIELDS, depth=prefetch_depth, device=self.device):
            if batch <= 0:
                per_snap = sum(_series_volume(snap, f).nbytes for f in FIELDS)
                batch = auto_batch(per_snap, series_input_budget(self.device))
                logger.info("flagship_series: auto batch %d", batch)
            times.append(snap.time)
            pending.append(snap)
            if len(pending) >= batch:
                yield pending, len(pending)
                pending = []
        if pending:
            yield pending, len(pending)

    scan = batches(batch)
    try:
        result = _batched_series(scan, flagship.series_analysis_step, 1, self.device)
    finally:
        scan.close()
    result["times"] = np.asarray(times)
    return result


def _series_volume(snap: Snapshot, name: str):
    v = _uniform_volume(snap, name, "flagship_series")
    if v is None:
        raise KeyError(f"{snap.path}: missing required field {name!r}")
    return v


def _batched_series(batches, step, n_snap: int, device) -> Dict[str, np.ndarray]:
    """The flagship series' outputs over ``batches``, pairs (this rank's
    snapshots of a batch, the batch's count k of real ones): ``step`` on
    the stacked fields of a rank's snapshots returns the outputs of the
    batch padded to ``len(local) * n_snap`` (``n_snap`` 1 off a pod),
    trimmed here to k. A batch that runs out of device memory is halved
    in whole snap rows and retried, and the smaller batch holds for the
    rest of the series."""
    chunks: Dict[str, list] = {}
    cap = [0]  # a rank's snapshots that fit, once an OOM has shown it (0: none yet)

    def run(local, k):
        stacked = []
        try:
            for f in FIELDS:
                stacked.append(torch.stack([_series_volume(s, f) for s in local]))
            out = step(*stacked)
        finally:
            # Drop the stacked batch before an OOM unwinds: the traceback
            # would pin it through the retries.
            stacked.clear()
        for key, v in out.items():
            chunks.setdefault(key, []).append(v[:k].cpu().numpy())

    def flush(local, k):
        if cap[0] and len(local) > cap[0]:
            for j in range(0, len(local), cap[0]):
                flush(local[j : j + cap[0]], min(k - j * n_snap, cap[0] * n_snap))
            return
        half = 0
        try:
            run(local, k)
        except torch.cuda.OutOfMemoryError:
            if len(local) <= 1:
                raise
            half = cap[0] = (len(local) + 1) // 2
            logger.warning(
                "flagship_series: batch %d exhausted device memory; falling back to batches "
                "of %d for the rest of the series", k, half * n_snap,
            )
        if half:
            # Retry OUTSIDE the except block: the live exception's traceback
            # pins the failed batch's tensors; leaving the handler releases
            # them, and empty_cache returns their memory to the card.
            if device.type == "cuda":
                torch.cuda.empty_cache()
            flush(local[:half], half * n_snap)
            flush(local[half:], k - half * n_snap)

    for local, k in batches:
        flush(local, k)
    return {key: np.concatenate(v) for key, v in chunks.items()}


def _volume_header(path):
    """(time, (nx, ny, nz)) of a single-block uniform file, from its
    header and the stored shape of its dens field."""
    with h5lite.File(path, "r") as f:
        time = float(flash_file.read_scalars(f)["real"].get("time", 0.0))
        if "dens" not in flash_file.read_unknown_names(f):
            raise KeyError(f"{path}: missing required field 'dens'")
        shape = flash_file.field_grid_shape(f, "dens")
    if len(shape) == 4:
        if shape[0] != 1:
            raise ValueError(
                f"flagship_series needs single-block uniform volumes; got {shape[0]} blocks from "
                f"{path} — use favre_series/reynolds_series for AMR series, or regrid with "
                "from_amr first."
            )
        shape = shape[1:]
    return time, shape


def _join_snap_rows(out: Dict[str, torch.Tensor], mesh, n_snap: int) -> Dict[str, torch.Tensor]:
    """Every snap row's outputs in batch order: one all_gather on the
    snap group of this row's outputs packed as float64 (counts are exact
    there), interleaved as the rows hold the batch (row s: s, s +
    n_snap, ...)."""
    keys = list(out)
    rows = int(out[keys[0]].shape[0])
    flat = [out[k].reshape(rows, -1).to(torch.float64) for k in keys]
    packed = torch.cat(flat, dim=1)
    parts = [torch.empty_like(packed) for _ in range(n_snap)]
    dist.all_gather(parts, packed, group=mesh.get_group(runtime.SNAP_AXIS))
    joined = torch.stack(parts, dim=1).reshape(rows * n_snap, -1)
    pieces = joined.split([f.shape[1] for f in flat], dim=1)
    return {
        k: p.reshape((rows * n_snap,) + tuple(out[k].shape[1:])).to(out[k].dtype)
        for k, p in zip(keys, pieces)
    }


def _pod_flagship_series(model, paths, headers, batch: int, prefetch_depth: int, mesh):
    """``flagship_series`` on a snap x space mesh (module docstring)."""
    from fava_tpu_torch import flagship

    n_snap = runtime.snap_axis_size(mesh)
    row = int(mesh.get_local_rank(runtime.SNAP_AXIS))
    if batch <= 0:
        itemsize = torch.finfo(field_dtype(model.device)).bits // 8
        per_snap = len(FIELDS) * itemsize * int(np.prod(headers[0][1]))
        batch = auto_batch(per_snap, series_input_budget(model.device)) * n_snap
        logger.info("flagship_series: auto batch %d", batch)
    groups = [list(range(k, min(k + batch, len(paths)))) for k in range(0, len(paths), batch)]

    def share(group):
        padded = group + [group[-1]] * ((-len(group)) % n_snap)
        return padded[row::n_snap]

    def slab(name, shape):
        return runtime.space_placement(mesh, axis=len(shape) - 3)

    def step(*fields):
        return _join_snap_rows(flagship.sharded_series_analysis_step(*fields, mesh=mesh), mesh, n_snap)

    order = [paths[i] for g in groups for i in share(g)]
    snaps = iter(SnapshotPrefetcher(order, FIELDS, depth=prefetch_depth, sharding=slab,
                                    device=model.device))
    try:
        batches = (([next(snaps) for _ in range(-(-len(g) // n_snap))], len(g)) for g in groups)
        result = _batched_series(batches, step, n_snap, model.device)
    finally:
        snaps.close()
    result["times"] = np.asarray([t for t, _shape in headers])
    return result


def _packed_stat_series(paths, fields, make_vec, prefetch_depth: int, device, group: int = 16):
    """The packed-vector series loop of ``summary_series`` and
    ``gradient_series``: prefetch each snapshot, ``make_vec(snap) ->
    (vector on the device, names)``, and fetch the vectors ``group``
    snapshots at a time as one stacked array. Returns ``(times (nfiles,),
    names, table (nfiles, nstats) or None)``; raises when the columns
    change between files (optional fields present in only some)."""
    times: list = []
    names: Optional[tuple] = None
    pending: list = []  # packed vectors still on the device
    rows: list = []  # fetched (group, nstats) blocks

    def flush():
        if pending:
            rows.append(torch.stack(pending).cpu().numpy().astype(np.float64))
            pending.clear()

    for snap in SnapshotPrefetcher(paths, fields, depth=prefetch_depth, strict=False, device=device):
        vec, snap_names = make_vec(snap)
        if names is None:
            names = tuple(snap_names)
        elif tuple(snap_names) != names:
            missing = sorted(set(names) - set(snap_names))
            extra = sorted(set(snap_names) - set(names))
            detail = (
                f"missing {missing}, unexpected {extra}"
                if (missing or extra)
                else f"same columns in a different order: got {list(snap_names)}, "
                f"expected {list(names)}"
            )
            raise ValueError(f"{snap.path}: inconsistent stat columns across the series ({detail})")
        times.append(snap.time)
        pending.append(vec)
        if len(pending) >= group:
            flush()
    flush()
    table = np.concatenate(rows) if rows else None
    return np.asarray(times), names, table


def _series_velocities(snap: Snapshot, what: str):
    """(ndim, domain lengths, the in-plane velocity volumes) of a snapshot."""
    ndim = int(snap.scalars["integer"]["dimensionality"])
    reals = snap.runtime_parameters["real"]
    lengths = tuple(float(reals.get(f"{a}max", 1.0)) - float(reals.get(f"{a}min", 0.0))
                    for a in "xyz"[:ndim])
    vels = [_uniform_volume(snap, f"vel{a}", what) for a in "xyz"[:ndim]]
    if any(v is None for v in vels):
        raise KeyError(f"{snap.path}: missing velocity components")
    return ndim, lengths, [v.reshape(v.shape[:ndim]) for v in vels]


@Model.register_analysis(use_timer=True)
def summary_series(
    self,
    file_type: str = "uni",
    gamma: float = 5.0 / 3.0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Turbulence-summary time series over a uniform-file catalog: one
    ``ops/velocity.turbulence_summary_device`` per snapshot on the
    prefetched fields, the packed vectors fetched 16 snapshots at a time.
    ``pres``/``gamc`` ride along when the files carry them (the Mach
    columns appear only then; ``gamma`` is the fallback ratio). Returns
    {"times", <scalar name>: (nfiles,) arrays}."""
    from fava_tpu_torch.ops import velocity as vel_ops

    _indices, paths = mesh_series_paths(self, file_type, file_indices)
    fields = ["dens", "velx", "vely", "velz", "pres", "gamc"]

    def make_vec(snap: Snapshot):
        ndim, lengths, vels = _series_velocities(snap, "summary_series")

        def squeeze(name):
            v = _uniform_volume(snap, name, "summary_series")
            return None if v is None else v.reshape(v.shape[:ndim])

        dens, pres, gamc = squeeze("dens"), squeeze("pres"), squeeze("gamc")
        return vel_ops.turbulence_summary_device(
            *vels, dens=dens, pres=pres,
            gamma=gamc if (pres is not None and gamc is not None) else gamma, lengths=lengths,
        )

    times, names, table = _packed_stat_series(paths, fields, make_vec, prefetch_depth, self.device)
    result: Dict[str, np.ndarray] = (
        {k: table[:, i] for i, k in enumerate(names)} if table is not None else {}
    )
    result["times"] = times
    return result


@Model.register_analysis(use_timer=True)
def gradient_series(
    self,
    file_type: str = "uni",
    boundary: str = "periodic",
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Velocity-gradient statistics time series over a uniform catalog
    (ops/gradients.py, moments centred on the device), on the loop of
    :func:`summary_series`. Returns {"times": (nfiles,), <scalar>:
    (nfiles,), <table>: (nfiles, nd, nd) / (nfiles, nd) arrays}."""
    from fava_tpu_torch.ops import gradients as grad_ops

    _indices, paths = mesh_series_paths(self, file_type, file_indices)

    def make_vec(snap: Snapshot):
        _ndim, lengths, vels = _series_velocities(snap, "gradient_series")
        return grad_ops.gradient_stats_device(vels, lengths=lengths, boundary=boundary)

    times, names, table = _packed_stat_series(paths, ["velx", "vely", "velz"], make_vec,
                                              prefetch_depth, self.device)
    result: Dict[str, np.ndarray] = {"times": times}
    if table is not None:
        # The packed length identifies nd (48 entries in 3D, 22 in 2D).
        by_len = {len(grad_ops.packed_names(nd)): nd for nd in (3, 2)}
        if len(names) not in by_len:
            raise RuntimeError(
                f"gradient_series: packed vector length {len(names)} matches neither the 3D "
                f"({len(grad_ops.packed_names(3))}) nor the 2D ({len(grad_ops.packed_names(2))}) "
                "layout"
            )
        reports = [grad_ops.assemble_gradient_stats(row, by_len[len(names)]) for row in table]
        for key in reports[0]:
            result[key] = np.stack([np.asarray(r[key]) for r in reports])
    return result
