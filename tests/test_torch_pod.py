"""fava_tpu_torch's AMR paths over devices and its snap x space pod series
held to fava_tpu on the CPU, in float64.

The port runs in gloo worlds of 4 and 8 ranks, spawned once each
(module-scoped), as tests/test_torch_parallel.py does: 4 ranks as a
(2, 2) snap x space pod and a (4,) space mesh, 8 ranks as a (2, 4) pod
and an (8,) space mesh. Every rank runs every scenario and saves its
results, with each call of the kernel wrappers it made (their argument
shapes, recorded by wrapping the wrappers inside the rank); the tests
hold them to fava_tpu on conftest's 8-device CPU mesh (or its first 4
devices for the 4-rank world) and on one device. Spawned ranks import
this module, so jax and fava_tpu are imported only inside the tests.
Inputs are conftest's synthetic files, files written here from seeds,
and seeded numpy arrays.

Tolerances are those of the mirrored tests of tests/test_parallel.py:
AMR Reynolds stress rtol 1e-9 (means 1e-10); the pod series rtol 1e-9,
atol 1e-12; the non-divisible fallback rtol 1e-12, atol 1e-15; config
#5's Favre series rtol 1e-9 and particle statistics rtol 1e-12. The
regrid (injection is a copy), the ingest (a read), the written files,
the block shares' moments and every count are exact.
"""

import logging
import os
import time
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

JOIN_SECONDS = 300  # a hung world fails its tests, not the suite's limit
COLLECTIVE_SECONDS = 120

SERIES_LOGGER = "fava_tpu_torch.analysis.time_series"
SAVED = ("dens", "velx", "vely", "velz")
# The kernel wrappers whose calls the ranks record (K5, K6, K7, K1, K2, B6).
WRAPPED = ("block_row_moments", "block_centered_row_moments", "regrid_fields", "row_moments_volume",
           "centered_row_moments", "shell_bin_values_rfft_chunk")


def _record(cuda_kernels):
    """Wrap the kernel wrappers of ``WRAPPED`` so that every call appends
    (name, shapes of its tensor arguments, its other arguments)."""
    calls = []

    def wrap(name, fn):
        def counted(*args, **kwargs):
            shapes = []
            for a in args:
                if isinstance(a, torch.Tensor):
                    shapes.append(tuple(a.shape))
                elif isinstance(a, (list, tuple)) and a and isinstance(a[0], torch.Tensor):
                    shapes.append([tuple(t.shape) for t in a])
                else:
                    shapes.append(a)
            calls.append((name, shapes))
            return fn(*args, **kwargs)

        return counted

    for name in WRAPPED:
        setattr(cuda_kernels, name, wrap(name, getattr(cuda_kernels, name)))
    return calls


@contextmanager
def _logs(level):
    """The messages the series driver logs at ``level`` or above."""
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger = logging.getLogger(SERIES_LOGGER)
    handler, prev = Keep(level), logger.level
    logger.addHandler(handler)
    logger.setLevel(level)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)
        logger.setLevel(prev)


def _host(fields):
    return {k: v.numpy() for k, v in fields.items()}


def _scenarios(rank: int, world: int, paths: dict, workdir: str):
    import fava_tpu_torch
    from fava_tpu_torch import flagship, parallel
    from fava_tpu_torch.io import flash_file, ingest
    from fava_tpu_torch.mesh import FLASH as AMR
    from fava_tpu_torch.mesh import FlashUniform
    from fava_tpu_torch.ops import cuda_kernels
    from fava_tpu_torch.parallel import runtime

    calls = _record(cuda_kernels)
    writes = []
    write_mesh_file = flash_file.write_mesh_file

    def counted_write(path, **kw):
        writes.append(str(path))
        return write_mesh_file(path, **kw)

    flash_file.write_mesh_file = counted_write

    def run(fn):
        calls.clear()
        return fn(), list(calls)

    out = {"rank": rank}
    space = parallel.make_device_mesh(device="cpu")
    pod = parallel.make_device_mesh((2, world // 2), ("snap", "space"), device="cpu")
    out["order"] = (runtime.flat_ranks(space), runtime.flat_ranks(pod))
    out["coords"] = (runtime.flat_index(pod), int(pod.get_local_rank("snap")),
                     int(pod.get_local_rank("space")))
    out["placements"] = (parallel.block_sharding(space), parallel.block_sharding(pod),
                         parallel.ingest_volume_sharding(pod), runtime.space_placement(pod))

    # tests/test_parallel.py:53, the AMR Reynolds stress on the space mesh.
    with parallel.use_mesh(space):
        m = AMR(paths["amr"], device="cpu")
        m.load()
        out["amr_reynolds"], out["amr_reynolds_calls"] = run(lambda: m.reynolds_stress()[1:])
        out["amr_favre"], out["amr_favre_calls"] = run(m.favre_profiles)

    with parallel.use_mesh(pod):
        # :154, the AMR profiles on the pod: the leaves split over all ranks.
        m = AMR(paths["amr"], device="cpu")
        m.load()
        out["pod_reynolds"], out["pod_reynolds_calls"] = run(lambda: m.reynolds_stress()[1:])
        # :112, three files, batch 2 on 2 snap rows: a padded short batch.
        series = fava_tpu_torch.FLASH(paths["series"], device="cpu")
        out["pod_series"], out["pod_series_calls"] = run(lambda: series.flagship_series(batch=2))
        # :138, the auto batch.
        with _logs(logging.INFO) as seen:
            out["pod_auto"] = series.flagship_series()
        out["pod_auto_logs"] = seen
        # An out-of-memory error halves the batch in whole snap rows.
        step = flagship.sharded_series_analysis_step

        def oom_above_one(*fields, mesh):
            if fields[0].shape[0] > 1:
                raise torch.cuda.OutOfMemoryError("more than one snapshot a rank")
            return step(*fields, mesh=mesh)

        flagship.sharded_series_analysis_step = oom_above_one
        try:
            with _logs(logging.WARNING) as seen:
                out["pod_oom"], out["pod_oom_calls"] = run(
                    lambda: series.flagship_series(batch=4))
        finally:
            flagship.sharded_series_analysis_step = step
        out["pod_oom_logs"] = seen
        # :178, extents that do not divide the space axis.
        with _logs(logging.WARNING) as seen:
            out["nondiv"] = fava_tpu_torch.FLASH(paths[f"nondiv{world}"],
                                                 device="cpu").flagship_series()
        out["nondiv_logs"] = seen
        # :200, BASELINE config #5 in miniature.
        cfg = fava_tpu_torch.FLASH(paths["config5"], device="cpu")
        out["config5"] = (cfg.favre_series(file_type="plt"), cfg.flagship_series(),
                          cfg.particle_series(fields=["velx"]))
        # :240, the ingest callback on the pod.
        fn = parallel.ingest_sharding_fn(pod)
        snaps = ingest.SnapshotPrefetcher([paths["p16"], paths["p12"]], ["dens", "velx"],
                                          sharding=fn, device="cpu")
        out["ingest"] = [(_host(s.fields), s.placements) for s in snaps]

    # :264, block stacks through the ingest callback on the space mesh.
    fn = parallel.ingest_sharding_fn(space)
    (snap,) = ingest.SnapshotPrefetcher([paths["amr"]], ["dens"], sharding=fn, device="cpu")
    out["ingest_blocks"] = (snap.fields["dens"].numpy(), snap.placements["dens"])

    with parallel.use_mesh(space):
        # MULTICHIP_r05's sharded regrid, through from_amr.
        m = AMR(paths["amr"], device="cpu")
        m.load()
        _, out["regrid_calls"] = run(lambda: m.from_amr(fields=["dens", "velx"], save_file=False))
        out["regrid"] = ({k: m._slab(k).numpy() for k in ("dens", "velx")}, m._dmesh is space,
                         m.data("dens").numpy())
        # An explicit placement takes the same path.
        m = AMR(paths["amr"], device="cpu")
        m.load()
        _, out["placed_calls"] = run(lambda: m.from_amr(
            fields=["dens"], save_file=False, sharding=runtime.space_placement(space)))
        out["placed"] = m._slab("dens").numpy()
        # The sharded save of a uniform file's volume, and from_amr with
        # its file.
        uni = FlashUniform(paths["p16"], device="cpu")
        uni.load()
        for name in SAVED:
            uni._slab(name)
        writes.clear()
        uni.save(Path(workdir) / "rt_hdf5_uniform_0001", names=list(SAVED))
        out["save"] = (uni._dmesh is space, list(writes))
        m = AMR(paths["amr"], device="cpu")
        m.load()
        writes.clear()
        m.from_amr(fields=["dens", "velx"], filename=Path(workdir) / "rt_hdf5_uniform_0002")
        out["from_amr_save"] = list(writes)
        back = FlashUniform(Path(workdir) / "rt_hdf5_uniform_0002", device="cpu")
        back.load()
        out["read_back"] = (back._slab("velx").numpy(), m._slab("velx").numpy())
    return out


def _rank_main(rank: int, world: int, store: str, workdir: str, paths: dict):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{store}",
        rank=rank,
        world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_SECONDS),
    )
    try:
        out = _scenarios(rank, world, paths, workdir)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_world(world: int, workdir, paths):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main,
        args=(world, str(workdir / "store"), str(workdir), {k: str(v) for k, v in paths.items()}),
        nprocs=world,
        join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank world did not finish in {JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def files(tmp_path_factory, amr_file):
    """The inputs of every scenario, written with fava_tpu's synthetic
    writer (tests/test_parallel.py's shapes and seeds)."""
    from fava_tpu.io import synthetic

    root = tmp_path_factory.mktemp("pod_files")
    out = {"amr": amr_file}
    for name, seeds, n in (("series", (21, 22, 23), 16), ("nondiv8", (51, 52), 10),
                           ("nondiv4", (51, 52), 9)):
        out[name] = root / name
        out[name].mkdir()
        for i, seed in enumerate(seeds, start=1):
            synthetic.make_uniform_file(out[name] / f"rt_hdf5_uniform_{i:04d}", ncells=(n, n, n),
                                        seed=seed, time=0.1 * i)
    out["config5"] = cfg = root / "config5"
    cfg.mkdir()
    for i, t in enumerate([0.0, 0.1], start=1):
        synthetic.make_amr_file(cfg / f"rt_hdf5_plt_cnt_{i:04d}", ncells=(4, 4, 4),
                                nblks=(2, 2, 2), refine={0: 2}, time=t)
        synthetic.make_uniform_file(cfg / f"rt_hdf5_uniform_{i:04d}", ncells=(16, 16, 16),
                                    seed=40 + i)
        synthetic.make_particle_file(cfg / f"rt_hdf5_part_{i:04d}", nparticles=64, seed=i)
    out["p16"] = synthetic.make_uniform_file(root / "rt_hdf5_uniform_0016", ncells=(16, 16, 16),
                                             seed=5)
    out["p12"] = synthetic.make_uniform_file(root / "rt_hdf5_uniform_0012", ncells=(12, 12, 12),
                                             seed=6)
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory, files):
    return _run_world(4, tmp_path_factory.mktemp("pod4"), files)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, files):
    return _run_world(8, tmp_path_factory.mktemp("pod8"), files)


def _world(request, name):
    ranks = request.getfixturevalue(name)
    return ranks, len(ranks)


def _fava_meshes(world):
    """fava_tpu's (world,) space mesh and (2, world/2) pod mesh."""
    from fava_tpu.parallel import make_device_mesh

    return make_device_mesh((world,), ("space",)), make_device_mesh((2, world // 2),
                                                                   ("snap", "space"))


@pytest.fixture(scope="module")
def fava_amr(files, eight_device_mesh):
    """fava_tpu's AMR Reynolds stress and Favre profiles, unsharded, on the
    8-device mesh and on the (2, 4) pod."""
    from fava_tpu.mesh import FLASH as FlashAMR
    from fava_tpu.parallel import use_mesh

    def profiles():
        m = FlashAMR(files["amr"])
        m.load()
        return m.reynolds_stress()[1:], m.favre_profiles(), m.get_blocklist("LEAF").size

    ref = {"single": profiles()}
    with use_mesh(eight_device_mesh):
        ref["eight"] = profiles()
    with use_mesh(_fava_meshes(8)[1]):
        ref["pod"] = profiles()
    return ref


@pytest.fixture(scope="module")
def fava_single_steps(files):
    """fava_tpu's flagship_analysis of each file of the pod series."""
    import fava_tpu

    m = fava_tpu.FLASH(files["series"])
    out = []
    for j in range(3):
        m.load(file_type="uni", file_index=j)
        out.append({k: np.asarray(v) for k, v in m.flagship_analysis().items()})
    return out


def _assert_profiles(got, want, srtol=1e-9, mrtol=1e-10):
    (stress1, means1), (stress0, means0) = got, want
    assert set(stress1) == set(stress0)
    for key in stress0:
        np.testing.assert_allclose(stress1[key], stress0[key], rtol=srtol, err_msg=key)
    for key in means0:
        np.testing.assert_allclose(means1[key], means0[key], rtol=mrtol, err_msg=key)


def _share_calls(calls, nleaf, parts):
    """Each rank launched K5 and K6 once, on its share of the leaves."""
    share = -(-nleaf // parts)
    names = [c[0] for c in calls]
    assert names == ["block_row_moments", "block_centered_row_moments"], names
    for _name, shapes in calls:
        assert shapes[0] == (share, 8, 8, 8)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_flat_order_matches_the_world(request, world):
    ranks, n = _world(request, world)
    from fava_tpu_torch.parallel import Placement

    for r in ranks:
        assert r["order"] == (tuple(range(n)), tuple(range(n)))
        flat, s, sp = r["coords"]
        assert flat == r["rank"] == s * (n // 2) + sp
        assert r["placements"] == (Placement(0, r["rank"], n), Placement(0, r["rank"], n),
                                   Placement(0, r["rank"], n), Placement(0, sp, n // 2))


@pytest.mark.parametrize("world", ["four", "eight"])
def test_sharded_amr_reynolds_match(request, world, fava_amr):
    """tests/test_parallel.py:53 on the space mesh: the leaves split over
    every rank, K5 and K6 once a rank on its share."""
    ranks, n = _world(request, world)
    (stress0, means0), favre0, nleaf = fava_amr["single"]
    for r in ranks:
        stress1, _means1 = r["amr_reynolds"]
        for key in stress0:
            np.testing.assert_allclose(stress1[key], stress0[key], rtol=1e-9, err_msg=key)
        _assert_profiles(r["amr_reynolds"], fava_amr["eight"][0])
        _share_calls(r["amr_reynolds_calls"], nleaf, n)
        _share_calls(r["amr_favre_calls"], nleaf, n)
        np.testing.assert_allclose(r["amr_favre"]["mean_dens"], favre0["mean_dens"], rtol=1e-10)
        for a in "xyz":
            for kind in ("favre_mean", "favre_rms"):
                np.testing.assert_allclose(r["amr_favre"][kind][f"vel{a}"],
                                           favre0[kind][f"vel{a}"], rtol=1e-9)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pod_amr_profiles_shard_blocks_over_all_axes(request, world, fava_amr):
    """:154: on the snap x space pod the leaf blocks split over ALL ranks
    (no snap-row replication); the results equal the unsharded ones."""
    ranks, n = _world(request, world)
    nleaf = fava_amr["single"][2]
    for r in ranks:
        assert r["placements"][1].parts == n
        _assert_profiles(r["pod_reynolds"], fava_amr["single"][0])
        _assert_profiles(r["pod_reynolds"], fava_amr["pod"][0])
        _share_calls(r["pod_reynolds_calls"], nleaf, n)


def _assert_series_rows(series, singles, rtol=1e-9, atol=1e-12):
    for j, single in enumerate(singles):
        for key, val in single.items():
            np.testing.assert_allclose(series[key][j], val, rtol=rtol, atol=atol,
                                       err_msg=f"{key}[{j}]")


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pod_series_driver_matches_per_snapshot(request, world, fava_single_steps):
    """:112: three files, batch 2 on 2 snap rows (the second batch padded
    with its last snapshot), equal on every rank to fava_tpu's
    per-snapshot flagship_analysis; B6, K1 and K2 once a rank per
    snapshot of its row, on its x-slab."""
    ranks, n = _world(request, world)
    d = n // 2
    for r in ranks:
        series = r["pod_series"]
        assert series["times"].shape == (3,)
        np.testing.assert_allclose(series["times"], [0.1, 0.2, 0.3])
        _assert_series_rows(series, fava_single_steps)
        names = [c[0] for c in r["pod_series_calls"]]
        # Two batches: one snapshot a row in each (the second row's of
        # the second batch is the pad).
        for kernel in ("row_moments_volume", "centered_row_moments",
                       "shell_bin_values_rfft_chunk"):
            assert names.count(kernel) == 2, (kernel, names)
        moments = [s for name, s in r["pod_series_calls"] if name == "row_moments_volume"]
        assert all(shapes[0] == (16 // d, 16, 16) for shapes in moments)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pod_series_auto_batch_multiple_of_snap(request, world, fava_single_steps):
    """:138: the auto batch is a multiple of the snap axis, and every
    snapshot is covered exactly once."""
    ranks, _n = _world(request, world)
    for r in ranks:
        assert r["pod_auto"]["times"].shape == (3,)
        assert r["pod_auto"]["spectra_total"].shape[0] == 3
        (line,) = [m for m in r["pod_auto_logs"] if "auto batch" in m]
        assert int(line.split()[-1]) % 2 == 0
        _assert_series_rows(r["pod_auto"], fava_single_steps)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pod_series_oom_halves_in_snap_rows(request, world, fava_single_steps):
    """An out-of-memory error halves a batch in whole snap rows: batch 4
    of three files (two a row, the last the pad) retries as batches of 2,
    whose shares are the ranks' own."""
    ranks, _n = _world(request, world)
    for r in ranks:
        assert any("falling back to batches of 2" in m for m in r["pod_oom_logs"])
        _assert_series_rows(r["pod_oom"], fava_single_steps)
        names = [c[0] for c in r["pod_oom_calls"]]
        assert names.count("row_moments_volume") == 2


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pod_series_nondivisible_falls_back(request, world, files):
    """:178: 10^3 volumes (9^3 on the 4-rank world's space axis of 2) do
    not divide the space axis: the single-device scan on every rank,
    with the warning, and fava_tpu's numbers."""
    import fava_tpu

    ranks, n = _world(request, world)
    ref = fava_tpu.FLASH(files[f"nondiv{n}"]).flagship_series()
    for r in ranks:
        assert any("falling back" in m for m in r["nondiv_logs"])
        for k in ref:
            np.testing.assert_allclose(r["nondiv"][k], ref[k], rtol=1e-12, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pod_full_series_pipeline_config5(request, world, files):
    """:200: BASELINE config #5 in miniature under the pod: AMR Favre
    profiles (leaves over all ranks), the flagship series (snap x space
    batches) and particle statistics, equal to fava_tpu's unsharded
    runs."""
    import fava_tpu

    ranks, _n = _world(request, world)
    m = fava_tpu.FLASH(files["config5"])
    ref_favre = m.favre_series(file_type="plt")
    ref_flag = m.flagship_series()
    ref_part = m.particle_series(fields=["velx"])
    for r in ranks:
        got_favre, got_flag, got_part = r["config5"]
        for k in ref_favre:
            np.testing.assert_allclose(got_favre[k], ref_favre[k], rtol=1e-9, err_msg=k)
        for k in ref_flag:
            np.testing.assert_allclose(got_flag[k], ref_flag[k], rtol=1e-9, atol=1e-12, err_msg=k)
        for k in ref_part:
            np.testing.assert_allclose(got_part[k], ref_part[k], rtol=1e-12, err_msg=k)


def _fava_shards(arr):
    """fava_tpu array's data by device."""
    return {s.device: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("world", ["four", "eight"])
def test_ingest_prefetch_lands_sharded(request, world, files):
    """:240: the ingest callback puts each rank's rows of the 16^3 file
    on it (x split over all ranks), exactly fava_tpu's shard on the
    device of the same flat index; the 12^3 file splits only where 12
    divides the rank total (4 ranks), else it is read whole."""
    from fava_tpu.io.ingest import SnapshotPrefetcher
    from fava_tpu.parallel import runtime as prt

    ranks, n = _world(request, world)
    pod = _fava_meshes(n)[1]
    ref = list(SnapshotPrefetcher([files["p16"], files["p12"]], ["dens", "velx"],
                                  sharding=prt.ingest_sharding_fn(pod)))
    devices = list(pod.devices.flat)
    for r in ranks:
        for (fields, placements), snap, nx in zip(r["ingest"], ref, (16, 12)):
            split = nx % n == 0
            for name in ("dens", "velx"):
                arr = snap.fields[name]
                assert (len(arr.sharding.device_set) == n) == split
                want = _fava_shards(arr)[devices[r["rank"]]] if split else np.asarray(arr)
                assert fields[name].shape == (nx // n if split else nx, nx, nx)
                np.testing.assert_array_equal(fields[name], want)
                assert (placements[name] is not None) == split


@pytest.mark.parametrize("world", ["four", "eight"])
def test_ingest_prefetch_block_stacks_sharded(request, world, files):
    """:264: a block stack splits on blocks when the block count divides
    the rank total, each rank reading only its blocks."""
    from fava_tpu.io.ingest import SnapshotPrefetcher
    from fava_tpu.parallel import runtime as prt

    ranks, n = _world(request, world)
    space = _fava_meshes(n)[0]
    (snap,) = list(SnapshotPrefetcher([files["amr"]], ["dens"], sharding=prt.ingest_sharding_fn(space)))
    arr = snap.fields["dens"]
    nb = arr.shape[0]
    assert len(arr.sharding.device_set) == (n if nb % n == 0 else 1)
    devices = list(space.devices.flat)
    for r in ranks:
        got, placement = r["ingest_blocks"]
        np.testing.assert_array_equal(got, _fava_shards(arr)[devices[r["rank"]]])
        assert (placement is not None) == (nb % n == 0)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_sharded_amr_regrid_via_from_amr(request, world, files):
    """MULTICHIP_r05's check: from_amr under the space mesh regrids each
    rank's x-slab from its local blocks, equal to fava_tpu's
    regrid_fields_sharded (through its from_amr on the same mesh) and to
    the single-device regrid; K7 once a rank (2 fields), on the slab,
    from a local stack of bmax blocks."""
    from fava_tpu.mesh import FLASH as FlashAMR
    from fava_tpu.parallel import use_mesh
    from fava_tpu_torch.ops import regrid as tregrid

    ranks, n = _world(request, world)
    ref0 = FlashAMR(files["amr"])
    ref0.load()
    plan = tregrid.RegridPlan(block_bounds=ref0.block_bounds, node_type=ref0.node_type,
                              refine_level=ref0.refine_level, ncells_vec=ref0.nCellsVec,
                              nblks_vec=ref0.nBlksVec, ndim=3)
    splan = tregrid.ShardedRegridPlan(plan, n)
    ref0.from_amr(fields=["dens", "velx"], save_file=False)
    sh = FlashAMR(files["amr"])
    sh.load()
    with use_mesh(_fava_meshes(n)[0]):
        sh.from_amr(fields=["dens", "velx"], save_file=False)
    nx = plan.out_shape[0]
    rows = nx // n
    for r in ranks:
        slabs, is_sharded, whole = r["regrid"]
        assert is_sharded
        lo = r["rank"] * rows
        for key in ("dens", "velx"):
            want = np.asarray(sh._data[key])
            np.testing.assert_array_equal(slabs[key], want[lo : lo + rows])
            np.testing.assert_array_equal(slabs[key], np.asarray(ref0._data[key])[lo : lo + rows])
        np.testing.assert_array_equal(whole, np.asarray(ref0._data["dens"]))
        np.testing.assert_array_equal(r["placed"], slabs["dens"])
        ((_name, placed),) = r["placed_calls"]
        assert placed[0] == [(splan.bmax, 8, 8, 8)] and placed[5] == (lo, 0, 0)
        ((name, shapes),) = r["regrid_calls"]
        assert name == "regrid_fields"
        stacks, table, offsets, scales, out_shape, origin, _ncells = shapes
        assert stacks == [(splan.bmax, 8, 8, 8)] * 2
        assert offsets == (splan.bmax, 3) and scales == (splan.bmax,)
        assert out_shape == (rows,) + plan.out_shape[1:] and origin == (lo, 0, 0)
    assert splan.bmax < len(plan.block_scales)


def _datasets(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(v, h5py.Dataset) else None)
    return out


def _same_datasets(got, want):
    a, b = _datasets(got), _datasets(want)
    assert set(a) == set(b)
    for key in b:
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
        assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes(), key


@pytest.mark.parametrize("world", ["four", "eight"])
def test_sharded_save_round_trips(request, world, files, tmp_path):
    """save of a sharded volume gathers the slabs and rank 0 alone writes:
    the file's datasets equal, byte for byte, those written without a
    mesh; a sharded from_amr with its file likewise, and every rank reads
    its slab of that file back after the barrier."""
    from fava_tpu_torch.mesh import FLASH as TorchAMR
    from fava_tpu_torch.mesh import FlashUniform

    ranks, _n = _world(request, world)
    ref_arr = tmp_path / "rt_hdf5_uniform_0001"
    uni = FlashUniform(files["p16"], device="cpu")
    uni.load()
    for name in SAVED:
        uni.data(name)
    uni.save(ref_arr, names=list(SAVED))
    ref_amr = tmp_path / "rt_hdf5_uniform_0002"
    m = TorchAMR(files["amr"], device="cpu")
    m.load()
    m.from_amr(fields=["dens", "velx"], filename=ref_amr)
    written = ranks[0]["save"][1] + ranks[0]["from_amr_save"]
    for r in ranks:
        assert r["save"][0]
        assert (r["save"][1] + r["from_amr_save"] == written) == (r["rank"] == 0)
        if r["rank"]:
            assert r["save"][1] == [] and r["from_amr_save"] == []
        got, want = r["read_back"]
        np.testing.assert_array_equal(got, want)
    assert len(written) == 2
    _same_datasets(written[0], ref_arr)
    _same_datasets(written[1], ref_amr)


def test_sharded_regrid_divisibility_error():
    """The sharded plan names the space axis and the x extent the right
    way round."""
    from fava_tpu_torch.ops import regrid as tregrid

    plan = tregrid.RegridPlan(
        block_bounds=np.array([[[0.0, 1.0]] * 3]), node_type=np.array([1]),
        refine_level=np.array([1]), ncells_vec=np.array([8, 8, 8]), nblks_vec=np.array([1, 1, 1]),
        ndim=3,
    )
    with pytest.raises(ValueError, match=r"the space axis \(3\) must evenly divide the output x "
                                         r"extent \(8\)"):
        tregrid.ShardedRegridPlan(plan, 3)


@pytest.mark.parametrize("parts", [2, 3, 4, 8, 64])
def test_stack_stats_shares_concatenate_exactly(parts, amr_file):
    """The plain twins of K5/K6 on each share of the zero-padded leaf
    list, concatenated and trimmed, equal the single-device moments
    exactly (each block's moments are its own; the pad blocks' are 0)."""
    from fava_tpu_torch.mesh import FLASH as TorchAMR
    from fava_tpu_torch.ops import profiles
    from fava_tpu_torch.parallel import Placement

    m = TorchAMR(amr_file, device="cpu")
    m.load()
    data, geom = m._profile_fields(), m._profile_geometry(0)
    whole = torch.cat(profiles._stack_stats(data, geom))
    shares = [torch.cat(profiles._share_stats(profiles._leaf_fields(data, geom, Placement(0, r, parts)),
                                              geom)) for r in range(parts)]
    joined = torch.cat(shares, dim=1)
    nleaf = geom.blocklist.size
    assert joined.shape[1] == -(-nleaf // parts) * parts
    sizes = tuple(t.shape[0] for t in profiles._stack_stats(data, geom))
    assert torch.equal(torch.cat(profiles._split_joined(joined, sizes, geom)), whole)
    assert not joined[:, nleaf:].any()


def _regrid_plan(mesh, tregrid):
    return tregrid.RegridPlan(block_bounds=mesh.block_bounds, node_type=mesh.node_type,
                              refine_level=mesh.refine_level, ncells_vec=mesh.nCellsVec,
                              nblks_vec=mesh.nBlksVec, ndim=3)


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_placed_regrid_slabs_equal_the_whole_regrid(parts, amr_file):
    """regrid_fields with a placement of the output's x axis gives that
    part's slab from only the blocks it reads; the parts, stacked, equal
    the whole regrid exactly."""
    from fava_tpu_torch.mesh import FLASH as TorchAMR
    from fava_tpu_torch.ops import regrid as tregrid
    from fava_tpu_torch.parallel import Placement

    m = TorchAMR(amr_file, device="cpu")
    m.load()
    names = ["dens", "velx"]
    data = {k: m._field_stack(k) for k in names}
    plan = _regrid_plan(m, tregrid)
    whole = tregrid.regrid_fields(plan, data, names)
    slabs = [tregrid.regrid_fields(plan, data, names, sharding=Placement(0, r, parts))
             for r in range(parts)]
    for k in names:
        assert torch.equal(torch.cat([sl[k] for sl in slabs]), whole[k])
    with pytest.raises(ValueError, match="sharded along x"):
        tregrid.regrid_fields(plan, data, names, sharding=Placement(1, 0, parts))


def test_sharded_regrid_defaults_to_the_card(amr_file):
    """regrid_fields_sharded runs on cuda unless the caller asks for the
    CPU, whatever the type of the stacks it is given: host arrays from
    _host_field_stack raise without CUDA and are regridded on the CPU
    only with device="cpu"."""
    from fava_tpu_torch.mesh import FLASH as TorchAMR
    from fava_tpu_torch.ops import regrid as tregrid

    class OneRank:
        """A one-rank space mesh, as far as the regrid reads it."""

        mesh_dim_names = ("space",)
        shape = (1,)

        def get_local_rank(self, axis):
            return 0

    m = TorchAMR(amr_file, device="cpu")
    m.load()
    plan = _regrid_plan(m, tregrid)
    stacks = {"dens": m._host_field_stack("dens")}
    assert isinstance(stacks["dens"], np.ndarray)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tregrid.regrid_fields_sharded(plan, stacks, ["dens"], OneRank())
    got = tregrid.regrid_fields_sharded(plan, stacks, ["dens"], OneRank(), device="cpu",
                                        dtype=torch.float64)
    want = tregrid.regrid_fields(plan, {"dens": m._field_stack("dens")}, ["dens"])
    assert got["dens"].device.type == "cpu" and torch.equal(got["dens"], want["dens"])


def test_from_amr_refuses_a_foreign_placement(amr_file):
    """from_amr's sharding may only name the output's x placement over
    the active mesh's space axis; with no mesh any placement raises."""
    from fava_tpu_torch.mesh import FLASH as TorchAMR
    from fava_tpu_torch.parallel import Placement

    m = TorchAMR(amr_file, device="cpu")
    m.load()
    with pytest.raises(ValueError, match="is not the x placement"):
        m.from_amr(fields=["dens"], save_file=False, sharding=Placement(0, 0, 2))
