"""fava_tpu_torch's rank-local flame surface, uniform and AMR projections,
AMR-side PDFs and point sampling of a slab-sharded volume held to fava_tpu
on the CPU, in float64.

The port runs in gloo worlds of 4 and 8 ranks, spawned once each
(module-scoped), as tests/test_torch_ranklocal_spectral.py does. Every
rank loads conftest's 32^3 uniform file (which carries flam), a seeded
(16, 8, 10) box (ny != nx, domain lengths 1, 2, 1.5) and a seeded (8, 8, 6)
box (one x-plane a rank at d = 8), both with a flam in [0, 1], through
``from_arrays`` under its (d,) space mesh, so it holds the x-slab of each
field; and conftest's AMR file, collapsed by ``from_amr(save_file=False)``
under the mesh to a 64^3 volume that each rank holds as its x-slab. It
runs ``flame_surface`` along each axis, the projections of dens along
each axis and of velx weighted by dens along x and z on both mesh
classes, the AMR mesh's ``pdf1d``, ``pdf2d``, ``binned_statistic`` and
``density_pdf`` with each weight, ``sample_fields`` at seeded points and
at points on slab boundaries, on the max faces and outside the domain,
``get_point_data``, and the pipeline's flam check, and saves the results
with the calls it made to ``runtime.gather_slabs`` and to the kernel
wrappers during each (recorded by wrapping them inside the rank). The
tests hold the results to fava_tpu unsharded and on conftest's 8-device
CPU mesh and to the port unsharded; the calls to no ``gather_slabs``, to
B8 (``pdf2d_counts``) exactly once a rank on its slab for each ``pdf2d``,
and to no other kernel. The ranked bodies also run on
``SpaceRanks(d=d)`` (d = 2, 4, 8) in this process against the single
device. Spawned ranks import this module, so jax and fava_tpu are
imported only inside the tests.

Tolerances: every float result rtol 1e-9 with atol 1e-12 of its largest
magnitude (float64 on both sides, sums in another order); the binned
standard deviation atol 1e-12 of its largest value. Counts, coordinates,
sampled values, volume fractions and found flags are exact, with one rule
for the density PDF: its default edges come from float64 means whose sums
follow the slabs, so a sample within EDGE_TOL of the range of an edge may
fall in the neighbouring bin. Such samples are counted, and the counts
may differ by twice that number at most (each moved sample leaves one bin
for another; of weight sums, by twice that many of the largest bin).
"""

import os
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

JOIN_SECONDS = 300  # a hung world fails its tests, not the suite's limit
COLLECTIVE_SECONDS = 120

# Every kernel wrapper of the port: the ranks record each call.
WRAPPED = ("row_moments_volume", "centered_row_moments", "fold_quadrants_pair",
           "shell_bin_values_folded", "shell_bin_values_folded_1ch", "shell_bin_sums_rfft_scalar",
           "shell_bin_sums_unfolded", "shell_bin_values_rfft_chunk",
           "shell_bin_sums_folded_onepass", "shell_bin_values_folded_rows",
           "shell_bin_powers_fused", "zy_rfft_planar", "block_row_moments",
           "block_centered_row_moments", "regrid_fields", "pdf2d_counts")
BOX_BOUNDS = [[0.0, 1.0], [0.0, 2.0], [0.0, 1.5]]
SHAPES = {"file": (32, 32, 32), "box": (16, 8, 10), "thin": (8, 8, 6), "amr": (64, 64, 64)}
AMR_FIELDS = ["dens", "velx"]
WEIGHTS = ("volume", "mass", None)
RTOL = 1e-9
ATOL_OF_SCALE = 1e-12
EDGE_TOL = 1e-12


def _inputs():
    """Seeded numpy inputs shared by the ranks and the references: boxes
    whose nx and ny divide 4 and 8, ny != nx, with a flam front in
    [0, 1] along x."""
    rng = np.random.default_rng(22)

    def fields(shape):
        x = (np.arange(shape[0]) + 0.5) / shape[0]
        front = 0.5 + 0.1 * rng.standard_normal(shape[1:])
        flam = 0.5 * (1.0 + np.tanh((x[:, None, None] - front[None]) / 0.15))
        out = {"dens": 1.0 + 0.5 * rng.random(shape), "velx": rng.standard_normal(shape),
               "flam": np.clip(flam + 0.02 * rng.standard_normal(shape), 0.0, 1.0)}
        return out

    return {"box": fields(SHAPES["box"]), "thin": fields(SHAPES["thin"])}


def _points():
    """Seeded points in the unit box, points on every x boundary of the
    slabs at d = 4 and 8 (x = k/8), on the max faces, and outside the
    domain (not found: sampled where ``locate_points`` puts them)."""
    rng = np.random.default_rng(23)
    inside = rng.random((40, 3))
    bounds = np.column_stack([np.arange(9) / 8.0, rng.random((9, 2))])
    faces = np.array([[1.0, 0.3, 0.7], [0.5, 1.0, 1.0], [1.0, 1.0, 1.0], [0.2, 0.6, 1.0]])
    outside = np.array([[1.5, 0.5, 0.5], [-0.2, 0.5, 0.5], [0.5, 2.0, 0.5], [0.3, 0.4, -1.0]])
    return np.concatenate([inside, bounds, faces, outside])


# Points whose one cell get_point_data reads (indices into _points()).
POINT_DATA = (0, 7, 40, 41, 48, 49, 51)


def _point_data(m, via_host=False):
    """``get_point_data`` of dens at the cells that ``get_coord_index``
    finds for the points POINT_DATA; with ``via_host``, the same cells of
    ``host_data("dens")`` as a block stack (fava_tpu's ``get_point_data``
    indexes a block axis that a single-volume mesh's data lacks, and
    raises IndexError there: test_point_data_of_an_amr_tree holds the
    two on a tree)."""
    pts = _points()
    host = None
    if via_host:
        host = np.asarray(m.host_data("dens"))
        host = host.reshape((-1,) + host.shape[-3:])
    out = []
    for i in POINT_DATA:
        idx, blk = m.get_coord_index(pts[i], None)
        out.append(m.get_point_data(blk, idx, "dens") if host is None else host[(blk, *idx)])
    return np.array(out)


def _uniform_analyses(m, key, via_host=False):
    """(name, call) of every analysis of the slice on the uniform mesh
    ``m`` of the input ``key`` (``via_host``: ``_point_data``'s)."""
    runs = [(f"flame_{a}", lambda a=a: m.flame_surface(field="flam", axis=a)) for a in range(3)]
    runs += _projections(m)
    if key == "file":
        runs += [("sample", lambda: m.sample_fields(_points(), ["dens", "flam"])),
                 ("point_data", lambda: _point_data(m, via_host))]
    return runs


def _projections(m):
    runs = [(f"proj_dens_{a}", lambda a=a: m.projection("dens", axis=a)) for a in range(3)]
    runs += [(f"proj_velx_dens_{a}", lambda a=a: m.projection("velx", axis=a, weight="dens"))
             for a in (0, 2)]
    return runs


def _amr_analyses(m, via_host=False):
    """(name, call) of every analysis of the slice on the collapsed AMR
    mesh ``m`` (``via_host``: ``_point_data``'s)."""
    runs = []
    for w in WEIGHTS:
        runs += [(f"pdf1d_{w}", lambda w=w: m.pdf1d("velx", weight=w, nbins=24)),
                 (f"pdf2d_{w}", lambda w=w: m.pdf2d("dens", "velx", weight=w, nbins=(12, 10))),
                 (f"binned_{w}", lambda w=w: m.binned_statistic("dens", "velx", weight=w,
                                                                nbins=12)),
                 (f"density_pdf_{w}", lambda w=w: m.density_pdf(weight=w, nbins=40))]
    runs += [("pdf1d_range", lambda: m.pdf1d("dens", nbins=16, vrange=(0.0, 2.0)))]
    runs += _projections(m)
    runs += [("sample", lambda: m.sample_fields(_points(), AMR_FIELDS)),
             ("point_data", lambda: _point_data(m, via_host))]
    return runs


def _analyses(m, key, via_host=False):
    if key == "amr":
        return _amr_analyses(m, via_host)
    return _uniform_analyses(m, key, via_host)


CASES = [(key, name) for key in SHAPES for name, _ in _analyses(None, key)]


def _record(cuda_kernels, runtime):
    """Wrap the kernel wrappers of ``WRAPPED`` and ``runtime.gather_slabs``
    so that every call appends (name, shapes of its tensor arguments,
    whether B8 counts: its ``weights`` None)."""
    calls = []

    def wrap(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            shapes = [tuple(a.shape) for a in list(args) + list(kwargs.values())
                      if isinstance(a, torch.Tensor)]
            calls.append((name, shapes, kwargs.get("weights") is None))
            return fn(*args, **kwargs)

        setattr(module, name, counted)

    for name in WRAPPED:
        wrap(cuda_kernels, name)
    wrap(runtime, "gather_slabs")
    return calls


def _flam_check(mesh):
    """The pipeline's flam check on ``mesh``: (answer, field chosen)."""
    from fava_tpu_torch.pipeline.pipeline import Pipeline

    p = SimpleNamespace(model=SimpleNamespace(mesh=mesh))
    return Pipeline._flam_or_rpv1(p), p.flam


def _scenarios(rank: int, world: int, uni_path: str, amr_path: str):
    from fava_tpu_torch import parallel
    from fava_tpu_torch.mesh import FLASH as AMR
    from fava_tpu_torch.mesh import FlashUniform
    from fava_tpu_torch.ops import cuda_kernels
    from fava_tpu_torch.parallel import runtime

    calls = _record(cuda_kernels, runtime)
    inp = _inputs()
    mesh = parallel.make_device_mesh(device="cpu")
    out = {"rank": rank}
    with parallel.use_mesh(mesh):
        uni = FlashUniform(uni_path, device="cpu")
        uni.load()
        amr = AMR(amr_path, device="cpu")
        amr.load()
        amr.from_amr(fields=AMR_FIELDS, save_file=False)
        meshes = {"file": uni, "amr": amr}
        for key in ("box", "thin"):
            meshes[key] = FlashUniform.from_arrays(inp[key], domain_bounds=BOX_BOUNDS,
                                                   device="cpu")
        for key, m in meshes.items():
            runs = {}
            for name, fn in _analyses(m, key):
                calls.clear()
                runs[name] = (fn(), list(calls))
            out[key] = {"sharded": m._dmesh is mesh, "runs": runs,
                        "slab_shapes": {k: tuple(v.shape[-3:]) for k, v in m._data.items()}}
        out["flam_check"] = {}
        for key in ("file", "amr"):
            calls.clear()
            out["flam_check"][key] = (_flam_check(meshes[key]), list(calls))
    return out


def _rank_main(rank: int, world: int, store: str, workdir: str, uni_path: str, amr_path: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{store}",
        rank=rank,
        world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_SECONDS),
    )
    try:
        out = _scenarios(rank, world, uni_path, amr_path)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_world(world: int, workdir, uni_path, amr_path):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main,
        args=(world, str(workdir / "store"), str(workdir), str(uni_path), str(amr_path)),
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
def four(tmp_path_factory, uniform_file_32, amr_file):
    return _run_world(4, tmp_path_factory.mktemp("ranklocal_surface4"), uniform_file_32, amr_file)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, uniform_file_32, amr_file):
    return _run_world(8, tmp_path_factory.mktemp("ranklocal_surface8"), uniform_file_32, amr_file)


def _world(request, name):
    return request.getfixturevalue(name)


def _meshes(uniform_cls, amr_cls, uni_path, amr_path, **kw):
    """The four meshes of the slice, unsharded or under the active mesh."""
    inp = _inputs()
    uni = uniform_cls(uni_path, **kw)
    uni.load()
    amr = amr_cls(amr_path, **kw)
    amr.load()
    amr.from_amr(fields=AMR_FIELDS, save_file=False)
    out = {"file": uni, "amr": amr}
    for key in ("box", "thin"):
        out[key] = uniform_cls.from_arrays(inp[key], domain_bounds=BOX_BOUNDS, **kw)
    return out


@pytest.fixture(scope="module")
def port_whole(uniform_file_32, amr_file):
    """The port's results on one device, and its float64 dens fields."""
    from fava_tpu_torch.mesh import FLASH as AMR
    from fava_tpu_torch.mesh import FlashUniform

    meshes = _meshes(FlashUniform, AMR, uniform_file_32, amr_file, device="cpu")
    out = {key: {name: fn() for name, fn in _analyses(m, key)} for key, m in meshes.items()}
    out["dens"] = meshes["amr"].data("dens").numpy()
    return out


@pytest.fixture(scope="module")
def fava(uniform_file_32, amr_file, eight_device_mesh):
    """fava_tpu's results, unsharded and under its 8-device mesh."""
    from fava_tpu.mesh import FLASH as AMR
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    def results():
        meshes = _meshes(FlashUniform, AMR, uniform_file_32, amr_file)
        return {key: {n: fn() for n, fn in _analyses(m, key, via_host=True)}
                for key, m in meshes.items()}

    out = {"one": results()}
    with use_mesh(eight_device_mesh):
        out["eight"] = results()
    return out


def _close(got, want, what="", skip=()):
    """Nested dicts, tuples and arrays held to each other: rtol RTOL, atol
    ATOL_OF_SCALE of each array's largest finite magnitude, NaN in the
    same places; booleans and integers exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            if k not in skip:
                _close(got[k], want[k], f"{what}/{k}")
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}/{i}")
        return
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)
        return
    got = np.asarray(got, dtype=np.float64)
    want = want.astype(np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    finite = want[np.isfinite(want)]
    scale = float(np.abs(finite).max()) if finite.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_SCALE * scale, equal_nan=True,
                               err_msg=what)


def _near_edges(name, ref, dens) -> int:
    """The samples of the density PDF ``name`` within EDGE_TOL of the
    range of an edge of ``ref``, from the float64 dens field (the
    collapsed mesh's cells share one volume, so the volume-weighted mean
    is the plain one)."""
    mean = (dens * dens).sum() / dens.sum() if name.endswith("mass") else dens.mean()
    s = np.sort(np.log(dens / mean).ravel())
    edges = ref["edges"]
    tol = EDGE_TOL * (abs(edges[0]) + abs(edges[-1]))
    lo = np.searchsorted(s, edges - tol, side="left")
    hi = np.searchsorted(s, edges + tol, side="right")
    return int((hi - lo).sum())


def _hold(key, name, got, want, dens, what):
    """One result of the slice held to a reference (module docstring)."""
    if name in ("sample", "point_data"):
        if name == "sample":
            for g, w in zip(got, want):
                if isinstance(w, dict):
                    assert sorted(g) == sorted(w), what
                    for k in w:
                        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=what)
                else:
                    np.testing.assert_array_equal(g, np.asarray(w), err_msg=what)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
        return
    if key != "amr" or name.startswith("proj"):
        _close(got, want, what)
        return
    weighted = name.endswith(("volume", "mass")) and not name.startswith("binned")
    if name.startswith("binned"):
        np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=what)
        scale = np.nanmax(np.abs(want["std"]))
        np.testing.assert_allclose(got["std"], want["std"], rtol=RTOL, atol=1e-12 * scale,
                                   err_msg=f"{what}/std")
        _close(got, want, what, skip=("std",))
        return
    if name.startswith("density_pdf"):
        near = _near_edges(name, want, dens)
        moved = float(np.abs(np.asarray(got["counts"]) - np.asarray(want["counts"])).sum())
        bound = 2.0 * near * (np.abs(want["counts"]).max() if weighted else 1.0)
        if not near:
            bound = RTOL * float(np.abs(want["counts"]).sum()) if weighted else 0.0
        assert moved <= bound, f"{what}: counts moved {moved}, {near} samples near an edge"
        _close(got, want, what, skip=("counts", "pdf"))
        return
    if not weighted:
        np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=what)
    _close(got, want, what)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_no_field_is_gathered(request, world):
    """No analysis of the slice calls ``gather_slabs``, and every rank
    still holds its x-slab of every field afterwards (the collapsed AMR
    mesh's as one block)."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for key, (nx, ny, nz) in SHAPES.items():
            assert r[key]["sharded"], key
            assert set(r[key]["slab_shapes"].values()) == {(nx // d, ny, nz)}, key
            for name, (_out, calls) in r[key]["runs"].items():
                assert not [c for c in calls if c[0] == "gather_slabs"], (key, name)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_kernels_of_the_slice(request, world):
    """Each ``pdf2d`` of the collapsed AMR mesh launches B8 exactly once a
    rank, on its (1, nx/d, ny, nz) slab's samples: weighted by the cell
    volume or the mass, counted without a weight; no other analysis of
    the slice launches a kernel."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for key, (nx, ny, nz) in SHAPES.items():
            slab = (1, nx // d, ny, nz)
            for name, (_out, calls) in r[key]["runs"].items():
                if name.startswith("pdf2d"):
                    counted = name.endswith("None")
                    want = [("pdf2d_counts", [slab] * (2 if counted else 3), counted)]
                else:
                    want = []
                assert calls == want, (key, name)


@pytest.mark.parametrize("world", ["four", "eight"])
@pytest.mark.parametrize("key,name", CASES)
def test_slice_matches_fava_tpu(request, world, key, name, fava, port_whole):
    """Each analysis of the slice on every rank against fava_tpu on one
    device and on 8 and against the port on one device (module
    docstring: the tolerances and the edge rule)."""
    refs = {"fava_tpu": fava["one"][key][name], "fava_tpu 8 devices": fava["eight"][key][name],
            "port": port_whole[key][name]}
    for r in _world(request, world):
        got = r[key]["runs"][name][0]
        for what, ref in refs.items():
            _hold(key, name, got, ref, port_whole["dens"],
                  f"rank {r['rank']} {key} {name} vs {what}")


@pytest.mark.parametrize("world", ["four", "eight"])
def test_amr_counts_equal_to_the_unsharded_port(request, world, port_whole):
    """The counts of the AMR mesh's ``pdf1d``, ``pdf2d`` and
    ``binned_statistic`` equal the unsharded port's bit for bit (their
    edges come from exact MIN/MAX joins), the weight sums within RTOL;
    the density PDF's as the edge rule allows, here exactly: no sample
    lies near an edge."""
    for r in _world(request, world):
        for name, (got, _calls) in r["amr"]["runs"].items():
            if name.startswith(("proj", "sample", "point")):
                continue
            want = port_whole["amr"][name]
            if name.startswith("density_pdf"):
                assert _near_edges(name, want, port_whole["dens"]) == 0, name
            if name.endswith(("volume", "mass")) and not name.startswith("binned"):
                np.testing.assert_allclose(got["counts"], want["counts"], rtol=RTOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=name)


def test_point_data_of_an_amr_tree(amr_file):
    """On the AMR tree (before any collapse) ``get_point_data`` reads the
    cell that fava_tpu's reads, at every found point of the slice, and
    ``sample_fields`` gives fava_tpu's values, volume fractions and found
    flags."""
    import fava_tpu
    from fava_tpu_torch.mesh import FLASH as AMR

    t = AMR(amr_file, device="cpu")
    t.load()
    j = fava_tpu.mesh.FLASH(amr_file)
    j.load()
    np.testing.assert_array_equal(_point_data(t), _point_data(j))
    np.testing.assert_array_equal(_point_data(t), _point_data(j, via_host=True))
    got, want = t.sample_fields(_points(), AMR_FIELDS), j.sample_fields(_points(), AMR_FIELDS)
    for k in AMR_FIELDS:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("world", ["four", "eight"])
def test_results_equal_on_every_rank(request, world):
    """Every rank returns the same result of each analysis, bit for bit."""
    ranks = _world(request, world)
    for key, name in CASES:
        want = list(_leaves(ranks[0][key]["runs"][name][0]))
        for r in ranks[1:]:
            got = list(_leaves(r[key]["runs"][name][0]))
            assert len(got) == len(want), (key, name)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r['rank']} {key} {name}")


def _leaves(x):
    """The arrays and numbers of a nested result, in key order."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    else:
        yield np.asarray(x)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_flam_check_gathers_nothing(request, world):
    """The pipeline's flam check on the sharded uniform file finds flam,
    and on the collapsed AMR mesh (dens and velx only) finds neither
    field, as ``data(...) is not None`` answered; it calls no
    ``gather_slabs`` and no kernel."""
    for r in _world(request, world):
        assert r["flam_check"]["file"] == ((True, "flam"), [])
        assert r["flam_check"]["amr"] == ((False, "flam"), [])


def test_flam_check_agrees_with_data(uniform_file_32):
    """On one device the flam check answers as ``data(...) is not None``
    would, for a file with flam and a mesh without flam or rpv1."""
    from fava_tpu_torch.mesh import FlashUniform

    uni = FlashUniform(uniform_file_32, device="cpu")
    uni.load()
    assert _flam_check(uni) == (uni.data("flam") is not None, "flam") == (True, "flam")
    box = FlashUniform.from_arrays({"dens": np.ones((4, 4, 4))}, device="cpu")
    assert _flam_check(box) == (False, "flam")
    assert box.data("rpv1") is None and box.data("flam") is None


def _box_tensors(key):
    return {k: torch.from_numpy(v) for k, v in _inputs()[key].items()}


def _cut(x, d, dim=0):
    n = int(x.shape[dim]) // d
    return [x.narrow(dim, r * n, n) for r in range(d)]


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("key", ["box", "thin"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_virtual_ranks_flame_surface(d, key, axis):
    """``flame_surface_ranked`` on ``SpaceRanks(d=d)``'s x-slabs (one
    plane a rank for the thin box at d = 8, whose first and last ranks
    take the one-sided edge) equals the single device's within the
    module's tolerances, and the ops entry without a mesh."""
    from fava_tpu_torch.ops import flame
    from fava_tpu_torch.parallel import SpaceRanks

    c = _box_tensors(key)["flam"]
    shape = tuple(c.shape)
    deltas = [(b[1] - b[0]) / n for b, n in zip(BOX_BOUNDS, shape)]
    got = flame.flame_surface_ranked(_cut(c, d), SpaceRanks(d=d), deltas, shape, axis)
    want = flame.flame_surface_ranked([c], SpaceRanks(), deltas, shape, axis)
    _close(got, want, f"{d} virtual ranks {key} axis {axis}")
    _close(flame.flame_surface(c, deltas, axis=axis), want, "entry")


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("key", ["box", "thin"])
@pytest.mark.parametrize("axis,weighted", [(0, False), (1, False), (2, False), (0, True),
                                           (2, True)])
def test_virtual_ranks_projection(d, key, axis, weighted):
    """``project_uniform_ranked`` on ``SpaceRanks(d=d)``'s x-slabs equals
    the single device's within the module's tolerances (along x one SUM
    of the partial line sums; along y or z the rows joined), and the map
    of a weighted projection along y or z bit for bit."""
    from fava_tpu_torch.ops import projection
    from fava_tpu_torch.parallel import SpaceRanks

    t = _box_tensors(key)
    deltas = [(b[1] - b[0]) / n for b, n in zip(BOX_BOUNDS, t["dens"].shape)]
    w = t["dens"] if weighted else None
    got = projection.project_uniform_ranked(_cut(t["velx"], d), SpaceRanks(d=d), deltas, axis,
                                            None if w is None else _cut(w, d))
    want = projection.project_uniform_ranked([t["velx"]], SpaceRanks(), deltas, axis,
                                             None if w is None else [w])
    if axis:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    _close(got.numpy(), want.numpy(), f"{d} virtual ranks {key} axis {axis}")
    _close(projection.project_uniform(t["velx"], deltas, axis=axis, weight=w), want.numpy(),
           "entry")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_virtual_ranks_sampling(d):
    """``sample_points_ranked`` on ``SpaceRanks(d=d)``'s x-slabs of a 4D
    stack gives the single device's values bit for bit, points on the
    slab boundaries and on the last x cell included."""
    from fava_tpu_torch.ops import volume
    from fava_tpu_torch.parallel import SpaceRanks

    t = _box_tensors("box")
    stacks = [t["dens"][None], t["velx"][None]]
    rng = np.random.default_rng(5)
    nx = stacks[0].shape[1]
    cells = np.column_stack([np.concatenate([rng.integers(0, nx, 30), np.arange(0, nx, 2)]),
                             rng.integers(0, 8, 30 + nx // 2), rng.integers(0, 10, 30 + nx // 2)])
    blk = np.zeros(len(cells), dtype=np.int64)
    got = volume.sample_points_ranked([_cut(s, d, 1) for s in stacks], SpaceRanks(d=d), blk, cells)
    want = volume.sample_points_ranked([[s] for s in stacks], SpaceRanks(), blk, cells)
    direct = torch.stack([s[0][tuple(torch.as_tensor(cells).T)] for s in stacks])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(want, direct, rtol=0, atol=0)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("weight", WEIGHTS)
def test_virtual_ranks_amr_stack_pdfs(d, weight):
    """The ranked PDFs take a (1, nx/d, ny, nz) stack slab and its weights
    as they are: ``pdf2d_ranked`` and ``binned_statistic_ranked`` on d
    virtual ranks' slabs of a 4D stack equal the single device's, counts
    exactly and weight sums within RTOL."""
    from fava_tpu_torch.ops import volume
    from fava_tpu_torch.parallel import SpaceRanks

    t = _box_tensors("box")
    x, y = t["dens"][None], t["velx"][None]
    w = None if weight is None else (torch.full_like(x, 0.25) if weight == "volume" else 0.25 * x)
    ws = None if w is None else _cut(w, d, 1)
    ranks = SpaceRanks(d=d)
    got = volume.pdf2d_ranked(_cut(x, d, 1), _cut(y, d, 1), ranks, nbins=(7, 9), weights=ws)
    want = volume.pdf2d_ranked([x], [y], SpaceRanks(), nbins=(7, 9),
                               weights=None if w is None else [w])
    _close(got, want, f"pdf2d {weight}")
    got = volume.binned_statistic_ranked(_cut(x, d, 1), _cut(y, d, 1), ranks, nbins=6, weights=ws)
    want = volume.binned_statistic_ranked([x], [y], SpaceRanks(), nbins=6,
                                          weights=None if w is None else [w])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    _close(got, want, f"binned {weight}", skip=("std",))


MESH_ENTRIES = {
    "flame surface": lambda v, m: _ops("flame").flame_surface(v, (1.0, 1.0), mesh=m),
    "projection": lambda v, m: _ops("projection").project_uniform(v, (1.0, 1.0), mesh=m),
}


def _ops(name):
    import importlib

    return importlib.import_module(f"fava_tpu_torch.ops.{name}")


@pytest.mark.parametrize("entry", sorted(MESH_ENTRIES))
def test_sharded_entries_need_a_3d_volume(entry):
    """A mesh with a 2D field raises a named ValueError, as the other
    sharded entries do (2D volumes are never sharded)."""
    v = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="needs a 3D volume"):
        MESH_ENTRIES[entry](v, object())
