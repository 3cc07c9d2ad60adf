"""fava_tpu_torch's rank-local filtered KE flux, two-point and velocity
correlations, Helmholtz split, vorticity and dilatation of a slab-sharded
volume held to fava_tpu on the CPU, in float64.

The port runs in gloo worlds of 4 and 8 ranks, spawned once each
(module-scoped), as tests/test_torch_ranklocal_pdfs_spectra.py does.
Every rank loads conftest's 32^3 uniform file, a seeded (16, 8, 10) box
(ny != nx, even nz, domain lengths 1, 2, 1.5) and a seeded (16, 8, 9) box
(odd nz), both with a pressure field, through ``from_arrays`` under its
(d,) space mesh, so it holds the x-slab of each field. It runs the six
analyses of the slice (``filtered_kinetic_energy_flux`` with both
kernels and with pressure, ``two_point_correlation`` with the default
and another ``nbins``, ``velocity_correlations``,
``helmholtz_decomposition``, ``vorticity``, ``dilatation``) and saves
the results with the calls it made to ``runtime.gather_slabs`` and to
the kernel wrappers during each (recorded by wrapping them inside the
rank). The tests hold the results to fava_tpu unsharded and on
conftest's 8-device CPU mesh and to the port unsharded; the calls to no
``gather_slabs``, to the one-channel B6 once a rank on its x-slab of the
correlation half-volume for each two-point correlation, and to no other
kernel. The ranked bodies also run on ``SpaceRanks(d=d)`` (d = 2, 4, 8)
in this process against the single device. Spawned ranks import this
module, so jax and fava_tpu are imported only inside the tests.

Tolerances: every float result rtol 1e-9 with atol 1e-12 of its largest
magnitude (float64 on both sides, transforms in another decomposition
and sums in another order; a field value, line sample or flux mean near
zero is a difference of terms of the scale's size). The two-point shell
curve's empty shells (NaN) sit in the same places, and its counts are
exact: the static counts of the sharded path equal the single device's
binning counts.
"""

import os
import time
from datetime import timedelta

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
SHAPES = {"file": (32, 32, 32), "box": (16, 8, 10), "odd_z": (16, 8, 9)}
RTOL = 1e-9
ATOL_OF_SCALE = 1e-12


def _inputs():
    """Seeded numpy inputs shared by the ranks and the references: boxes
    whose nx and ny divide 4 and 8, ny != nx, nz even and odd, with
    pressure."""
    rng = np.random.default_rng(21)

    def fields(shape):
        out = {"dens": 1.0 + 0.5 * rng.random(shape), "pres": 1.0 + rng.random(shape)}
        out.update({f"vel{a}": rng.standard_normal(shape) for a in "xyz"})
        return out

    return {"box": fields(SHAPES["box"]), "odd_z": fields(SHAPES["odd_z"])}


def _analyses(m, key):
    """(name, call) of every analysis of the slice on mesh ``m`` of the
    input ``key``, with its options (pressure where the input has it)."""
    runs = [("flux_gaussian", lambda: m.filtered_kinetic_energy_flux(cutoffs=(2.0, 4.0))),
            ("flux_sharp", lambda: m.filtered_kinetic_energy_flux(cutoffs=(2.0, 3.5),
                                                                  kernel="sharp")),
            ("two_point", lambda: m.two_point_correlation("dens")),
            ("two_point_nbins", lambda: m.two_point_correlation("velx", nbins=11)),
            ("velocity_correlations", lambda: m.velocity_correlations()),
            ("helmholtz", lambda: m.helmholtz_decomposition()),
            ("vorticity", lambda: m.vorticity()),
            ("dilatation", lambda: m.dilatation())]
    if key != "file":
        runs.append(("flux_pressure", lambda: m.filtered_kinetic_energy_flux(
            cutoffs=(1.5, 3.0), with_pressure=True)))
    return runs


CASES = [(key, name) for key in SHAPES for name, _ in _analyses(None, key)]
FIELD_RESULTS = ("helmholtz", "vorticity", "dilatation")


def _record(cuda_kernels, runtime):
    """Wrap the kernel wrappers of ``WRAPPED`` and ``runtime.gather_slabs``
    so that every call appends (name, shapes of its tensor arguments,
    whether its second argument is None, its ``kx0``)."""
    calls = []

    def wrap(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            shapes = [tuple(a.shape) for a in list(args) + list(kwargs.values())
                      if isinstance(a, torch.Tensor)]
            calls.append((name, shapes, len(args) > 1 and args[1] is None, kwargs.get("kx0")))
            return fn(*args, **kwargs)

        setattr(module, name, counted)

    for name in WRAPPED:
        wrap(cuda_kernels, name)
    wrap(runtime, "gather_slabs")
    return calls


def _scenarios(rank: int, world: int, uni_path: str):
    from fava_tpu_torch import parallel
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
        meshes = {"file": uni}
        for key in ("box", "odd_z"):
            meshes[key] = FlashUniform.from_arrays(inp[key], domain_bounds=BOX_BOUNDS,
                                                   device="cpu")
        for key, m in meshes.items():
            runs = {}
            for name, fn in _analyses(m, key):
                calls.clear()
                runs[name] = (fn(), list(calls))
            out[key] = {"sharded": m._dmesh is mesh, "runs": runs,
                        "slab_shapes": {k: tuple(v.shape) for k, v in m._data.items()}}
    return out


def _rank_main(rank: int, world: int, store: str, workdir: str, uni_path: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{store}",
        rank=rank,
        world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_SECONDS),
    )
    try:
        out = _scenarios(rank, world, uni_path)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_world(world: int, workdir, uni_path):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main,
        args=(world, str(workdir / "store"), str(workdir), str(uni_path)),
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
def four(tmp_path_factory, uniform_file_32):
    return _run_world(4, tmp_path_factory.mktemp("ranklocal_spectral4"), uniform_file_32)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, uniform_file_32):
    return _run_world(8, tmp_path_factory.mktemp("ranklocal_spectral8"), uniform_file_32)


def _world(request, name):
    return request.getfixturevalue(name)


@pytest.fixture(scope="module")
def port_whole(uniform_file_32):
    """The port's results on one device."""
    from fava_tpu_torch.mesh import FlashUniform

    uni = FlashUniform(uniform_file_32, device="cpu")
    uni.load()
    inp = _inputs()
    meshes = {"file": uni}
    for key in ("box", "odd_z"):
        meshes[key] = FlashUniform.from_arrays(inp[key], domain_bounds=BOX_BOUNDS, device="cpu")
    return {key: {name: fn() for name, fn in _analyses(m, key)} for key, m in meshes.items()}


@pytest.fixture(scope="module")
def fava(uniform_file_32, eight_device_mesh):
    """fava_tpu's results, unsharded and under its 8-device mesh."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    inp = _inputs()

    def results():
        uni = FlashUniform(uniform_file_32)
        uni.load()
        meshes = {"file": uni}
        for key in ("box", "odd_z"):
            meshes[key] = FlashUniform.from_arrays(inp[key], domain_bounds=BOX_BOUNDS)
        return {key: {n: fn() for n, fn in _analyses(m, key)} for key, m in meshes.items()}

    out = {"one": results()}
    with use_mesh(eight_device_mesh):
        out["eight"] = results()
    return out


def _close(got, want, what=""):
    """Nested dicts of arrays and floats held to each other: rtol RTOL,
    atol ATOL_OF_SCALE of each array's largest finite magnitude, NaN in
    the same places."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    finite = want[np.isfinite(want)]
    scale = float(np.abs(finite).max()) if finite.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_SCALE * scale, equal_nan=True,
                               err_msg=what)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_no_field_is_gathered(request, world):
    """No analysis of the slice calls ``gather_slabs``, and every rank
    still holds its x-slab of every field afterwards."""
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
    """Each two-point correlation launches the one-channel B6 exactly once
    a rank, on its (nx/d, ny, nz//2+1) x-slab of the correlation
    half-volume at kx0 = r nx/d, and no other kernel (no K3, B4 or B10);
    the flux, the velocity correlations and the three field analyses
    launch none."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for key, (nx, ny, nz) in SHAPES.items():
            b6 = [("shell_bin_values_rfft_chunk", [(nx // d, ny, nz // 2 + 1)], True,
                   r["rank"] * (nx // d))]
            for name, (_out, calls) in r[key]["runs"].items():
                assert calls == (b6 if name.startswith("two_point") else []), (key, name)


@pytest.mark.parametrize("world", ["four", "eight"])
@pytest.mark.parametrize("key,name", CASES)
def test_slice_matches_fava_tpu(request, world, key, name, fava, port_whole):
    """Each analysis of the slice on every rank against fava_tpu on one
    device and on 8 and against the port on one device (module
    docstring: the tolerances)."""
    refs = {"fava_tpu": fava["one"][key][name], "fava_tpu 8 devices": fava["eight"][key][name],
            "port": port_whole[key][name]}
    for r in _world(request, world):
        got = r[key]["runs"][name][0]
        for what, ref in refs.items():
            _close(got, ref, f"rank {r['rank']} {key} {name} vs {what}")


@pytest.mark.parametrize("world", ["four", "eight"])
def test_fields_are_whole_and_equal_on_every_rank(request, world):
    """The Helmholtz parts, vorticity and dilatation come back as whole
    numpy volumes, bit for bit the same on every rank."""
    ranks = _world(request, world)
    for key, shape in SHAPES.items():
        for name, count in zip(FIELD_RESULTS, (6, 3, 1)):
            want = list(_leaves(ranks[0][key]["runs"][name][0]))
            for r in ranks:
                got = list(_leaves(r[key]["runs"][name][0]))
                assert len(got) == len(want) == count, (key, name)
                for g, w in zip(got, want):
                    assert isinstance(g, np.ndarray) and g.shape == shape, (key, name)
                    np.testing.assert_array_equal(g, w, err_msg=f"{key} {name}")


def _leaves(x):
    """The arrays of a nested dict, in key order."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    else:
        yield x


def _box_tensors(key):
    inp = _inputs()[key]
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _ranked_pairs(d, key):
    """(name, ranked body on d virtual ranks' x-slabs, single-device
    result) of each analysis of the slice on the input ``key``."""
    from fava_tpu_torch.ops import coarse_grain, twopoint, velocity
    from fava_tpu_torch.parallel import SpaceRanks

    t = _box_tensors(key)
    vels = [t[f"vel{a}"] for a in "xyz"]
    lengths = (1.0, 2.0, 1.5)
    ranks, one = SpaceRanks(d=d), SpaceRanks()
    n = int(vels[0].shape[0]) // d

    def cut(x):
        return [x[r * n : (r + 1) * n] for r in range(d)]

    slabs = [list(v) for v in zip(*(cut(v) for v in vels))]

    def joined(per_slab):
        """The x-slabs of each field of a ranked body, joined."""
        first = per_slab[0]
        if isinstance(first, dict):
            return {k: joined([s[k] for s in per_slab]) for k in first}
        if isinstance(first, tuple):
            return tuple(joined([s[i] for s in per_slab]) for i in range(len(first)))
        return torch.cat(per_slab)

    def flux(kernel, pres):
        return lambda r, vs, c: coarse_grain.filtered_ke_flux_ranked(
            vs, r, c(t["dens"]), c(t["pres"]) if pres else None, (1.5, 3.0), kernel, lengths)

    bodies = {
        "helmholtz": lambda r, vs, c: joined(velocity.helmholtz_decompose_ranked(vs, r, lengths)),
        "vorticity": lambda r, vs, c: joined(velocity.vorticity_ranked(vs, r, lengths)),
        "dilatation": lambda r, vs, c: joined(velocity.dilatation_ranked(vs, r, lengths)),
        "flux_gaussian_pressure": flux("gaussian", True),
        "flux_sharp": flux("sharp", False),
        "two_point": lambda r, vs, c: twopoint._scalar_corr(c(t["dens"]), r, 5),
        "velocity_correlations": lambda r, vs, c: twopoint._velocity_corr(vs, r),
    }
    return {name: (body(ranks, slabs, cut), body(one, [vels], lambda x: [x]))
            for name, body in bodies.items()}


RANKED = ("helmholtz", "vorticity", "dilatation", "flux_gaussian_pressure", "flux_sharp",
          "two_point", "velocity_correlations")


def _as_numpy(x):
    if isinstance(x, dict):
        return {k: _as_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return {str(i): _as_numpy(v) for i, v in enumerate(x)}
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("key", ["box", "odd_z"])
def test_virtual_ranks_join_as_one_device(d, key):
    """The ranked bodies of the slice on ``SpaceRanks(d=d)``'s x-slabs
    equal the single device's (``SpaceRanks()``) within the module's
    tolerances; the two-point correlation's shell counts exactly (its
    packed [variance, counts, sums, lines]: the static counts of the
    one-channel B6 path against the single device's binning counts, even
    and odd nz)."""
    nbins = 5
    for name, (got, want) in _ranked_pairs(d, key).items():
        if name == "two_point":
            np.testing.assert_array_equal(got[1 : 1 + nbins].numpy(), want[1 : 1 + nbins].numpy())
        _close(_as_numpy(got), _as_numpy(want), f"{d} virtual ranks {key} {name}")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_virtual_ranks_launch_b6_once_a_rank(d, monkeypatch):
    """On d virtual ranks the two-point correlation bins each rank's x-slab
    of the correlation half-volume once with the one-channel B6 at its
    row offset, and nothing else; on one device it takes the scalar
    binning (K3 + B4 for even x and y)."""
    from fava_tpu_torch.ops import cuda_kernels, twopoint
    from fava_tpu_torch.parallel import SpaceRanks

    calls = []
    for name in WRAPPED:
        fn = getattr(cuda_kernels, name)
        monkeypatch.setattr(cuda_kernels, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append((_n, k.get("kx0")))
                            or _f(*a, **k))
    f = _box_tensors("box")["dens"]
    n = int(f.shape[0]) // d
    twopoint._scalar_corr([f[r * n : (r + 1) * n] for r in range(d)], SpaceRanks(d=d), 4)
    assert calls == [("shell_bin_values_rfft_chunk", r * n) for r in range(d)]
    calls.clear()
    twopoint._scalar_corr([f], SpaceRanks(), 4)
    assert [c[0] for c in calls] == ["shell_bin_sums_rfft_scalar", "fold_quadrants_pair",
                                     "shell_bin_values_folded_1ch"]


MESH_ENTRIES = {
    "helmholtz_decompose": lambda v, m: _ops("velocity").helmholtz_decompose(v, v, mesh=m),
    "vorticity": lambda v, m: _ops("velocity").vorticity(v, v, mesh=m),
    "dilatation": lambda v, m: _ops("velocity").dilatation(v, v, mesh=m),
    "filtered_ke_flux": lambda v, m: _ops("coarse_grain").filtered_ke_flux(v, v, mesh=m),
    "two_point_correlation": lambda v, m: _ops("twopoint").two_point_correlation(v, mesh=m),
    "velocity_correlations": lambda v, m: _ops("twopoint").velocity_correlations(v, v, mesh=m),
}


def _ops(name):
    import importlib

    return importlib.import_module(f"fava_tpu_torch.ops.{name}")


@pytest.mark.parametrize("entry", sorted(MESH_ENTRIES))
def test_sharded_entries_need_a_3d_volume(entry):
    """A mesh with 2D fields raises a named ValueError, as the sharded
    spectra do."""
    v = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="needs a 3D volume"):
        MESH_ENTRIES[entry](v, object())
