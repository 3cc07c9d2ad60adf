"""fava_tpu_torch's device-mesh runtime, pencil FFT, sharded spectra and
sharded flagship step held to fava_tpu on the CPU, in float64.

The port runs its sharded paths in gloo worlds of 4 and 8 ranks, spawned
once each (module-scoped); every rank runs every scenario and saves its
results, and the tests here compare them with fava_tpu on the 8-device
CPU mesh of tests/conftest.py and on one device. Spawned ranks import
this module, so jax and fava_tpu are imported only inside the tests;
the ranks import torch and the port alone. Inputs are made from seeds
with numpy (``_inputs``), or are conftest's 32^3 synthetic uniform file.

Tolerances: the mirrors of tests/test_parallel.py and
tests/test_spectra.py keep theirs (spectra rtol 1e-9, atol 1e-18;
profiles rtol 1e-9/1e-10; structure functions rtol 1e-12; pfft3 rtol
1e-9, atol 1e-9; the pod step rtol 1e-8, atol 1e-12); the flagship step
against fava_tpu's mesh branch takes the pod step's. Shell counts exact.
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


def _inputs():
    """Seeded numpy inputs shared by the ranks and the references."""
    rng = np.random.default_rng(16)

    def fields(shape):
        return [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]

    return {
        "pfft": rng.standard_normal((16, 16, 16)),
        "fields": fields((16, 16, 16)),
        "batch": [np.stack(f) for f in zip(*[fields((16, 8, 12)) for _ in range(4)])],
        "odd_y": fields((8, 6, 8)),
        "arrays": fields((16, 16, 8)),
    }


def _named(f):
    return dict(zip(("dens", "velx", "vely", "velz"), f))


def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _scenarios(rank: int, world: int, uni_path: str, workdir: str):
    from fava_tpu_torch import flagship, parallel
    from fava_tpu_torch.mesh import FlashUniform
    from fava_tpu_torch.ops import cuda_kernels

    inp = _inputs()
    out = {"rank": rank}
    mesh = parallel.make_device_mesh(device="cpu")
    out["mesh_shape"] = tuple(mesh.shape)
    out["placements"] = (repr(parallel.volume_sharding(mesh)), repr(parallel.replicated(mesh)))
    before = parallel.get_mesh() is None
    with parallel.use_mesh(mesh):
        inside = parallel.get_mesh() is mesh
        uni = FlashUniform(uni_path, device="cpu")
        uni.load()
        out["slab"] = uni._slab("dens").numpy()
        out["ke"] = uni.kinetic_energy_spectra()
        out["flagship"] = uni.flagship_analysis(streamed=False)
        if world == 4:
            out["reynolds"] = uni.reynolds_stress()[1:]
            out["favre"] = uni.favre_profiles()
            out["fractal"] = uni.fractal_dimension(field="flam", contours=0.5)
            out["sf"] = uni.structure_functions(
                num_seps=4, num_points=64, sep_bounds=(0.1, 0.4), seed=2
            )
            out["scalar"] = uni.scalar_spectra("dens")["dens"]
            whole = FlashUniform.from_arrays(_named(inp["odd_y"]), device="cpu")
            out["odd_y"] = (whole._dmesh is None, tuple(whole._slab("dens").shape))
            out["odd_y_ke"] = whole.kinetic_energy_spectra()
            out["odd_y_flagship"] = whole.flagship_analysis(streamed=False)
            arr = FlashUniform.from_arrays(_named(inp["arrays"]), device="cpu")
            out["arrays"] = (arr._dmesh is mesh, tuple(arr._slab("dens").shape))
            out["arrays_ke"] = arr.kinetic_energy_spectra()
            saved = os.path.join(workdir, "rt_hdf5_uniform_0001")
            uni.save(saved, names=["dens", "velx"])
            uni.from_amr(save_file=False, fields=["dens", "velx"])
            out["saved"] = (saved, uni._dmesh is mesh, uni._slab("velx").numpy())
    out["use_mesh"] = (before, inside, parallel.get_mesh() is None)

    x = parallel.shard_volume(inp["pfft"], mesh)
    out["pfft3"] = parallel.pfft3(x, mesh).numpy()
    slabs = [parallel.shard_volume(a, mesh) for a in inp["fields"]]
    cuda_kernels.reset_launch_counts()
    out["step"] = _np(flagship.uniform_analysis_step(*slabs, mesh=mesh))

    if world == 4:
        try:
            parallel.make_device_mesh((2,), device="cpu")
        except ValueError as e:
            out["small_mesh"] = str(e)
        pod = parallel.make_device_mesh((2, 2), ("snap", "space"), device="cpu")
        s = int(pod.get_local_rank("snap"))
        local = [parallel.shard_volume(b[2 * s : 2 * s + 2], pod, axis=1) for b in inp["batch"]]
        out["pod"] = (s, _np(flagship.sharded_series_analysis_step(*local, mesh=pod)))
        out["pod_mesh"] = (parallel.is_pod_mesh(pod), parallel.snap_axis_size(pod),
                           parallel.space_axis_size(pod), parallel.device_axis_total(pod))
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
        out = _scenarios(rank, world, uni_path, workdir)
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
    return _run_world(4, tmp_path_factory.mktemp("world4"), uniform_file_32)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, uniform_file_32):
    return _run_world(8, tmp_path_factory.mktemp("world8"), uniform_file_32)


@pytest.fixture(scope="module")
def fava_uniform(uniform_file_32, eight_device_mesh):
    """fava_tpu's results on the 32^3 file, unsharded and on 8 devices."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    m0 = FlashUniform(uniform_file_32)
    m0.load()
    ref = {"ke": m0.kinetic_energy_spectra(), "flagship": m0.flagship_analysis(streamed=False)}
    with use_mesh(eight_device_mesh):
        m1 = FlashUniform(uniform_file_32)
        m1.load()
        ref["ke8"] = m1.kinetic_energy_spectra()
        ref["flagship8"] = m1.flagship_analysis(streamed=False)
    ref["whole"] = np.asarray(m0.data("dens"))
    ref["mesh"] = m0
    return ref


def _world(request, name):
    return request.getfixturevalue(name)


def _assert_spectra(got, want, rtol=1e-9, atol=1e-18):
    for key in ("total", "longitudinal", "transverse"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=key)


def _assert_step(got, want, rtol=1e-8, atol=1e-12):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["spectra_counts"], np.asarray(want["spectra_counts"]))
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=rtol, atol=atol,
                                   err_msg=key)


def test_use_mesh_context(four):
    for r in four:
        assert r["use_mesh"] == (True, True, True)
        assert r["mesh_shape"] == (4,)
        assert r["placements"] == ("[Shard(dim=0)]", "[Replicate()]")


@pytest.mark.parametrize("world", ["four", "eight"])
def test_sharded_uniform_load_and_spectra(request, world, fava_uniform):
    ranks = _world(request, world)
    d = len(ranks)
    whole = fava_uniform["whole"]
    for r in ranks:
        rows = whole.shape[0] // d
        np.testing.assert_array_equal(r["slab"], whole[r["rank"] * rows : (r["rank"] + 1) * rows])
        _assert_spectra(r["ke"], fava_uniform["ke"])
        _assert_spectra(r["ke"], fava_uniform["ke8"])


@pytest.mark.parametrize("world", ["four", "eight"])
def test_sharded_flagship_analysis_matches(request, world, fava_uniform):
    for r in _world(request, world):
        _assert_step(r["flagship"], fava_uniform["flagship"])
        _assert_step(r["flagship"], fava_uniform["flagship8"])


def test_sharded_profiles_match(four, fava_uniform):
    _, stress0, means0 = fava_uniform["mesh"].reynolds_stress()
    for r in four:
        stress1, means1 = r["reynolds"]
        for key in stress0:
            np.testing.assert_allclose(stress1[key], stress0[key], rtol=1e-9, err_msg=key)
        for key in means0:
            np.testing.assert_allclose(means1[key], means0[key], rtol=1e-10, err_msg=key)


def test_sharded_fractal_and_structfn_match(four, fava_uniform):
    m0 = fava_uniform["mesh"]
    fd0 = m0.fractal_dimension(field="flam", contours=0.5)
    sf0 = m0.structure_functions(num_seps=4, num_points=64, sep_bounds=(0.1, 0.4), seed=2)
    for r in four:
        np.testing.assert_allclose(
            r["fractal"]["flam"]["0.5"]["average fractal dimension"],
            fd0["flam"]["0.5"]["average fractal dimension"],
        )
        np.testing.assert_allclose(r["sf"]["longitudinal"]["2"], sf0["longitudinal"]["2"],
                                   rtol=1e-12)


def test_sharded_favre_match(four, fava_uniform):
    out0 = fava_uniform["mesh"].favre_profiles()
    for r in four:
        np.testing.assert_allclose(r["favre"]["mean_dens"], out0["mean_dens"], rtol=1e-10)
        for a in "xyz":
            np.testing.assert_allclose(
                r["favre"]["favre_rms"][f"vel{a}"], out0["favre_rms"][f"vel{a}"], rtol=1e-9
            )


def test_scalar_spectrum_sharded_matches_unsharded(four, fava_uniform):
    ref = fava_uniform["mesh"].scalar_spectra("dens")["dens"]
    for r in four:
        np.testing.assert_allclose(r["scalar"]["power"], ref["power"], rtol=1e-9, atol=1e-20)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_pfft3_matches_fftn(request, world):
    ranks = _world(request, world)
    ref = np.fft.fftn(_inputs()["pfft"])
    cols = ref.shape[1] // len(ranks)
    for r in ranks:
        lo = r["rank"] * cols
        np.testing.assert_allclose(r["pfft3"], ref[:, lo : lo + cols], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_mesh_step_matches_fava_tpu_mesh_branch(request, world, eight_device_mesh):
    import jax

    from fava_tpu import flagship as jflag
    from fava_tpu.parallel import volume_sharding

    sharding = volume_sharding(eight_device_mesh, 0, 3)
    fields = [jax.device_put(a, sharding) for a in _inputs()["fields"]]
    want = jflag.jitted_analysis_step(eight_device_mesh)(*fields)
    for r in _world(request, world):
        _assert_step(r["step"], want)


def test_pod_step_matches_per_snapshot(four):
    from fava_tpu import flagship as jflag

    batch = _inputs()["batch"]
    step = jflag.jitted_analysis_step(None)
    refs = [step(*(b[i] for b in batch)) for i in range(4)]
    seen = set()
    for r in four:
        assert r["pod_mesh"] == (True, 2, 2, 4)
        s, out = r["pod"]
        for i in range(2):
            _assert_step({k: v[i] for k, v in out.items()}, refs[2 * s + i])
            seen.add(2 * s + i)
    assert seen == {0, 1, 2, 3}


def test_placement_rule(four):
    """ny not dividing the space axis leaves the volume whole on every
    rank, with fava_tpu's unsharded numbers; an eligible from_arrays
    volume keeps the rank's slab, with the same numbers."""
    from fava_tpu.mesh import FlashUniform

    inp = _inputs()
    odd = FlashUniform.from_arrays(_named(inp["odd_y"]))
    arr = FlashUniform.from_arrays(_named(inp["arrays"]))
    ke_odd, ke_arr = odd.kinetic_energy_spectra(), arr.kinetic_energy_spectra()
    flag_odd = odd.flagship_analysis(streamed=False)
    for r in four:
        assert r["odd_y"] == (True, (8, 6, 8))
        assert r["arrays"] == (True, (4, 16, 8))
        _assert_spectra(r["odd_y_ke"], ke_odd)
        _assert_spectra(r["arrays_ke"], ke_arr)
        _assert_step(r["odd_y_flagship"], flag_odd)


def test_sharded_mesh_saves_and_regrids(four, uniform_file_32, tmp_path):
    """A sharded volume's save gathers the slabs and rank 0 writes the
    file, whose datasets equal fava_tpu's save of the same fields; its
    from_amr regrids each rank's slab of the output, fava_tpu's rows."""
    import h5py

    from fava_tpu.mesh import FlashUniform

    ref = FlashUniform(uniform_file_32)
    ref.load()
    for name in ("dens", "velx"):
        ref.data(name)
    ref.save(tmp_path / "rt_hdf5_uniform_0001", names=["dens", "velx"])
    ref.from_amr(save_file=False, fields=["dens", "velx"])
    rows = 32 // len(four)
    paths = {r["saved"][0] for r in four}
    assert len(paths) == 1
    with h5py.File(paths.pop(), "r") as got, h5py.File(tmp_path / "rt_hdf5_uniform_0001", "r") as want:
        assert set(got) == set(want)
        for key in ("dens", "velx", "bounding box", "block size", "node type", "refine level"):
            np.testing.assert_array_equal(got[key][()], want[key][()], err_msg=key)
            assert got[key].dtype == want[key].dtype, key
    whole = np.asarray(ref.data("velx"))
    for r in four:
        _path, sharded, slab = r["saved"]
        assert sharded
        np.testing.assert_array_equal(slab, whole[r["rank"] * rows : (r["rank"] + 1) * rows])


def test_mesh_must_cover_the_world(four):
    for r in four:
        assert "covers 2 of the world's 4 ranks" in r["small_mesh"]


def test_make_device_mesh_too_many_devices():
    """A mesh larger than the world raises fava_tpu's named error (no
    process group here: the world is this one process)."""
    from fava_tpu_torch.parallel import make_device_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 16 devices but only 1 are available"):
        make_device_mesh((2, 8), ("snap", "space"), device="cpu")
    assert not dist.is_initialized()
