"""fava_tpu_torch's rank-local analyses of a slab-sharded volume held to
fava_tpu on the CPU, in float64.

The port runs in gloo worlds of 4 and 8 ranks, spawned once each
(module-scoped), as tests/test_torch_parallel.py does. Every rank loads
conftest's 32^3 uniform file (and seeded arrays through ``from_arrays``)
under its (d,) space mesh, so it holds the (32/d, 32, 32) x-slab of each
field, runs every analysis of the slice, and saves the results with the
calls it made to ``runtime.gather_slabs`` and to the kernel wrappers
during each (recorded by wrapping them inside the rank). The tests hold
the results to fava_tpu unsharded and on conftest's 8-device CPU mesh,
to the port unsharded, and the calls to none of ``gather_slabs`` and to
the kernels the slice launches. Spawned ranks import this module, so jax
and fava_tpu are imported only inside the tests.

Tolerances: the profiles, slice profiles and volume sums rtol 1e-9 (the
mirrors of tests/test_parallel.py:37 and :88 keep theirs); the scalar
spectrum rtol 1e-9 (atol 1e-20, its shell counts a shape function); the
fractal dimension's box counts exact and its statistics rtol 1e-12; the
structure functions and increment PDFs equal to the unsharded port bit
for bit and within rtol 1e-9 of fava_tpu (counts exact; the exponents'
standard errors atol 1e-12, one of them a fit of S_3 against itself,
zero up to rounding); the turbulence
summary and the gradient statistics rtol 1e-9 (atol 1e-12: the mean
gradients of a periodic box are zero up to rounding).
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

# The kernel wrappers whose calls the ranks record (K1, K2, B6, and the
# binnings the sharded scalar spectrum must not reach).
WRAPPED = ("row_moments_volume", "centered_row_moments", "shell_bin_values_rfft_chunk",
           "shell_bin_sums_rfft_scalar", "shell_bin_sums_unfolded", "fold_quadrants_pair",
           "shell_bin_values_folded_1ch")
AXES = (0, 1, 2)
SF_ARGS = dict(num_seps=4, num_points=64, sep_bounds=(0.1, 0.4), seed=2)
INC_ARGS = dict(num_seps=3, num_points=2048, nbins=17)  # __graft_entry__.py:154
CONTOURS = (0.5, None)
BOUNDARIES = ("periodic", "interior")


def _inputs():
    """Seeded numpy inputs shared by the ranks and the references: a
    volume with pressure and a per-cell gamc (nx and ny divide 4 and 8),
    one whose nx divides neither (the placement fallback), and a mask."""
    rng = np.random.default_rng(18)

    def fields(shape):
        out = {"dens": 1.0 + 0.5 * rng.random(shape)}
        out.update({f"vel{a}": rng.standard_normal(shape) for a in "xyz"})
        out["pres"] = 1.0 + rng.random(shape)
        out["gamc"] = 1.2 + 0.4 * rng.random(shape)
        return out

    return {"mach": fields((16, 16, 12)), "odd_x": fields((10, 16, 8)),
            "mask": rng.random((1, 32, 32, 32)) > 0.5}


def _record(cuda_kernels, runtime):
    """Wrap the kernel wrappers of ``WRAPPED`` and ``runtime.gather_slabs``
    so that every call appends (name, shapes of its tensor arguments,
    whether its second argument is None)."""
    calls = []

    def wrap(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            calls.append((name, shapes, len(args) > 1 and args[1] is None))
            return fn(*args, **kwargs)

        setattr(module, name, counted)

    for name in WRAPPED:
        wrap(cuda_kernels, name)
    wrap(runtime, "gather_slabs")
    return calls


def _analyses(m, masks):
    """(name, call) of every analysis of the slice on mesh ``m``."""
    runs = []
    for axis in AXES:
        runs += [(f"reynolds{axis}", lambda axis=axis: m.reynolds_stress(axis)[1:]),
                 (f"favre{axis}", lambda axis=axis: m.favre_profiles(axis)),
                 (f"slice_average{axis}", lambda axis=axis: m.slice_average("flam", axis)),
                 (f"slice_integral{axis}", lambda axis=axis: m.slice_integral("dens", axis))]
    runs += [("volume_integration", lambda: m.volume_integration("dens")),
             ("volume_average", lambda: m.volume_average("dens")),
             ("mass_sum", lambda: m.mass_sum(masks=masks)),
             ("mass_fraction", lambda: m.mass_fraction(masks=masks)),
             ("scalar", lambda: m.scalar_spectra("dens")["dens"])]
    runs += [(f"fractal{c}", lambda c=c: m.fractal_dimension(field="flam", contours=c)["flam"])
             for c in CONTOURS]
    runs += [("sf", lambda: m.structure_functions(**SF_ARGS)),
             ("sf_shared", lambda: m.structure_functions(resample_per_order=False, **SF_ARGS)),
             ("exponents", lambda: m.structure_function_exponents(**SF_ARGS)),
             ("increments", lambda: m.velocity_increment_pdfs(**INC_ARGS)),
             ("summary", lambda: m.turbulence_summary())]
    runs += [(f"gradients_{b}", lambda b=b: m.velocity_gradient_statistics(boundary=b))
             for b in BOUNDARIES]
    return runs


def _scenarios(rank: int, world: int, uni_path: str):
    from fava_tpu_torch import parallel
    from fava_tpu_torch.mesh import FlashUniform
    from fava_tpu_torch.ops import cuda_kernels, fractal
    from fava_tpu_torch.parallel import runtime

    calls = _record(cuda_kernels, runtime)
    counts = []
    box_counts_ranked = fractal.box_counts_ranked

    def kept_counts(*args, **kwargs):
        counts.append(box_counts_ranked(*args, **kwargs))
        return counts[-1]

    fractal.box_counts_ranked = kept_counts
    inp = _inputs()
    mesh = parallel.make_device_mesh(device="cpu")
    out = {"rank": rank, "runs": {}}
    with parallel.use_mesh(mesh):
        uni = FlashUniform(uni_path, device="cpu")
        uni.load()
        for name, fn in _analyses(uni, {"dense": inp["mask"]}):
            calls.clear()
            counts.clear()
            out["runs"][name] = (fn(), list(calls), [c.copy() for c in counts])
        out["sharded"] = uni._dmesh is mesh
        out["slab_shapes"] = {k: tuple(v.shape) for k, v in uni._data.items()}

        mach = FlashUniform.from_arrays(inp["mach"], device="cpu")
        calls.clear()
        out["mach"] = (mach._dmesh is mesh, mach.turbulence_summary(), list(calls))
        odd = FlashUniform.from_arrays(inp["odd_x"], device="cpu")
        out["odd_x"] = {"whole": odd._dmesh is None and tuple(odd._slab("dens").shape),
                        "scalar": odd.scalar_spectra("dens")["dens"],
                        "fractal": odd.fractal_dimension("dens", contours=None)["dens"],
                        "summary": odd.turbulence_summary(),
                        "gradients": odd.velocity_gradient_statistics(),
                        "reynolds": odd.reynolds_stress()[1:],
                        "increments": odd.velocity_increment_pdfs(**INC_ARGS)}
    # The halo exchange on a space axis of 2 (a pair of ranks swaps two
    # planes each way) and of the whole world, on slabs whose planes
    # carry their global row.
    meshes = {"world": mesh}
    if world == 4:
        meshes["pair"] = parallel.make_device_mesh((2, 2), ("snap", "space"), device="cpu")
    out["halos"] = {}
    for key, m in meshes.items():
        d, r = parallel.space_axis_size(m), int(m.get_local_rank("space"))
        slab = torch.arange(r * 3, r * 3 + 3, dtype=torch.float64)[:, None, None].expand(3, 2, 2)
        below, above = parallel.halo_x(slab.contiguous(), m, width=2)
        out["halos"][key] = (d, r, below[:, 0, 0].tolist(), above[:, 0, 0].tolist())
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
    return _run_world(4, tmp_path_factory.mktemp("ranklocal4"), uniform_file_32)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, uniform_file_32):
    return _run_world(8, tmp_path_factory.mktemp("ranklocal8"), uniform_file_32)


def _world(request, name):
    return request.getfixturevalue(name)


@pytest.fixture(scope="module")
def port_whole(uniform_file_32):
    """The port's results on the 32^3 file on one device."""
    from fava_tpu_torch.mesh import FlashUniform

    m = FlashUniform(uniform_file_32, device="cpu")
    m.load()
    return {name: fn() for name, fn in _analyses(m, {"dense": _inputs()["mask"]})}


@pytest.fixture(scope="module")
def fava(uniform_file_32, eight_device_mesh):
    """fava_tpu's results on the 32^3 file, unsharded and under its
    8-device mesh (the structure-function family on one device only: its
    draws are the port's, which the bit-equality test holds)."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    masks = {"dense": _inputs()["mask"]}
    m0 = FlashUniform(uniform_file_32)
    m0.load()
    out = {"one": {name: fn() for name, fn in _analyses(m0, masks)}}
    with use_mesh(eight_device_mesh):
        m1 = FlashUniform(uniform_file_32)
        m1.load()
        out["eight"] = {name: fn() for name, fn in _analyses(m1, masks)
                        if name not in ("sf", "sf_shared", "exponents", "increments")}
    out["whole"] = {k: np.asarray(m0.data(k)) for k in ("dens", "flam")}
    return out


def _close(got, want, rtol, atol=0.0, what=""):
    """Nested dicts/tuples of arrays and floats held to each other."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{what}/{k}")
    elif isinstance(want, (tuple, list)) and not np.isscalar(want):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{what}[{i}]")
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, what
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64),
                                   rtol=rtol, atol=atol, err_msg=what)


def _equal(got, want, what=""):
    """Nested results equal bit for bit (NaN where the other is NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}/{k}")
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, what
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


PROFILES = [f"{kind}{axis}" for axis in AXES
            for kind in ("reynolds", "favre", "slice_average", "slice_integral")]
SUMS = ["volume_integration", "volume_average", "mass_sum", "mass_fraction"]
TOLERANCES = {name: (1e-9, 0.0) for name in PROFILES + SUMS}
TOLERANCES.update({"scalar": (1e-9, 1e-20), "summary": (1e-9, 1e-12),
                   "gradients_periodic": (1e-9, 1e-12), "gradients_interior": (1e-9, 1e-12)})
TOLERANCES.update({f"fractal{c}": (1e-12, 0.0) for c in CONTOURS})
# The exponents' standard error of the reference order is zero up to
# rounding (its fit is S_3 against itself): atol 1e-12 there.
FAVA_STRUCTURE = {"sf": (1e-9, 0.0), "sf_shared": (1e-9, 0.0), "exponents": (1e-9, 1e-12),
                  "increments": (1e-9, 0.0)}


@pytest.mark.parametrize("world", ["four", "eight"])
def test_no_field_is_gathered(request, world):
    """No analysis of the slice calls ``gather_slabs``, and every rank
    still holds its (32/d, 32, 32) slab of every field afterwards."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        assert r["sharded"]
        assert set(r["slab_shapes"].values()) == {(32 // d, 32, 32)}
        for name, (_out, calls, _counts) in r["runs"].items():
            assert not [c for c in calls if c[0] == "gather_slabs"], name
        assert r["mach"][0]
        assert not [c for c in r["mach"][2] if c[0] == "gather_slabs"]


@pytest.mark.parametrize("world", ["four", "eight"])
def test_kernels_of_the_slice(request, world):
    """The uniform profiles along x run K1 and K2 once a rank on its slab;
    the scalar spectrum runs the one-channel B6 once a rank on its
    transposed (32/d, 32, 17) y-slab and no other binning."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for name in ("reynolds0", "favre0"):
            calls = [c for c in r["runs"][name][1] if c[0] != "gather_slabs"]
            assert [c[0] for c in calls] == ["row_moments_volume", "centered_row_moments"], name
            assert all(s == (32 // d, 32, 32) for s in calls[0][1]), name
        calls = [c for c in r["runs"]["scalar"][1] if c[0] != "gather_slabs"]
        assert calls == [("shell_bin_values_rfft_chunk", [(32 // d, 32, 17)], True)]
        for name in ("reynolds1", "reynolds2", "slice_average0", "summary", "gradients_periodic"):
            assert not r["runs"][name][1], name


@pytest.mark.parametrize("world", ["four", "eight"])
@pytest.mark.parametrize("name", sorted(TOLERANCES))
def test_slice_matches_fava_tpu(request, world, name, fava, port_whole):
    """Each analysis of the slice on every rank against fava_tpu on one
    device and on 8, and against the port on one device."""
    rtol, atol = TOLERANCES[name]
    for r in _world(request, world):
        got = r["runs"][name][0]
        for ref in (fava["one"][name], fava["eight"][name], port_whole[name]):
            _close(got, ref, rtol, atol, f"rank {r['rank']} {name}")


@pytest.mark.parametrize("world", ["four", "eight"])
@pytest.mark.parametrize("contour", CONTOURS)
def test_box_counts_exact(request, world, contour, fava, eight_device_mesh):
    """The fractal dimension's box counts on every rank equal fava_tpu's
    on one device and on the 8-device mesh."""
    import jax

    from fava_tpu.ops import fractal as jfrac
    from fava_tpu.parallel import volume_sharding

    flam = fava["whole"]["flam"]
    flength = int(np.log2(min(flam.shape))) + 1
    fn = jfrac._fractal_counts_fn(flam.shape, flength, contour is None)
    c = np.float64(0.0 if contour is None else contour)
    want = np.asarray(fn(flam, c))
    sharded = jax.device_put(flam, volume_sharding(eight_device_mesh, 0, 3))
    np.testing.assert_array_equal(np.asarray(fn(sharded, c)), want)
    for r in _world(request, world):
        (got,) = r["runs"][f"fractal{contour}"][2]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", ["four", "eight"])
@pytest.mark.parametrize("name", sorted(FAVA_STRUCTURE))
def test_structure_family_bit_equal(request, world, name, fava, port_whole):
    """The structure functions, their exponents and the increment PDFs
    equal the unsharded port bit for bit (counts exactly) and fava_tpu
    within rtol 1e-9 (counts exactly)."""
    for r in _world(request, world):
        got = r["runs"][name][0]
        _equal(got, port_whole[name], f"rank {r['rank']} {name}")
        _close(got, fava["one"][name], *FAVA_STRUCTURE[name], f"rank {r['rank']} {name}")
        if name == "increments":
            for comp in ("longitudinal", "transverse"):
                np.testing.assert_array_equal(got[comp]["counts"],
                                              fava["one"][name][comp]["counts"])


@pytest.fixture(scope="module")
def fava_arrays(eight_device_mesh):
    """fava_tpu's summary with pres and gamc (from_arrays), unsharded and
    on the 8-device mesh, and its results on the odd-x volume."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    inp = _inputs()
    m0 = FlashUniform.from_arrays(inp["mach"])
    out = {"mach": m0.turbulence_summary()}
    with use_mesh(eight_device_mesh):
        out["mach8"] = FlashUniform.from_arrays(inp["mach"]).turbulence_summary()
    odd = FlashUniform.from_arrays(inp["odd_x"])
    out["odd_x"] = {"scalar": odd.scalar_spectra("dens")["dens"],
                    "fractal": odd.fractal_dimension("dens", contours=None)["dens"],
                    "summary": odd.turbulence_summary(),
                    "gradients": odd.velocity_gradient_statistics(),
                    "reynolds": odd.reynolds_stress()[1:],
                    "increments": odd.velocity_increment_pdfs(**INC_ARGS)}
    return out


@pytest.mark.parametrize("world", ["four", "eight"])
def test_summary_with_pressure_and_gamc(request, world, fava_arrays):
    """The summary of a sharded from_arrays volume with pres and a
    per-cell gamc (the Mach statistics, mach_max by a MAX all_reduce)."""
    from fava_tpu_torch.mesh import FlashUniform

    whole = FlashUniform.from_arrays(_inputs()["mach"], device="cpu").turbulence_summary()
    assert "mach_max" in whole
    for r in _world(request, world):
        sharded, got, _calls = r["mach"]
        assert sharded
        for ref in (fava_arrays["mach"], fava_arrays["mach8"], whole):
            _close(got, ref, 1e-9, 1e-12, f"rank {r['rank']} summary")


@pytest.mark.parametrize("world", ["four", "eight"])
def test_placement_fallback(request, world, fava_arrays):
    """An nx that the space axis does not divide leaves the volume whole
    on every rank, with the single device's numbers."""
    want = fava_arrays["odd_x"]
    for r in _world(request, world):
        got = r["odd_x"]
        assert got["whole"] == (10, 16, 8)
        for key in want:
            _close(got[key], want[key], 1e-9, 1e-12, f"rank {r['rank']} odd x {key}")
        for comp in ("longitudinal", "transverse"):
            np.testing.assert_array_equal(got["increments"][comp]["counts"],
                                          want["increments"][comp]["counts"])


@pytest.mark.parametrize("world", ["four", "eight"])
def test_halo_exchange(request, world):
    """``halo_x`` returns the last planes of rank r-1 and the first of
    rank r+1, wrapped across ranks 0 and d-1 (slabs of 3 rows)."""
    for r in _world(request, world):
        for key, (d, rank, below, above) in r["halos"].items():
            n = 3 * d
            assert below == [float((3 * rank - 2 + i) % n) for i in range(2)], key
            assert above == [float((3 * rank + 3 + i) % n) for i in range(2)], key


def test_one_channel_chunks_add_up_to_the_unfolded_binning():
    """The one-channel B6's plain twin over the x-chunks of a half-spectrum
    power adds up to the one-channel unfolded binning of the whole (B10's
    twin), and returns (1, nbins)."""
    from fava_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(7)
    nx, ny, nz = 12, 10, 14
    p = torch.from_numpy(rng.random((nx, ny, nz // 2 + 1)))
    nbins = max(nx, ny, nz) // 2 - 1
    whole = ck.shell_bin_sums_unfolded(p, None, nbins, nz)
    parts = [ck.shell_bin_values_rfft_chunk(p[k : k + 4], None, nbins, nx, nz, k)
             for k in range(0, nx, 4)]
    assert all(t.shape == (1, nbins) for t in parts)
    torch.testing.assert_close(sum(parts), whole, rtol=1e-12, atol=0)
    counts, sums = ck.shell_bin_sums_rfft_chunk(p[4:8], None, nbins, nx, nz, 4)
    assert sums.shape == (1, nbins) and counts.shape == (nbins,)
    torch.testing.assert_close(sums, parts[1], rtol=0, atol=0)


def test_virtual_ranks_join_as_one_device():
    """``SpaceRanks(d=d)`` plays every rank of a virtual axis: the sharded
    scalar spectrum, box counts, summary and gradient statistics from d
    x-slabs equal the single device's (within 1e-12 where the sums change
    order; the counts exactly)."""
    from fava_tpu_torch.ops import fractal, gradients, spectra, velocity
    from fava_tpu_torch.parallel import SpaceRanks

    rng = np.random.default_rng(11)
    shape = (16, 8, 12)
    dens = torch.from_numpy(1.0 + 0.5 * rng.random(shape))
    vels = [torch.from_numpy(rng.standard_normal(shape)) for _ in range(3)]
    lengths = (1.0, 2.0, 1.5)
    want = {"scalar": spectra.scalar_spectrum(dens)["power"],
            "fractal": fractal.fractal_dimension(dens, [1.2, None]),
            "summary": velocity.turbulence_summary_device(*vels, dens=dens, lengths=lengths)[0],
            "gradients": gradients.gradient_stats_device(vels, lengths, "interior")[0]}
    for d in (2, 4, 8):
        ranks, n = SpaceRanks(d=d), shape[0] // d

        def cut(t):
            return [t[r * n : (r + 1) * n] for r in range(d)]

        slabs = [list(v) for v in zip(*(cut(v) for v in vels))]
        got = spectra.scalar_spectrum_from_slabs(ranks.pencil_rfft(cut(dens)), shape, ranks)
        np.testing.assert_allclose(got["power"], want["scalar"], rtol=1e-12, atol=1e-20)
        assert fractal.fractal_dimension_ranked(cut(dens), ranks, [1.2, None]) == want["fractal"]
        summary = velocity.turbulence_summary_ranked(slabs, ranks, cut(dens), lengths=lengths)
        torch.testing.assert_close(summary, want["summary"], rtol=1e-12, atol=1e-15)
        grads = gradients.gradient_stats_ranked(slabs, ranks, lengths, "interior")
        torch.testing.assert_close(grads, want["gradients"], rtol=1e-12, atol=1e-12)
