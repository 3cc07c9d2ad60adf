"""fava_tpu_torch's rank-local PDFs, Q-R PDF and velocity spectra of a
slab-sharded volume held to fava_tpu on the CPU, in float64.

The port runs in gloo worlds of 4 and 8 ranks, spawned once each
(module-scoped), as tests/test_torch_ranklocal.py does. Every rank loads
conftest's 32^3 uniform file and a seeded (16, 8, 9) box through
``from_arrays`` under its (d,) space mesh, so it holds the x-slab of each
field, runs the ten analyses of the slice (``pdf1d``, ``pdf2d``,
``binned_statistic``, ``density_pdf``, ``gradient_invariant_pdfs``, the
enstrophy, helicity, decomposed, anisotropic and transfer spectra) with
their options, and saves the results with the calls it made to
``runtime.gather_slabs`` and to the kernel wrappers during each
(recorded by wrapping them inside the rank). It also saves
``pencil_irfft(pencil_rfft(x))`` of its slabs and the results on a volume
whose nx the space axis does not divide (the placement fallback). The
tests hold the results to fava_tpu unsharded and on conftest's 8-device
CPU mesh and to the port unsharded, and the calls to none of
``gather_slabs`` and to the kernels the slice launches (B8 and the
one-channel B6). Spawned ranks import this module, so jax and fava_tpu
are imported only inside the tests.

Tolerances: every float result rtol 1e-9; the spectra atol 1e-20 (shells
that a shape function leaves empty or at zero, such as the transfer at
k = 0); the binned standard deviation atol 1e-12 of its largest value
(a bin of equal samples has none, and its variance is a difference that
rounds to ~1e-16 of the mean square, tests/test_torch_volume.py:19).
Counts are exact, with one rule for the density PDF and the Q-R PDF:
their default edges come from float64 means (<rho>, <s> and sigma_s; Q_w),
which sum in the order of the slabs, so an edge may differ in its last
place between two decompositions, and a sample within that of an edge
may fall in the neighbouring bin. The tests count the samples within
EDGE_TOL of the range of an edge, held to the counts: the counts may
differ by twice that number at most (each moved sample leaves one bin
for another), and are equal when it is zero.
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

# The kernel wrappers whose calls the ranks record: B8, B6, and the
# single-device binnings (K3, B4, B10) that the sharded spectra must not
# reach.
WRAPPED = ("pdf2d_counts", "shell_bin_values_rfft_chunk", "shell_bin_sums_rfft_scalar",
           "shell_bin_sums_unfolded", "fold_quadrants_pair", "shell_bin_values_folded_1ch")
WEIGHTS = ("volume", "mass")
AXES = (0, 1, 2)
BOUNDARIES = ("periodic", "interior")
BOX_BOUNDS = [[0.0, 1.0], [0.0, 2.0], [0.0, 1.5]]
EDGE_TOL = 1e-12
RTOL = 1e-9


def _inputs():
    """Seeded numpy inputs shared by the ranks and the references: a box
    whose nx and ny divide 4 and 8 and whose nz is odd, and a volume
    whose nx divides neither (the placement fallback)."""
    rng = np.random.default_rng(20)

    def fields(shape):
        out = {"dens": 1.0 + 0.5 * rng.random(shape)}
        out.update({f"vel{a}": rng.standard_normal(shape) for a in "xyz"})
        return out

    return {"box": fields((16, 8, 9)), "odd_x": fields((10, 16, 8))}


def _analyses(m):
    """(name, call) of every analysis of the slice on mesh ``m``, with
    its options."""
    runs = []
    for w in WEIGHTS:
        runs += [(f"pdf1d_{w}", lambda w=w: m.pdf1d("dens", weight=w, nbins=24)),
                 (f"pdf1d_range_{w}", lambda w=w: m.pdf1d("velx", weight=w, nbins=16,
                                                          vrange=(-1.0, 1.5))),
                 (f"pdf2d_{w}", lambda w=w: m.pdf2d("dens", "velx", weight=w, nbins=(12, 10))),
                 (f"binned_{w}", lambda w=w: m.binned_statistic("dens", "velx", weight=w,
                                                                nbins=12)),
                 (f"density_pdf_{w}", lambda w=w: m.density_pdf(weight=w, nbins=40, mach=2.0))]
    runs += [("pdf2d_xrange", lambda: m.pdf2d("velx", "vely", xrange=(-1.5, 1.0), nbins=(9, 11))),
             ("binned_range", lambda: m.binned_statistic("velx", "dens", vrange=(-2.0, 2.0),
                                                         nbins=8))]
    runs += [(f"qr_{b}", lambda b=b: m.gradient_invariant_pdfs(nbins=(24, 20), boundary=b))
             for b in BOUNDARIES]
    runs += [("enstrophy", lambda: m.enstrophy_spectra()),
             ("helicity", lambda: m.helicity_spectra())]
    runs += [(f"decomposed_{w}", lambda w=w: m.decomposed_kinetic_energy_spectra(weighted=w))
             for w in (False, True)]
    runs += [(f"anisotropic{a}", lambda a=a: m.anisotropic_kinetic_energy_spectra(axis=a))
             for a in AXES]
    runs += [(f"transfer_{d}", lambda d=d: m.transfer_spectra(dealias=d)) for d in (False, True)]
    return runs


NAMES = [name for name, _ in _analyses(None)]
MINMAX = [n for n in NAMES if n.startswith(("pdf1d", "pdf2d", "binned"))]
EDGED = [n for n in NAMES if n.startswith(("density_pdf", "qr_"))]
SPECTRA = [n for n in NAMES if n not in MINMAX + EDGED]
# Results whose "counts" are float64 weight sums, not counts.
WEIGHT_SUMS = [n for n in NAMES if n.endswith("mass") and not n.startswith("binned")]


def _record(cuda_kernels, runtime):
    """Wrap the kernel wrappers of ``WRAPPED`` and ``runtime.gather_slabs``
    so that every call appends (name, shapes of its tensor arguments,
    whether it bins one channel or counts: its second argument or its
    ``weights`` None)."""
    calls = []

    def wrap(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            shapes = [tuple(a.shape) for a in list(args) + list(kwargs.values())
                      if isinstance(a, torch.Tensor)]
            if name == "pdf2d_counts":
                flag = kwargs.get("weights") is None
            else:
                flag = len(args) > 1 and args[1] is None
            calls.append((name, shapes, flag))
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
    from fava_tpu_torch.parallel import fft, runtime

    calls = _record(cuda_kernels, runtime)
    inp = _inputs()
    mesh = parallel.make_device_mesh(device="cpu")
    out = {"rank": rank}
    with parallel.use_mesh(mesh):
        uni = FlashUniform(uni_path, device="cpu")
        uni.load()
        box = FlashUniform.from_arrays(inp["box"], domain_bounds=BOX_BOUNDS, device="cpu")
        for key, m in (("file", uni), ("box", box)):
            runs = {}
            for name, fn in _analyses(m):
                calls.clear()
                runs[name] = (fn(), list(calls))
            out[key] = {"sharded": m._dmesh is mesh, "runs": runs,
                        "slab_shapes": {k: tuple(v.shape) for k, v in m._data.items()}}
        odd = FlashUniform.from_arrays(inp["odd_x"], device="cpu")
        out["odd_x"] = {"whole": odd._dmesh is None and tuple(odd._slab("dens").shape),
                        "runs": {name: fn() for name, fn in _analyses(odd)}}
        # The inverse pencil transform of the rank's slabs (odd nz on the box).
        out["inverse"] = {}
        for key, m in (("file", uni), ("box", box)):
            x = m._slab("velx")
            full = (int(x.shape[0]) * world,) + tuple(int(s) for s in x.shape[1:])
            hat = fft.pencil_rfft(x, mesh)
            back = fft.pencil_irfft(hat, full, mesh)
            out["inverse"][key] = (tuple(hat.shape), tuple(back.shape),
                                   float((back - x).abs().max()))
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
    return _run_world(4, tmp_path_factory.mktemp("ranklocal_pdfs4"), uniform_file_32)


@pytest.fixture(scope="module")
def eight(tmp_path_factory, uniform_file_32):
    return _run_world(8, tmp_path_factory.mktemp("ranklocal_pdfs8"), uniform_file_32)


def _world(request, name):
    return request.getfixturevalue(name)


def _port_meshes(uniform_file_32, device="cpu"):
    from fava_tpu_torch.mesh import FlashUniform

    uni = FlashUniform(uniform_file_32, device=device)
    uni.load()
    inp = _inputs()
    return {"file": uni,
            "box": FlashUniform.from_arrays(inp["box"], domain_bounds=BOX_BOUNDS, device=device),
            "odd_x": FlashUniform.from_arrays(inp["odd_x"], device=device)}


@pytest.fixture(scope="module")
def port_whole(uniform_file_32):
    """The port's results on one device, and the float64 fields."""
    meshes = _port_meshes(uniform_file_32)
    out = {key: {name: fn() for name, fn in _analyses(m)} for key, m in meshes.items()}
    out["fields"] = {key: {k: m.data(k) for k in ("dens", "velx", "vely", "velz")}
                     for key, m in meshes.items()}
    out["lengths"] = {key: m._domain_lengths() for key, m in meshes.items()}
    return out


@pytest.fixture(scope="module")
def fava(uniform_file_32, eight_device_mesh):
    """fava_tpu's results on the file and the box, unsharded and under its
    8-device mesh, and on the odd-x volume."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    inp = _inputs()

    def meshes():
        uni = FlashUniform(uniform_file_32)
        uni.load()
        return {"file": uni, "box": FlashUniform.from_arrays(inp["box"], domain_bounds=BOX_BOUNDS)}

    out = {"one": {k: {n: fn() for n, fn in _analyses(m)} for k, m in meshes().items()}}
    with use_mesh(eight_device_mesh):
        out["eight"] = {k: {n: fn() for n, fn in _analyses(m)} for k, m in meshes().items()}
    odd = FlashUniform.from_arrays(inp["odd_x"])
    out["odd_x"] = {n: fn() for n, fn in _analyses(odd)}
    return out


def _near_edges(samples: np.ndarray, edges: np.ndarray) -> int:
    """Samples within EDGE_TOL of the edges' range of an edge."""
    s = np.sort(np.asarray(samples, dtype=np.float64).ravel())
    tol = EDGE_TOL * (abs(edges[0]) + abs(edges[-1]))
    lo = np.searchsorted(s, edges - tol, side="left")
    hi = np.searchsorted(s, edges + tol, side="right")
    return int((hi - lo).sum())


def _samples_near_edges(name: str, ref, fields, lengths) -> int:
    """The samples of the density or Q-R PDF ``name`` within EDGE_TOL of
    an edge of the reference result ``ref``, from the float64 fields."""
    from fava_tpu_torch.ops import gradients

    if name.startswith("density_pdf"):
        rho = fields["dens"].numpy()
        mean = rho.mean() if name.endswith("volume") else (rho * rho).sum() / rho.sum()
        return _near_edges(np.log(rho / mean), ref["edges"])
    vels = [fields[f"vel{a}"] for a in "xyz"]
    shape = tuple(vels[0].shape)
    Q, R, _ = gradients.invariant_fields(vels, gradients._spacings(shape, lengths),
                                         name.split("_", 1)[1])
    qs = max(ref["q_w"], gradients.QW_FLOOR)
    qe, re = ref["q_edges"] * qs, ref["r_edges"] * qs**1.5
    return _near_edges(Q.numpy(), qe) + _near_edges(R.numpy(), re)


def _close(got, want, rtol, atol=0.0, what="", skip=()):
    """Nested dicts of arrays and floats held to each other."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            if k not in skip:
                _close(got[k], want[k], rtol, atol, f"{what}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64),
                                   rtol=rtol, atol=atol, err_msg=what)


def _hold(name, got, want, near, what):
    """One result of the slice held to a reference: the counts by the
    edge rule (module docstring) or exactly, every float within RTOL
    (the spectra atol 1e-20; the binned std atol 1e-12 of its largest)."""
    if name in SPECTRA:
        _close(got, want, RTOL, 1e-20, what)
        return
    if name.startswith("binned"):
        np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=what)
        scale = np.nanmax(np.abs(want["std"]))
        np.testing.assert_allclose(got["std"], want["std"], rtol=RTOL, atol=1e-12 * scale,
                                   err_msg=f"{what}/std")
        _close(got, want, RTOL, 0.0, what, skip=("std",))
        return
    weighted = name in WEIGHT_SUMS
    if name in EDGED and near:
        moved = float(np.abs(np.asarray(got["counts"]) - np.asarray(want["counts"])).sum())
        bound = 2.0 * near * (np.abs(want["counts"]).max() if weighted else 1.0)
        assert moved <= bound, f"{what}: counts moved {moved}, {near} samples near an edge"
        _close(got, want, RTOL, 0.0, what, skip=("counts", "pdf"))
        return
    if not weighted:
        np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=what)
    _close(got, want, RTOL, 0.0, what)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_no_field_is_gathered(request, world):
    """No analysis of the slice calls ``gather_slabs``, and every rank
    still holds its x-slab of every field afterwards."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for key, shape in (("file", (32 // d, 32, 32)), ("box", (16 // d, 8, 9))):
            assert r[key]["sharded"], key
            assert set(r[key]["slab_shapes"].values()) == {shape}, key
            for name, (_out, calls) in r[key]["runs"].items():
                assert not [c for c in calls if c[0] == "gather_slabs"], (key, name)


def _expected_calls(name, slab, ysl, rank, d):
    """The kernel calls of one analysis on a rank's (rows, ny, nz) x-slab
    ``slab``, whose transposed y-slab of the half-spectrum is ``ysl``."""
    rows, ny, nz = slab
    if name.startswith("pdf2d"):
        shapes = [slab, slab] + ([slab] if name.endswith("mass") else [])
        return [("pdf2d_counts", shapes, not name.endswith("mass"))]
    if name.startswith("qr_"):
        if name == "qr_interior":
            rows -= (rank == 0) + (rank == d - 1)
            ny, nz = ny - 2, nz - 2
        return [("pdf2d_counts", [(rows * ny * nz,)] * 2, True)]
    launches = {"enstrophy": 1, "helicity": 1, "transfer_False": 1, "transfer_True": 1,
                "decomposed_False": 3, "decomposed_True": 3}.get(name, 0)
    return [("shell_bin_values_rfft_chunk", [ysl], True)] * launches


@pytest.mark.parametrize("world", ["four", "eight"])
def test_kernels_of_the_slice(request, world):
    """B8 runs once a rank on its slab's samples (counted, or weighted by
    the mass); the one-channel B6 once a rank on its transposed y-slab
    per binned density (3 for the decomposed spectra) and no other
    binning; the 1D PDFs, ``binned_statistic``, ``density_pdf`` and the
    anisotropic spectra launch no kernel."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for key, (nx, ny, nz) in (("file", (32, 32, 32)), ("box", (16, 8, 9))):
            slab, ysl = (nx // d, ny, nz), (ny // d, nx, nz // 2 + 1)
            for name, (_out, calls) in r[key]["runs"].items():
                assert calls == _expected_calls(name, slab, ysl, r["rank"], d), (key, name)


@pytest.mark.parametrize("world", ["four", "eight"])
@pytest.mark.parametrize("key", ["file", "box"])
@pytest.mark.parametrize("name", NAMES)
def test_slice_matches_fava_tpu(request, world, key, name, fava, port_whole):
    """Each analysis of the slice on every rank against fava_tpu on one
    device and on 8 and against the port on one device (module
    docstring: the tolerances and the edge rule)."""
    refs = (fava["one"][key][name], fava["eight"][key][name], port_whole[key][name])
    near = [_samples_near_edges(name, ref, port_whole["fields"][key], port_whole["lengths"][key])
            if name in EDGED else 0 for ref in refs]
    for r in _world(request, world):
        got = r[key]["runs"][name][0]
        for ref, n in zip(refs, near):
            _hold(name, got, ref, n, f"rank {r['rank']} {key} {name}")


@pytest.mark.parametrize("world", ["four", "eight"])
def test_counts_equal_to_the_unsharded_port(request, world, port_whole):
    """The counts of ``pdf1d``, ``pdf2d`` and ``binned_statistic`` equal
    the unsharded port's (their edges come from exact MIN/MAX joins; the
    mass-weighted PDFs' weight sums within RTOL); those of the density
    and Q-R PDFs differ by no more than the edge rule allows, here by
    nothing: no sample lies near an edge."""
    for r in _world(request, world):
        for key in ("file", "box"):
            for name in MINMAX + EDGED:
                got, want = r[key]["runs"][name][0], port_whole[key][name]
                if name in EDGED:
                    near = _samples_near_edges(name, want, port_whole["fields"][key],
                                               port_whole["lengths"][key])
                    assert near == 0, (key, name, near)
                if name in WEIGHT_SUMS:
                    np.testing.assert_allclose(got["counts"], want["counts"], rtol=RTOL)
                else:
                    np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=name)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_inverse_pencil_transform(request, world):
    """``pencil_irfft(pencil_rfft(x))`` gives back each rank's x-slab
    within 1e-12, from its (nx, ny/d, nz//2+1) y-slab."""
    ranks = _world(request, world)
    d = len(ranks)
    for r in ranks:
        for key, (nx, ny, nz) in (("file", (32, 32, 32)), ("box", (16, 8, 9))):
            hat, back, err = r["inverse"][key]
            assert hat == (nx, ny // d, nz // 2 + 1) and back == (nx // d, ny, nz), key
            assert err <= 1e-12, (key, err)


@pytest.mark.parametrize("world", ["four", "eight"])
def test_placement_fallback(request, world, fava):
    """An nx that the space axis does not divide leaves the volume whole
    on every rank, with fava_tpu's numbers."""
    for r in _world(request, world):
        got = r["odd_x"]
        assert got["whole"] == (10, 16, 8)
        for name, want in fava["odd_x"].items():
            _hold(name, got["runs"][name], want, 0, f"rank {r['rank']} odd x {name}")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_virtual_ranks_join_as_one_device(d):
    """``SpaceRanks(d=d)`` plays every rank of a virtual axis: the ranked
    bodies of the ten analyses on d x-slabs equal the single device's
    (counts exactly, the rest within 1e-12), and ``pencil_irfft`` of the
    virtual ranks inverts their ``pencil_rfft``."""
    from fava_tpu_torch.ops import gradients, velocity, volume
    from fava_tpu_torch.parallel import SpaceRanks

    inp = _inputs()["box"]
    dens = torch.from_numpy(inp["dens"])
    vels = [torch.from_numpy(inp[f"vel{a}"]) for a in "xyz"]
    shape = tuple(dens.shape)
    lengths = (1.0, 2.0, 1.5)
    ranks, n = SpaceRanks(d=d), shape[0] // d

    def cut(t):
        return [t[r * n : (r + 1) * n] for r in range(d)]

    slabs = [list(v) for v in zip(*(cut(v) for v in vels))]
    pairs = {
        "pdf1d_mass": (volume.pdf1d_ranked(cut(dens), ranks, nbins=24, weights=cut(dens)),
                       volume.pdf1d(dens, nbins=24, weights=dens)),
        "pdf2d_volume": (volume.pdf2d_ranked(cut(dens), cut(vels[0]), ranks, nbins=(12, 10)),
                         volume.pdf2d(dens, vels[0], nbins=(12, 10))),
        "binned_mass": (volume.binned_statistic_ranked(cut(dens), cut(vels[0]), ranks, nbins=12,
                                                       weights=cut(dens)),
                        volume.binned_statistic(dens, vels[0], nbins=12, weights=dens)),
        "density_pdf_volume": (volume.density_pdf_ranked(cut(dens), ranks, nbins=40),
                               volume.density_pdf(dens, nbins=40)),
        "qr_interior": (gradients.gradient_invariant_pdfs_ranked(slabs, ranks, lengths, (24, 20),
                                                                  8.0, "interior"),
                        gradients.gradient_invariant_pdfs(*vels, lengths=lengths, nbins=(24, 20),
                                                          boundary="interior")),
        "enstrophy": (velocity.velocity_spectrum_ranked(slabs, ranks, lengths, "enstrophy"),
                      velocity.enstrophy_spectrum(*vels, lengths=lengths)),
        "helicity": (velocity.velocity_spectrum_ranked(slabs, ranks, lengths, "helicity"),
                     velocity.helicity_spectrum(*vels, lengths=lengths)),
        "decomposed_True": (velocity.decomposed_ke_spectra_ranked(slabs, ranks, cut(dens),
                                                                  lengths),
                            velocity.decomposed_ke_spectra(*vels, dens=dens, lengths=lengths)),
        "anisotropic1": (velocity.anisotropic_ke_spectra_ranked(slabs, ranks, 1),
                         velocity.anisotropic_ke_spectra(*vels, axis=1)),
        "transfer_True": (velocity.transfer_spectrum_ranked(slabs, ranks, lengths, True),
                          velocity.transfer_spectrum(*vels, lengths=lengths, dealias=True)),
    }
    fields = {"dens": dens, **{f"vel{a}": v for a, v in zip("xyz", vels)}}
    for name, (got, want) in pairs.items():
        near = _samples_near_edges(name, want, fields, lengths) if name in EDGED else 0
        _hold(name, got, want, near, f"{d} virtual ranks {name}")
    back = ranks.pencil_irfft(ranks.pencil_rfft(cut(vels[2])), shape)
    torch.testing.assert_close(torch.cat(back), vels[2], rtol=0, atol=1e-12)
