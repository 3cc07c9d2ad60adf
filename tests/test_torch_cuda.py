"""fava_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernels take float32; the plain version gets the same values in float64.
Tolerances: row and block-row moments rtol 1e-10 (f64 sums in another
order); fold rtol 4e-7 (<= 3 float32 roundings of <= 4 positive terms);
shell sums rtol 1e-10 (f64 sums, atomics in run-dependent order), the
chunk binning (B6) at kx0 = 0 equal to B10's up to that rounding;
regrid exact (values are copied); joint-histogram counts exact, weighted
sums rtol 1e-12 (f64 atomics in run-dependent order). The fused powers
binning (B9) and the one-pass folded binning (B11a): counts from the
kernel exact, sums rtol 1e-10 (f64 powers and sums in another order);
the fused z+y transform (B12), both its cluster FFT kernel (power-of-two
y and z) and its dense kernel (other shapes): max |diff| within 1e-5 of
the largest coefficient of the float64 dense DFT (f32 FFT stages or f32
products summed in a fixed order); the FFT kernel also within 1e-6 of its
float32 FFT twin, which rounds at the same stages. The particle paths
(plain torch, float64, no kernel): ``statistics()`` means and RMS at
rtol 1e-12 and min/max exact; the pair structure functions' counts exact
and sums rtol 1e-12 (float64 atomics in run-dependent order); the
nearest-neighbour sweep's partners exact. K5/K6 on leaf shares and K7
on output slabs from local stacks, joined, equal one launch exactly.
"""

import numpy as np
import pytest
import torch

import fava_tpu_torch
from fava_tpu_torch import flagship
from fava_tpu_torch.io import synthetic
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import regrid

SHAPE = (32, 32, 48)
BLOCKS = (40, 16, 16, 16)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fields(device, shape=SHAPE, seed=11):
    rng = np.random.default_rng(seed)
    f = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    return [torch.from_numpy(a).float().to(device) for a in f]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ck.KERNELS)
def test_kernel_matches_plain(cuda_device, kernel):
    f = _fields(cuda_device)
    f64 = [a.double() for a in f]
    ck.reset_launch_counts()
    if kernel in ("block_row_moments", "block_centered_row_moments"):
        b = _fields(cuda_device, shape=BLOCKS, seed=5)
        b64 = [a.double() for a in b]
        means = ck._block_row_moments_plain(*b64)[1:4] / (BLOCKS[2] * BLOCKS[3])
        if kernel == "block_row_moments":
            got, ref = ck.block_row_moments(*b), ck._block_row_moments_plain(*b64)
        else:
            got = ck.block_centered_row_moments(*b, means)
            ref = ck._block_centered_plain(*b64, means)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-9)
    elif kernel == "regrid_fields":
        plan, stacks = _regrid_inputs(cuda_device)
        tables = plan.device_tables(cuda_device)
        args = (plan.out_shape, tuple(plan.out_origin), tuple(plan.ncells_vec))
        got = ck.regrid_fields(stacks, *tables, *args)
        torch.cuda.synchronize()
        ref = ck._regrid_plain(stacks, *tables, *args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    elif kernel in ("row_moments", "centered_row_moments"):
        means = ck._row_moments_plain(*f64)[1:4] / (SHAPE[1] * SHAPE[2])
        if kernel == "row_moments":
            got, ref = ck.row_moments_volume(*f), ck._row_moments_plain(*f64)
        else:
            got, ref = ck.centered_row_moments(*f, means), ck._centered_plain(*f64, means)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-9)
    elif kernel in ("pdf2d_counts", "pdf2d_weighted"):
        xe, ye = np.linspace(0.9, 1.6, 41), np.linspace(-3.0, 3.0, 57)
        w = f[2].abs() if kernel == "pdf2d_weighted" else None
        got = ck.pdf2d_counts(f[0], f[1], xe, ye, weights=w)
        torch.cuda.synchronize()
        ref = ck._pdf2d_plain(f64[0], f64[1], xe, ye, None if w is None else w.double())
        if w is None:
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-12, atol=0)
    elif kernel == "shell_bin_values_rfft_chunk":
        p = [a.abs()[8:24, :, : SHAPE[2] // 2 + 1].contiguous() for a in f[:2]]
        nbins = max(SHAPE) // 2 - 1
        got = ck.shell_bin_values_rfft_chunk(*p, nbins, SHAPE[0], SHAPE[2], 8)
        torch.cuda.synchronize()
        ref = ck._shell_bin_unfolded_plain(*(a.double() for a in p), nbins, SHAPE[2], 8, SHAPE[0])
        torch.testing.assert_close(got[:2], ref, rtol=1e-10, atol=0)
    elif kernel == "shell_bin_values_rfft_chunk_1ch":
        # A transposed y-slab of a pencil transform: rows 8.. of a 32-row axis.
        p = f[0].abs()[8:24, :, : SHAPE[2] // 2 + 1].contiguous()
        nbins = max(SHAPE) // 2 - 1
        got = ck.shell_bin_values_rfft_chunk(p, None, nbins, SHAPE[0], SHAPE[2], 8)
        torch.cuda.synchronize()
        ref = ck._shell_bin_unfolded_plain(p.double(), None, nbins, SHAPE[2], 8, SHAPE[0])
        assert got.shape == (1, nbins)
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=0)
    elif kernel == "shell_bin_sums_unfolded":
        odd = [a.abs()[1:, :, : SHAPE[2] // 2 + 1].contiguous() for a in f[:2]]
        nbins = max(SHAPE) // 2 - 1
        got = ck.shell_bin_sums_unfolded(*odd, nbins, SHAPE[2])
        torch.cuda.synchronize()
        ref = ck._shell_bin_unfolded_plain(*(a.double() for a in odd), nbins, SHAPE[2])
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=0)
    elif kernel == "shell_bin_powers_fused":
        r = torch.view_as_real(torch.fft.rfftn(torch.stack(f[1:]), dim=(1, 2, 3), norm="forward"))
        nbins = max(SHAPE) // 2 - 1
        counts, sums = ck.shell_bin_powers_fused(r[..., 0], r[..., 1], nbins, SHAPE[2])
        torch.cuda.synchronize()
        ref = ck._powers_fused_plain(r[..., 0].double(), r[..., 1].double(), nbins, SHAPE[2])
        assert torch.equal(counts, ref[0])
        torch.testing.assert_close(sums[:2], ref[1:], rtol=1e-10, atol=0)
    elif kernel == "shell_bin_sums_folded_onepass":
        folded = _padded_folds([a.abs()[:, :, : SHAPE[2] // 2 + 1] for a in f[:2]], SHAPE[1])
        nbins = max(SHAPE) // 2 - 1
        ref = ck._onepass_plain(*(a.double() for a in folded), nbins, *SHAPE)
        counts, sums = ck.shell_bin_sums_folded_onepass(*folded, nbins, *SHAPE)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref[0])
        torch.testing.assert_close(sums[:2], ref[1:], rtol=1e-10, atol=0)
    elif kernel == "zy_rfft_planar":  # the FFT kernel's power-of-two route
        x = f[1][..., :32].contiguous()
        got = ck.zy_rfft_planar(x)
        torch.cuda.synchronize()
        _assert_zy_close(got, ck._zy_rfft_plain(x.double()))
    elif kernel == "zy_rfft_planar_dense":
        got = ck._zy_rfft_dense(f[1])
        torch.cuda.synchronize()
        _assert_zy_close(got, ck._zy_rfft_plain(f[1].double()))
    else:
        p = [a.abs()[:, :, : SHAPE[2] // 2 + 1].contiguous() for a in f[:2]]
        folded = ck.fold_quadrants_pair(*p)
        torch.cuda.synchronize()
        nbins = max(SHAPE) // 2 - 1
        if kernel == "fold_quadrants_pair":
            for g, r in zip(folded, map(ck._fold_plain, (a.double() for a in p))):
                torch.testing.assert_close(g.double(), r, rtol=4e-7, atol=0)
        elif kernel == "shell_bin_values_folded_1ch":
            got = ck.shell_bin_values_folded_1ch(folded[0], nbins, SHAPE[1], SHAPE[2])
            torch.cuda.synchronize()
            ref = ck._shell_bin_folded_plain(folded[0].double(), None, nbins, SHAPE[1], SHAPE[2])
            torch.testing.assert_close(got, ref[0], rtol=1e-10, atol=0)
        else:
            got = ck.shell_bin_values_folded(*folded, nbins, SHAPE[1], SHAPE[2])
            torch.cuda.synchronize()
            ref = ck._shell_bin_folded_plain(
                *(a.double() for a in folded), nbins, SHAPE[1], SHAPE[2]
            )
            torch.testing.assert_close(got, ref, rtol=1e-10, atol=0)
    assert ck.launch_counts()[kernel] == 1


def _padded_folds(vols, ny):
    """Plain folds of (nx, ny, nzr) volumes with their rows padded to a
    multiple of 8 (at least one pad row), as fava_tpu pads them, the pad
    rows holding NaN."""
    out = []
    nyh = ny // 2 + 1
    for v in vols:
        fo = ck._fold_plain(v)
        pad = torch.full((fo.shape[0], nyh + ((-nyh) % 8 or 8), fo.shape[2]), float("nan"),
                         dtype=fo.dtype, device=fo.device)
        pad[:, :nyh] = fo
        out.append(pad)
    return out


def _assert_zy_close(got, ref):
    """B12's float32 result against the float64 dense DFT: max |diff| within
    1e-5 of the largest coefficient (f32 products summed in a fixed order)."""
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    assert err <= 1e-5 * scale, (err, scale)


def _regrid_inputs(device, nfields=2):
    """A plan with scales 1-16 (levels 1-5 of 8^3 blocks) and random stacks."""
    from fava_tpu_torch.io.synthetic import build_amr_tree

    dom = np.array([[0.0, 2.0], [0.0, 1.0], [0.0, 1.0]])
    blocks = build_amr_tree(
        (2, 1, 1), dom, refine_fn=lambda b, lev: 5 if b[0, 0] < 0.2 and b[1, 0] < 0.2 else 1
    )
    plan = regrid.RegridPlan(
        block_bounds=np.stack([b.bounds for b in blocks]),
        node_type=np.array([b.node_type for b in blocks]),
        refine_level=np.array([b.level for b in blocks]),
        ncells_vec=np.array([8, 8, 8]),
        nblks_vec=np.array([2, 1, 1]),
        ndim=3,
        subdomain_coords=np.array([[0.05, 1.9], [0.0, 1.0], [0.0, 1.0]]),
    )
    assert int(plan.block_scales[plan.source_ids].max()) == 16
    rng = np.random.default_rng(3)
    stacks = [
        torch.from_numpy(rng.standard_normal((len(blocks), 8, 8, 8))).float().to(device)
        for _ in range(nfields)
    ]
    return plan, stacks


@pytest.mark.cuda
def test_regrid_copies_more_fields_than_one_launch_takes(cuda_device):
    plan, stacks = _regrid_inputs(cuda_device, nfields=ck.REGRID_MAX_FIELDS + 2)
    ck.reset_launch_counts()
    names = [str(i) for i in range(len(stacks))]
    got = regrid.regrid_fields(plan, dict(zip(names, stacks)), names)
    assert ck.launch_counts()["regrid_fields"] == 2
    tables = plan.device_tables(cuda_device)
    args = (plan.out_shape, tuple(plan.out_origin), tuple(plan.ncells_vec))
    for name, r in zip(names, ck._regrid_plain(stacks, *tables, *args)):
        assert torch.equal(got[name], r)


@pytest.mark.cuda
def test_amr_path_on_cuda_matches_the_cpu_path(cuda_device, tmp_path):
    synthetic.make_amr_file(
        tmp_path / "rt_hdf5_plt_cnt_0001", ncells=(16, 16, 16), nblks=(2, 1, 1), refine={0: 3}
    )
    window = np.array([[0.25, 0.75], [0.0, 1.0], [0.0, 1.0]])
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.FLASH(tmp_path, device=dev)
        m.load(file_type="plt")
        ck.reset_launch_counts()
        outs[dev] = (m.reynolds_stress(), m.favre_profiles())
        m.mesh.from_amr(subdomain_coords=window, fields=["dens", "velx"], save_file=False)
        assert m.mesh.nxb == 64  # the window was regridded: half of the 128-cell x extent
        outs[dev] += (m.mesh._data["dens"].cpu(),)
        counts = ck.launch_counts()
        if dev == "cuda":
            assert counts["block_row_moments"] == counts["block_centered_row_moments"] == 2
            assert counts["regrid_fields"] == 1
    (rs_c, fav_c, dens_c), (rs_g, fav_g, dens_g) = outs["cpu"], outs["cuda"]
    for g, r in zip([*rs_g[1].values(), *fav_g["favre_rms"].values()],
                    [*rs_c[1].values(), *fav_c["favre_rms"].values()]):
        assert float(np.abs(g - r).max()) <= 1e-9 * max(float(np.abs(r).max()), 1.0)
    assert torch.equal(dens_g, dens_c.float())


@pytest.mark.cuda
def test_step_on_cuda_matches_the_cpu_path(cuda_device):
    f = _fields(cuda_device, shape=(32, 32, 32))
    ck.reset_launch_counts()
    got = flagship.uniform_analysis_step(*f)
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    assert counts == {"row_moments": 1, "centered_row_moments": 1, "shell_bin_powers_fused": 1}
    ref = flagship.uniform_analysis_step(*(a.double().cpu() for a in f))
    for key, r in ref.items():
        g = got[key].cpu()
        bound = 1e-5 if key.startswith("spectra_") else 1e-9
        assert float((g - r).abs().max() / r.abs().max()) <= bound, key


@pytest.mark.cuda
def test_step_peak_memory_is_below_the_volumes_route(cuda_device):
    """At 256^3 the step's peak allocation over its inputs (the
    transforms' stack into B9) is below that of the spectra alone through
    the power volumes and K3 + K4, each warm and measured from a reset."""
    from fava_tpu_torch.ops import spectra

    f = _fields(cuda_device, shape=(256, 256, 256), seed=3)
    nbins = 256 // 2 - 1
    runs = {"step": lambda: flagship.uniform_analysis_step(*f),
            "volumes route": lambda: ck.shell_bin_sums_rfft(
                *spectra.kinetic_power_volumes(f[0], f[1:]), nbins, 256)}
    peaks = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    assert peaks["step"] < peaks["volumes route"], peaks


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    f = _fields(cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ck.row_moments_volume(*(a.double() for a in f))
    with pytest.raises(ValueError, match="contiguous"):
        ck.row_moments_volume(*(a.transpose(0, 1) for a in f))
    edges = np.linspace(0.0, 1.0, 5)
    with pytest.raises(TypeError, match="float32"):
        ck.pdf2d_counts(f[0], f[1], edges, edges, weights=f[2].double())
    with pytest.raises(ValueError, match="z extent"):
        p = torch.ones(15, 16, 9, device=cuda_device)
        ck.shell_bin_sums_unfolded(p, p, 7, 20)


def _samples(device, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.6, n)
    y = rng.normal(-0.2, 1.1, n)
    return [torch.from_numpy(a).float().to(device) for a in (x, y, rng.random(n))]


def _centres(edges, idx):
    return 0.5 * (edges[idx] + edges[idx + 1])


def _edge_neighbours(edges, n, rng):
    """n float32 samples drawn from the nearest float32 of every edge and its
    neighbours 1 and 2 steps below and above."""
    e = np.asarray(edges).astype(np.float32)
    near = [e] + [np.nextafter(e, np.float32(d)) for d in (-np.inf, np.inf)]
    near += [np.nextafter(a, np.float32(d)) for a, d in zip(near[1:], (-np.inf, np.inf))]
    return rng.choice(np.concatenate(near), n)


def _runs(n, length, edges, step):
    """Bin centres held for runs of ``length`` samples, the bin moving by
    ``step`` (mod the bins) from run to run."""
    nb = len(edges) - 1
    return _centres(edges, (np.arange(n) // length * step) % nb)


XE, YE = np.linspace(-1.0, 2.0, 38), np.linspace(-3.0, 3.0, 24)
PDF2D_MADE = {  # name: (make(n, rng) -> (x, y), x edges, y edges)
    "one bin": (lambda n, r: (np.full(n, 0.51), np.full(n, 0.12)), XE, YE),
    "two bins alternating": (lambda n, r: (np.where(np.arange(n) % 2, 0.51, 1.49), np.full(n, 0.12)),
                             XE, YE),
    **{f"runs of {k}": (lambda n, r, k=k: (_runs(n, k, XE, 13), _runs(n, k, YE, 5)), XE, YE)
       for k in (1, 7, 8, 9, 31, 33)},
    "edge neighbours": (lambda n, r: (_edge_neighbours(XE + 1e-9, n, r),
                                      _edge_neighbours(np.linspace(-0.3, 0.7, 24), n, r)),
                        XE + 1e-9, np.linspace(-0.3, 0.7, 24)),
    "closed last edge": (lambda n, r: (np.where(r.random(n) < 0.5, XE[-1], r.uniform(-1, 2, n)),
                                       np.where(r.random(n) < 0.5, 3.0, r.uniform(-3, 3, n))), XE, YE),
    "geometric edges": (lambda n, r: (10.0 ** r.uniform(-3.5, 3.5, n), r.uniform(-3, 3, n)),
                        np.geomspace(1e-3, 1e3, 38), YE),
    "nan and inf": (lambda n, r: tuple(r.choice([np.nan, np.inf, -np.inf, 0.3, 0.7, 1.1, 2.0], n)
                                       for _ in range(2)), XE, YE),
}

PDF2D_CASES = {
    "empty": dict(n=0),
    "one sample": dict(n=1),
    "all out of range": dict(n=5000, xr=(50.0, 60.0)),
    "ragged and unaligned": dict(n=10007, offset=1),
    "beyond shared memory": dict(n=200003, bins=(300, 300)),
    **{name: dict(n=100003, made=name) for name in PDF2D_MADE},
    "span remainder": dict(n=8 * 4099 + 5),
    "unaligned by 2": dict(n=8 * 4099 + 3, offset=2),
    "unaligned by 3 in runs": dict(n=65539, offset=3, made="runs of 9"),
}


def _pdf2d_case(device, c):
    """(x, y, w, x edges, y edges) of a PDF2D_CASES entry on ``device``."""
    off, n = c.get("offset", 0), c["n"]
    x, y, w = _samples(device, n + off)
    nbx, nby = c.get("bins", (37, 23))
    xe = np.linspace(*c.get("xr", (-1.0, 2.0)), nbx + 1)
    ye = np.linspace(-3.0, 3.0, nby + 1)
    if "made" in c:
        make, xe, ye = PDF2D_MADE[c["made"]]
        with np.errstate(invalid="ignore"):
            x, y = (torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
                    for a in make(n + off, np.random.default_rng(n)))
    return x[off:], y[off:], w[off:], xe, ye  # offset: not 16-byte aligned, scalar loads


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PDF2D_CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_pdf2d_edge_cases_match_plain(cuda_device, case, weighted):
    x, y, w, xe, ye = _pdf2d_case(cuda_device, PDF2D_CASES[case])
    nbx, nby = len(xe) - 1, len(ye) - 1
    shared = ck.pdf2d_hist_in_shared_memory(nbx, nby, weighted, cuda_device)
    assert shared == (case != "beyond shared memory")
    ck.reset_launch_counts()
    got = ck.pdf2d_counts(x, y, xe, ye, weights=w if weighted else None)
    torch.cuda.synchronize()
    assert ck.launch_counts()["pdf2d_weighted" if weighted else "pdf2d_counts"] == 1
    ref = ck._pdf2d_plain(x.double(), y.double(), xe, ye, w.double() if weighted else None)
    if weighted:
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=0)
    else:
        assert torch.equal(got, ref)
    if case == "all out of range":
        assert not got.any()
    if case == "one bin":
        assert int((ref != 0).sum()) == 1


# (nx, ny, nz, full grid): tiny, odd, a single y row, and full grids.
UNFOLDED_CASES = [(3, 5, 7, False), (31, 1, 16, False), (9, 9, 9, False), (7, 6, 5, True),
                  (8, 8, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz,full", UNFOLDED_CASES)
@pytest.mark.parametrize("channels", [1, 2])
def test_unfolded_binning_small_and_odd_shapes(cuda_device, nx, ny, nz, full, channels):
    nzr = nz if full else nz // 2 + 1
    nbins = max(nx, ny, nz) // 2 - 1 or 1
    vols = [a.abs() for a in _fields(cuda_device, shape=(nx, ny, nzr), seed=nx + nz)[:channels]]
    longi = vols[1] if channels == 2 else None
    got = ck.shell_bin_sums_unfolded(vols[0], longi, nbins, nz)
    torch.cuda.synchronize()
    ref = ck._shell_bin_unfolded_plain(
        vols[0].double(), None if longi is None else longi.double(), nbins, nz
    )
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-300)


# (nx, ny, nz, full grid): z extents nzr = 1, 2, 33, 257 and 513, none a
# multiple of a lane's span; odd x and y; full grids (both walks); rows of
# 511 cells (two trips of four float4 groups a lane).
SPAN_CASES = [(5, 3, 1, True), (4, 7, 3, False), (9, 6, 64, False), (3, 5, 512, False),
              (2, 3, 1024, False), (6, 5, 9, True), (5, 7, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz,full", SPAN_CASES)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("first_span", [False, True])
def test_unfolded_binning_spans_and_walks(cuda_device, nx, ny, nz, full, channels, first_span):
    """B10 against its twin; with ``first_span`` nbins = 2, so every walk
    stops inside its first span."""
    nzr = nz if full else nz // 2 + 1
    nbins = 2 if first_span else max(max(nx, ny, nz) // 2 - 1, 1)
    vols = [a.abs() for a in _fields(cuda_device, shape=(nx, ny, nzr), seed=nx * nz)[:channels]]
    longi = vols[1] if channels == 2 else None
    ck.reset_launch_counts()
    got = ck.shell_bin_sums_unfolded(vols[0], longi, nbins, nz)
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_sums_unfolded"] == 1
    ref = ck._shell_bin_unfolded_plain(
        vols[0].double(), None if longi is None else longi.double(), nbins, nz
    )
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-300)


def _chunk_entry(t, lo, out, nbins, full_nx, full_nz, kx0, channels):
    """B6's C entry with ``channels`` 1 or 2 (the wrapper always bins two)."""
    rows, ny, nzr = t.shape
    dev = t.device
    blocks = ck._walk_blocks("fava_shell_bin_unfolded_blocks_per_sm", (channels,), channels,
                             rows * ny, nbins, dev)
    ck._launch("shell_bin_values_rfft_chunk", dev, ck._build.library().fava_shell_bin_sums_rfft_chunk,
               t.data_ptr(), lo.data_ptr() if channels == 2 else None, out.data_ptr(), rows, ny, nzr,
               nbins, full_nx, full_nz, kx0, channels, blocks)


# (full_nx, ny, nz, kx0, rows): 5 x 5 cells a row, so kx0 * 100 bytes leaves
# the views unaligned to 16 bytes; the Nyquist row 9 of x extent 18 at a
# chunk's first, middle and last row; an odd x extent.
CHUNK_VIEW_CASES = [(18, 5, 9, 9, 3), (18, 5, 9, 7, 5), (18, 5, 9, 5, 5), (15, 7, 64, 3, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz,kx0,rows", CHUNK_VIEW_CASES)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("same_alignment", [True, False])
def test_chunk_binning_on_unaligned_views(cuda_device, nx, ny, nz, kx0, rows, channels,
                                          same_alignment):
    """B6 on views of whole half-spectra; without ``same_alignment`` the
    longitudinal chunk starts one row later in its volume, so the two
    volumes' rows sit at different offsets from 16 bytes (scalar loads)."""
    nbins = max(nx, ny, nz) // 2 - 1
    t, lo = (a.abs() for a in _fields(cuda_device, shape=(nx + 1, ny, nz // 2 + 1), seed=kx0)[:2])
    tc = t[kx0 : kx0 + rows]
    lc = lo[kx0 : kx0 + rows] if same_alignment else lo[kx0 + 1 : kx0 + 1 + rows]
    assert tc.is_contiguous() and tc.data_ptr() % 16 != 0
    out = torch.zeros((channels, nbins), dtype=torch.float64, device=cuda_device)
    ck.reset_launch_counts()
    _chunk_entry(tc, lc, out, nbins, nx, nz, kx0, channels)
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_values_rfft_chunk"] == 1
    ref = ck._shell_bin_unfolded_plain(tc.double(), lc.double() if channels == 2 else None, nbins,
                                       nz, kx0, nx)
    torch.testing.assert_close(out, ref, rtol=1e-10, atol=1e-300)


def _regrid_case(device, ncells, window, depth, nfields):
    """A plan over a 2 x 1 x 1 root grid whose corner block is refined to
    ``depth`` (scales 1 .. 2^(depth-1)), cut to ``window``, and random stacks."""
    from fava_tpu_torch.io.synthetic import build_amr_tree

    blocks = build_amr_tree(
        (2, 1, 1), np.array([[0.0, 2.0], [0.0, 1.0], [0.0, 1.0]]),
        refine_fn=lambda b, lev: depth if b[0, 0] < 0.2 and b[1, 0] < 0.2 else 1,
    )
    plan = regrid.RegridPlan(
        block_bounds=np.stack([b.bounds for b in blocks]),
        node_type=np.array([b.node_type for b in blocks]),
        refine_level=np.array([b.level for b in blocks]), ncells_vec=np.array(ncells),
        nblks_vec=np.array([2, 1, 1]), ndim=3, subdomain_coords=np.array(window),
    )
    rng = np.random.default_rng(depth + nfields)
    stacks = [torch.from_numpy(rng.standard_normal((len(blocks), *ncells))).float().to(device)
              for _ in range(nfields)]
    return plan, stacks


# name: (ncells, window, refinement depth, fields).
REGRID_CASES = {
    "scales 1-16": ((8, 8, 8), [[0.05, 1.9], [0, 1], [0, 1]], 5, 1),
    "scale 1 only": ((8, 8, 8), [[0.0, 2.0], [0, 1], [0, 1]], 1, 4),
    "nz not a multiple of 4": ((4, 4, 6), [[0.3, 1.7], [0, 1], [0.17, 0.93]], 3, 8),
    "origin off a multiple of 4": ((8, 8, 8), [[0.05, 1.9], [0.1, 0.9], [0.013, 0.77]], 4, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REGRID_CASES))
@pytest.mark.parametrize("holes", [False, True])
def test_regrid_is_bit_exact(cuda_device, case, holes):
    ncells, window, depth, nfields = REGRID_CASES[case]
    plan, stacks = _regrid_case(cuda_device, ncells, window, depth, nfields)
    scales = plan.block_scales[plan.source_ids]
    assert int(scales.max()) == 2 ** (depth - 1) and int(scales.min()) == 1
    table, offsets, block_scales = plan.device_tables(cuda_device)
    if holes:  # blk < 0: no source block, the cells are 0
        table = table.clone()
        table.view(-1)[::3] = -1
    args = (table, offsets, block_scales, plan.out_shape, tuple(plan.out_origin),
            tuple(plan.ncells_vec))
    if case == "nz not a multiple of 4":
        assert plan.out_shape[2] % 4 != 0
    if case == "origin off a multiple of 4":
        assert plan.out_origin[2] % 4 != 0
    ck.reset_launch_counts()
    got = ck.regrid_fields(stacks, *args)
    torch.cuda.synchronize()
    assert ck.launch_counts()["regrid_fields"] == 1
    for g, r in zip(got, ck._regrid_plain(stacks, *args)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4, 4), (8, 6, 5), (2, 34, 9)])
def test_folded_single_channel_small_shapes(cuda_device, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    p = _fields(cuda_device, shape=(nx, ny, nz // 2 + 1), seed=sum(shape))[0].abs()
    folded, _ = ck.fold_quadrants_pair(p, p)
    got = ck.shell_bin_values_folded_1ch(folded, nbins, ny, nz)
    torch.cuda.synchronize()
    ref = ck._shell_bin_folded_plain(folded.double(), None, nbins, ny, nz)[0]
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-300)


def _spectra_close(got, ref, bound):
    for key, r in ref.items():
        g, r = np.asarray(got[key]), np.asarray(r)
        assert np.array_equal(np.isnan(g), np.isnan(r)), key
        ok = ~np.isnan(r)
        assert float(np.abs(g[ok] - r[ok]).max() / np.abs(r[ok]).max()) <= bound, key


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (31, 32, 24), (32, 17, 20)])
def test_stage4_on_cuda_matches_the_cpu_path(cuda_device, shape):
    rng = np.random.default_rng(sum(shape))
    arrays = {"dens": 1.0 + 0.5 * rng.random(shape), "flam": rng.random(shape)}
    arrays.update({f"vel{a}": rng.standard_normal(shape) for a in "xyz"})
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    models = {d: fava_tpu_torch.from_arrays(arrays, device=d) for d in ("cpu", "cuda")}
    odd = shape[0] % 2 or shape[1] % 2
    outs = {}
    for dev, m in models.items():
        ck.reset_launch_counts()
        outs[dev] = {
            "ke": m.kinetic_energy_spectra(),
            "scalar": m.scalar_spectra("flam")["flam"],
            "flagship": m.flagship_analysis(),
            "pdf2d": m.pdf2d("dens", "velx"),
            "pdf2d_mass": m.pdf2d("dens", "velx", weight="mass"),
            "pdf1d": m.pdf1d("velx"),
            "density": m.density_pdf(),
            "binned": m.binned_statistic("dens", "velx"),
        }
        counts = ck.launch_counts()
        if dev == "cuda":
            assert counts["pdf2d_counts"] == counts["pdf2d_weighted"] == 1
            if odd:
                assert counts["shell_bin_sums_unfolded"] == 3 and counts["shell_bin_values_folded"] == 0
            else:  # the KE spectra and the step: B9; the scalar spectrum: K3 + B4
                assert counts["shell_bin_powers_fused"] == 2
                assert counts["shell_bin_values_folded"] == 0
                assert counts["shell_bin_values_folded_1ch"] == 1
    cpu, gpu = outs["cpu"], outs["cuda"]
    _spectra_close(gpu["ke"], cpu["ke"], 1e-5)
    _spectra_close(gpu["scalar"], cpu["scalar"], 1e-5)
    for key in ("pdf2d", "pdf1d"):
        assert np.array_equal(gpu[key]["counts"], cpu[key]["counts"]), key
    np.testing.assert_allclose(gpu["pdf2d_mass"]["counts"], cpu["pdf2d_mass"]["counts"], rtol=1e-12)
    assert np.array_equal(gpu["binned"]["counts"], cpu["binned"]["counts"])
    np.testing.assert_allclose(gpu["density"]["sigma_s"], cpu["density"]["sigma_s"], rtol=1e-12)


# (full_nx, ny, nz, rows): even and odd x, the Nyquist row nx/2 at a chunk's
# first, middle and last row, a single-row chunk, a non-multiple-of-32 z.
CHUNK_CASES = [(32, 32, 48, 8), (24, 16, 16, 8), (22, 16, 16, 2), (15, 9, 10, 5), (16, 8, 70, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz,rows", CHUNK_CASES)
def test_chunk_binning_matches_plain_at_every_offset(cuda_device, nx, ny, nz, rows):
    nbins = max(nx, ny, nz) // 2 - 1
    t, lo = (a.abs() for a in _fields(cuda_device, shape=(nx, ny, nz // 2 + 1), seed=nx + rows)[:2])
    ck.reset_launch_counts()
    acc = torch.zeros(3, nbins, dtype=torch.float64, device=cuda_device)
    for kx0 in range(0, nx, rows):
        part = [a[kx0 : kx0 + rows].contiguous() for a in (t, lo)]
        got = ck.shell_bin_values_rfft_chunk(*part, nbins, nx, nz, kx0)
        ref = ck._shell_bin_unfolded_plain(*(a.double() for a in part), nbins, nz, kx0, nx)
        torch.testing.assert_close(got[:2], ref, rtol=1e-10, atol=1e-300)
        acc += got
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_values_rfft_chunk"] == -(-nx // rows)
    whole = ck.shell_bin_sums_unfolded(t, lo, nbins, nz)
    torch.testing.assert_close(acc[:2], whole, rtol=1e-10, atol=1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 48), (31, 32, 24)])
def test_chunk_binning_at_kx0_zero_is_b10(cuda_device, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    t, lo = (a.abs() for a in _fields(cuda_device, shape=(nx, ny, nz // 2 + 1), seed=3)[:2])
    chunk = ck.shell_bin_values_rfft_chunk(t, lo, nbins, nx, nz, 0)
    whole = ck.shell_bin_sums_unfolded(t, lo, nbins, nz)
    torch.testing.assert_close(chunk[:2], whole, rtol=1e-12, atol=1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_streamed_step_on_cuda_matches_the_cpu_path(cuda_device, tmp_path, wire):
    """The out-of-core step on the card (pinned staging, side stream, B6,
    K5/K6) against the same step on the CPU on the same file, twice."""
    from fava_tpu_torch.ops import outofcore

    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(32, 32, 48), seed=4)
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.FLASH(tmp_path, device=dev)
        m.load(file_type="uni")
        ck.reset_launch_counts()
        outs[dev] = [m.flagship_analysis(streamed=True, slab_rows=8, chunk_rows=16,
                                         wire_dtype=wire) for _ in range(2)]
        if dev == "cuda":
            counts = ck.launch_counts()
            assert counts["shell_bin_values_rfft_chunk"] == 2 * 2
            assert counts["block_row_moments"] == counts["block_centered_row_moments"] == 2 * 4
    for got in outs["cuda"]:
        for key, r in outs["cpu"][0].items():
            bound = 1e-5 if key.startswith("spectra_") else 1e-9
            assert float(np.abs(got[key] - r).max() / np.abs(r).max()) <= bound, key
    loader = m.mesh._streamed_loader()
    stages = {}
    outofcore.streamed_uniform_analysis(loader, (32, 32, 48), slab_rows=8, chunk_rows=16,
                                        stage_ms=stages)
    assert set(stages) == {"stage_a", "x_transform", "stage_b"}


@pytest.mark.cuda
def test_series_on_cuda_match_the_cpu_path(cuda_device, tmp_path):
    """Snapshot ingest on the card (pinned staging, side stream, the swap
    on the card) feeding flagship_series and reynolds_series."""
    for i in (1, 2, 3):
        synthetic.make_uniform_file(tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 32, 24),
                                    seed=i)
        synthetic.make_amr_file(tmp_path / f"rt_hdf5_plt_cnt_000{i}", ncells=(8, 8, 8),
                                nblks=(2, 1, 1), refine={0: 2}, time=0.1 * i)
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.FLASH(tmp_path, device=dev)
        outs[dev] = (m.flagship_series(batch=2), m.reynolds_series(), m.favre_series())
    (fc, rc, vc), (fg, rg, vg) = outs["cpu"], outs["cuda"]
    for key, r in fc.items():
        bound = 1e-5 if key.startswith("spectra_") else 1e-9
        assert float(np.abs(fg[key] - r).max() / max(np.abs(r).max(), 1.0)) <= bound, key
    for got, ref in ((rg, rc), (vg, vc)):
        for key, r in ref.items():
            assert float(np.abs(got[key] - r).max()) <= 1e-9 * max(float(np.abs(r).max()), 1.0), key


# B9: Nyquist rows at both folds in every even shape; odd and tiny z; the
# folded grid smaller than a warp, and a y extent of 2 (no mirror rows).
FUSED_CASES = [(4, 4, 4), (8, 6, 5), (16, 10, 9), (2, 34, 9), (6, 2, 70), (32, 32, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FUSED_CASES)
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_powers_fused_small_and_odd_shapes(cuda_device, shape, layout):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    spec = torch.fft.rfftn(torch.stack(_fields(cuda_device, shape=shape, seed=sum(shape))[1:]),
                           dim=(1, 2, 3), norm="forward")
    r = torch.view_as_real(spec)
    re, im = (r[..., 0], r[..., 1]) if layout == "interleaved" else (
        r[..., 0].contiguous(), r[..., 1].contiguous())
    ck.reset_launch_counts()
    counts, sums = ck.shell_bin_powers_fused(re, im, nbins, nz)
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_powers_fused"] == 1
    ref = ck._powers_fused_plain(re.double(), im.double(), nbins, nz)
    assert torch.equal(counts, ref[0])
    assert torch.equal(counts, ck._static_counts((nx, ny, nz // 2 + 1), nbins, nz, cuda_device))
    torch.testing.assert_close(sums[:2], ref[1:], rtol=1e-10, atol=1e-300)
    torch.testing.assert_close(sums[2], sums[0] - sums[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4, 4), (16, 10, 9), (32, 126, 16), (16, 16, 400)])
def test_onepass_folded_with_garbage_pad_rows(cuda_device, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    vols = [a.abs() for a in _fields(cuda_device, shape=(nx, ny, nz // 2 + 1), seed=nx + ny)[:2]]
    folded = _padded_folds(vols, ny)
    ck.reset_launch_counts()
    counts, sums = ck.shell_bin_sums_folded_onepass(*folded, nbins, nx, ny, nz)
    rows = ck.shell_bin_values_folded_rows(*folded, nbins, nx, ny, nz)
    torch.cuda.synchronize()
    # The row-chunked entry is an alias of K4's wrapper: its launch counts as K4's.
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "shell_bin_sums_folded_onepass": 1, "shell_bin_values_folded": 1}
    ref = ck._onepass_plain(*(a.double() for a in folded), nbins, nx, ny, nz)
    assert torch.equal(counts, ref[0])
    torch.testing.assert_close(sums[:2], ref[1:], rtol=1e-10, atol=1e-300)
    torch.testing.assert_close(torch.stack(rows), ref[1:], rtol=1e-10, atol=1e-300)


# B12's shapes and the kernel each takes: the cluster FFT kernel for
# every y and z in 1..1024: power-of-two and mixed-radix plans (odd z with
# paired rows) for extents with no prime factor above 7, the chirp route
# (Bluestein) for the others (33 = 3 x 11, 22 = 2 x 11, 502 = 2 x 251,
# 509), and an empty z transform for nz = 1. The dense kernel is on no
# route. The chirp shapes: y only, z only (even and odd prime), both,
# nz = 1, and 1021 x 1019 (2048-point convolutions, tables in global
# memory).
ZY_ROUTES = [((2, 2, 2), "zy_rfft_planar"), ((3, 64, 32), "zy_rfft_planar"),
             ((4, 512, 512), "zy_rfft_planar"), ((2, 1024, 1024), "zy_rfft_planar"),
             ((1, 1024, 2), "zy_rfft_planar"), ((3, 40, 50), "zy_rfft_planar"),
             ((2, 64, 33), "zy_rfft_planar"), ((1, 1, 1), "zy_rfft_planar"),
             ((2, 512, 480), "zy_rfft_planar"), ((2, 480, 512), "zy_rfft_planar"),
             ((2, 384, 375), "zy_rfft_planar"), ((3, 45, 35), "zy_rfft_planar"),
             ((2, 1, 7), "zy_rfft_planar"), ((2, 27, 18), "zy_rfft_planar"),
             ((2, 49, 343), "zy_rfft_planar"), ((1, 1000, 1000), "zy_rfft_planar"),
             ((2, 22, 502), "zy_rfft_planar"), ((1, 509, 8), "zy_rfft_planar"),
             ((2, 502, 16), "zy_rfft_planar"), ((2, 64, 502), "zy_rfft_planar"),
             ((2, 16, 509), "zy_rfft_planar"), ((2, 127, 127), "zy_rfft_planar"),
             ((3, 64, 1), "zy_rfft_planar"), ((3, 22, 1), "zy_rfft_planar"),
             ((1, 1021, 1019), "zy_rfft_planar")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", ZY_ROUTES)
def test_zy_rfft_matches_plain(cuda_device, shape, route):
    x = _fields(cuda_device, shape=shape, seed=sum(shape))[1]
    ck.reset_launch_counts()
    got = ck.zy_rfft_planar(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {route: 1}
    _assert_zy_close(got, ck._zy_rfft_plain(x.double()))
    if route == "zy_rfft_planar":  # the same stages as its float32 twin
        twin = ck._zy_rfft_fft_plain(x, ck._zy_fft_plan(shape[1], shape[2]))
        scale = max(float(t.abs().max()) for t in twin)
        assert max(float((g - t).abs().max()) for g, t in zip(got, twin)) <= 1e-6 * scale


@pytest.mark.cuda
def test_zy_fft_kernel_fits_the_card_and_reads_unaligned_rows(cuda_device):
    """Every plan the rule makes for the path's shapes schedules at least
    one cluster, and so does every chirp plan: each extent 1..1024 with a
    prime factor above 7 paired with 512 and with itself (the largest
    shared memory, up to 2048-point convolutions); volumes that start 4
    or 8 bytes off a 16-byte boundary take the FFT kernel all the same
    (scalar or float2 row loads; odd z rows are read by scalars)."""
    for ny, nz in ((512, 512), (1024, 1024), (1024, 2), (1, 1024), (16, 16), (512, 480), (480, 512),
                   (384, 375), (1000, 1000), (768, 768), (1024, 960), (512, 1), (1, 1)):
        assert ck.zy_fft_active_clusters(ck._zy_fft_plan(ny, nz), cuda_device) >= 1
    for n in range(1, ck.ZY_MAX_EXTENT + 1):
        if not ck._smooth7(n):
            for ny, nz in ((n, 512), (512, n), (n, n)):
                assert ck.zy_fft_active_clusters(ck._zy_fft_plan(ny, nz), cuda_device) >= 1, (ny, nz)
    for shape in ((3, 64, 64), (3, 48, 60), (3, 45, 35), (3, 22, 26), (3, 13, 33)):
        size = shape[0] * shape[1] * shape[2]
        base = _fields(cuda_device, shape=(size + 2,), seed=1)[1]
        for off in (1, 2):
            x = base[off : off + size].view(shape)
            assert x.data_ptr() % 16 == 4 * off
            ck.reset_launch_counts()
            got = ck.zy_rfft_planar(x)
            torch.cuda.synchronize()
            assert ck.launch_counts()["zy_rfft_planar"] == 1
            _assert_zy_close(got, ck._zy_rfft_plain(x.double()))


@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    spec = torch.zeros((3, 8, 8, 5), dtype=torch.complex64, device=cuda_device)
    r = torch.view_as_real(spec)
    with pytest.raises(TypeError, match="float32"):
        ck.shell_bin_powers_fused(r[..., 0].double(), r[..., 1].double(), 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ck.shell_bin_powers_fused(r[..., 0].transpose(1, 2), r[..., 1].transpose(1, 2), 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ck.shell_bin_powers_fused(r[..., 1], r[..., 0], 3, 8)  # not the (re, im) halves
    odd = torch.view_as_real(torch.zeros((3, 9, 8, 5), dtype=torch.complex64, device=cuda_device))
    with pytest.raises(ValueError, match="even x and y"):
        ck.shell_bin_powers_fused(odd[..., 0], odd[..., 1], 3, 8)
    fold = torch.zeros((5, 8, 5), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ck.shell_bin_sums_folded_onepass(fold.double(), fold.double(), 3, 8, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ck.shell_bin_values_folded_rows(fold.transpose(0, 2), fold.transpose(0, 2), 3, 8, 8, 8)
    x = torch.zeros((2, 16, 12), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ck.zy_rfft_planar(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ck.zy_rfft_planar(x.transpose(1, 2))
    with pytest.raises(ValueError, match="extents"):
        ck.zy_rfft_planar(torch.zeros((1, 8, ck.ZY_MAX_EXTENT + 1), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 48), (16, 20, 15), (32, 32, 32), (32, 22, 26)])
def test_fused_path_on_cuda_matches_the_cpu_path(cuda_device, shape):
    from fava_tpu_torch.experiments import folded_bins, planar_dft
    from fava_tpu_torch.ops import spectra

    f = _fields(cuda_device, shape=shape, seed=7)
    nbins = max(shape) // 2 - 1
    ref = spectra.rfft_shell_sums(f[0].double().cpu(), [v.double().cpu() for v in f[1:]], nbins)
    paths = {
        "stacked cuFFT, B9": (lambda: planar_dft.rfft_shell_sums_fused(f[0], f[1:], nbins),
                              {"shell_bin_powers_fused": 1}),
        "B12, B9": (lambda: planar_dft.rfft_shell_sums_fused_zy(f[0], f[1:], nbins),
                    {"shell_bin_powers_fused": 1, "zy_rfft_planar": 3}),
        "pad8 fold, B11a": (lambda: folded_bins.rfft_shell_sums_folded(f[0], f[1:], nbins, "onepass"),
                            {"fold_quadrants_pair": 1, "shell_bin_sums_folded_onepass": 1}),
        "pad8 fold, B11b": (lambda: folded_bins.rfft_shell_sums_folded(f[0], f[1:], nbins, "rows"),
                            {"fold_quadrants_pair": 1, "shell_bin_values_folded": 1}),
    }
    for what, (run, expect) in paths.items():
        ck.reset_launch_counts()
        counts, sums = run()
        torch.cuda.synchronize()
        assert {k: v for k, v in ck.launch_counts().items() if v} == expect, what
        assert torch.equal(counts.cpu(), ref[0]), what
        assert float((sums.cpu() - ref[1]).abs().max() / ref[1].abs().max()) <= 1e-5, what


# The folded walk (K4, B4, B11a, B11b) and B9: z extents nzr = 1, 2, 3, 33,
# 257 and 513; x or y extents of 2 (no mirror rows).
WALK_SHAPES = [(4, 4, 1), (2, 6, 2), (6, 2, 4), (8, 6, 64), (4, 4, 512), (2, 2, 1024)]
WALK_BINS = [1, 2, 255, 511, ck.SHELL_MAX_BINS]


def _at_offset(t, floats):
    """A contiguous copy of ``t`` that starts ``floats`` elements past the
    start of its allocation (off 16 bytes unless a multiple of 4 floats,
    or of 2 complex values)."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = buf[floats:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WALK_SHAPES)
@pytest.mark.parametrize("nbins", WALK_BINS)
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (2, 3)])
def test_folded_walk_matches_plain(cuda_device, shape, nbins, offsets):
    """K4 (two channels, and one), B11b and B11a on folds at the given
    float offsets from 16 bytes (the same: float4 loads after a head;
    different: scalar loads), NaN in the pad rows past ny/2; B11a's counts
    exact."""
    nx, ny, nz = shape
    vols = [a.abs() for a in _fields(cuda_device, shape=(nx, ny, nz // 2 + 1), seed=nx + nz)[:2]]
    folds = [_at_offset(ck._fold_plain(v), o) for v, o in zip(vols, offsets)]
    padded = [_at_offset(p, o) for p, o in zip(_padded_folds(vols, ny), offsets)]
    ck.reset_launch_counts()
    got = {
        "K4": ck.shell_bin_values_folded(*folds, nbins, ny, nz),
        "B4": ck.shell_bin_values_folded_1ch(folds[1], nbins, ny, nz)[None],
        "B11b": torch.stack(ck.shell_bin_values_folded_rows(*padded, nbins, nx, ny, nz)),
    }
    counts, sums = ck.shell_bin_sums_folded_onepass(*padded, nbins, nx, ny, nz)
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "shell_bin_values_folded": 2, "shell_bin_values_folded_1ch": 1,
        "shell_bin_sums_folded_onepass": 1}
    ref = ck._onepass_plain(*(p.double() for p in padded), nbins, nx, ny, nz)
    assert torch.equal(counts, ref[0])
    torch.testing.assert_close(sums[:2], ref[1:], rtol=1e-10, atol=1e-300)
    torch.testing.assert_close(got["K4"], ref[1:], rtol=1e-10, atol=1e-300)
    torch.testing.assert_close(got["B11b"], ref[1:], rtol=1e-10, atol=1e-300)
    torch.testing.assert_close(got["B4"], ref[2:], rtol=1e-10, atol=1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WALK_SHAPES)
@pytest.mark.parametrize("nbins", WALK_BINS)
@pytest.mark.parametrize("layout", ["interleaved", "interleaved off 16", "planar", "planar off 16"])
def test_powers_walk_matches_plain(cuda_device, shape, nbins, layout):
    """B9 on cuFFT's interleaved output (at a complex offset of 0 or 1 from
    16 bytes) and on planar stacks (re and im at float offsets 0, or 1 and
    2): counts exact, sums to rtol 1e-10."""
    nx, ny, nz = shape
    spec = torch.fft.rfftn(torch.stack(_fields(cuda_device, shape=shape, seed=sum(shape))[1:]),
                           dim=(1, 2, 3), norm="forward")
    off = layout.endswith("off 16")
    if layout.startswith("interleaved"):
        r = torch.view_as_real(_at_offset(spec, 1) if off else spec)
        re, im = r[..., 0], r[..., 1]
        assert (re.data_ptr() % 16 == 8) == off
    else:
        re = _at_offset(spec.real.contiguous(), 1 if off else 0)
        im = _at_offset(spec.imag.contiguous(), 2 if off else 0)
    ck.reset_launch_counts()
    counts, sums = ck.shell_bin_powers_fused(re, im, nbins, nz)
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_powers_fused"] == 1
    ref = ck._powers_fused_plain(re.double(), im.double(), nbins, nz)
    assert torch.equal(counts, ref[0])
    torch.testing.assert_close(sums[:2], ref[1:], rtol=1e-10, atol=1e-300)


@pytest.mark.cuda
def test_walk_wrappers_refuse_nbins_beyond_the_kernels(cuda_device):
    """Past WALK_MAX_BINS shells the wrappers raise; at the last narrow
    nbins, the first wide one and WALK_MAX_BINS the occupancy query finds
    room for a block (the wide walk's BIN_MAX_WARPS warps beside its
    thresholds)."""
    nb = ck.WALK_MAX_BINS + 1
    fold = torch.zeros((5, 8, 5), device=cuda_device)
    spec = torch.view_as_real(torch.zeros((3, 8, 8, 5), dtype=torch.complex64, device=cuda_device))
    vol = torch.zeros((7, 6, 4), device=cuda_device)
    for run in (lambda: ck.shell_bin_values_folded(fold, fold, nb, 8, 8),
                lambda: ck.shell_bin_sums_folded_onepass(fold, fold, nb, 8, 8, 8),
                lambda: ck.shell_bin_powers_fused(spec[..., 0], spec[..., 1], nb, 8),
                lambda: ck.shell_bin_sums_unfolded(vol, vol, nb, 6)):
        with pytest.raises(ValueError, match="WALK_MAX_BINS"):
            run()
    for kind, args, channels in (("fava_shell_bin_folded_blocks_per_sm", (2, 1), 3),
                                 ("fava_shell_bin_powers_fused_blocks_per_sm", (1,), 3),
                                 ("fava_shell_bin_unfolded_blocks_per_sm", (2,), 2)):
        for nbins in (ck.SHELL_MAX_BINS, ck.SHELL_MAX_BINS + 1, ck.WALK_MAX_BINS):
            launch = ck.walk_launch(kind, args, channels, 10**6, nbins, cuda_device)
            assert launch["warps"] >= 1 and launch["blocks_per_sm"] >= 1
            if nbins > ck.SHELL_MAX_BINS:
                assert launch["warps"] == ck.BIN_MAX_WARPS and launch["smem"] == (nbins + 2) * 4


# The wide walk (past SHELL_MAX_BINS shells) on elongated volumes, beside
# the last narrow nbins: every wrapper of the walk, held to its f64 twin.
WIDE_SHAPES = [(16384, 4, 4), (8194, 6, 5)]
WIDE_BINS = [ck.SHELL_MAX_BINS, ck.SHELL_MAX_BINS + 1, 8191]
WIDE_KERNELS = ["K4", "B4", "B6", "B10", "B9", "B11a"]


def _wide_case(kernel, shape, nbins, device):
    """(launched kernel, got, ref): got [counts (B9, B11a)], sums from the
    kernel; ref the same from the plain twin on the same float32 values
    in float64."""
    nx, ny, nz = shape
    nzr = nz // 2 + 1
    t, lo = (a.abs() for a in _fields(device, shape=(nx, ny, nzr), seed=nx + nz)[:2])
    if kernel in ("K4", "B4", "B11a"):
        ft, fl = ck._fold_plain(t).contiguous(), ck._fold_plain(lo).contiguous()
        if kernel == "K4":
            return ("shell_bin_values_folded", ck.shell_bin_values_folded(ft, fl, nbins, ny, nz),
                    ck._shell_bin_folded_plain(ft.double(), fl.double(), nbins, ny, nz))
        if kernel == "B4":
            return ("shell_bin_values_folded_1ch", ck.shell_bin_values_folded_1ch(fl, nbins, ny, nz)[None],
                    ck._shell_bin_folded_plain(fl.double(), None, nbins, ny, nz))
        counts, sums = ck.shell_bin_sums_folded_onepass(ft, fl, nbins, nx, ny, nz)
        return ("shell_bin_sums_folded_onepass", torch.cat([counts[None], sums[:2]]),
                ck._onepass_plain(ft.double(), fl.double(), nbins, nx, ny, nz))
    if kernel == "B10":
        return ("shell_bin_sums_unfolded", ck.shell_bin_sums_unfolded(t, lo, nbins, nz),
                ck._shell_bin_unfolded_plain(t.double(), lo.double(), nbins, nz))
    if kernel == "B6":
        kx0, rows = nx // 8, nx // 4  # |kx| from nx/8 up: shells on both sides of 4095
        ct, cl = t[kx0 : kx0 + rows].contiguous(), lo[kx0 : kx0 + rows].contiguous()
        return ("shell_bin_values_rfft_chunk",
                ck.shell_bin_values_rfft_chunk(ct, cl, nbins, nx, nz, kx0)[:2],
                ck._shell_bin_unfolded_plain(ct.double(), cl.double(), nbins, nz, kx0, nx))
    spec = torch.fft.rfftn(torch.stack(_fields(device, shape=shape, seed=sum(shape))[1:]),
                           dim=(1, 2, 3), norm="forward")
    r = torch.view_as_real(spec)
    counts, sums = ck.shell_bin_powers_fused(r[..., 0], r[..., 1], nbins, nz)
    return ("shell_bin_powers_fused", torch.cat([counts[None], sums[:2]]),
            ck._powers_fused_plain(r[..., 0].double(), r[..., 1].double(), nbins, nz))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("nbins", WIDE_BINS)
@pytest.mark.parametrize("kernel", WIDE_KERNELS)
def test_wide_walk_matches_plain(cuda_device, kernel, shape, nbins):
    """K4 (2 channels), B4 (1), B6 (an x-chunk at kx0 > 0), B10, B9 and
    B11a at 4095 (narrow), 4096 and 8191 shells (wide): counts exact, sums
    within 1e-12 relative per shell (f64 sums in another order)."""
    ck.reset_launch_counts()
    name, got, ref = _wide_case(kernel, shape, nbins, cuda_device)
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {name: 1}
    ref = ref.to(got.device)
    if kernel in ("B9", "B11a"):
        assert torch.equal(got[0], ref[0])
        got, ref = got[1:], ref[1:]
    assert (ref[0] != 0).sum() > 0.2 * min(nbins, max(shape) // 2)  # many shells, not a few
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-300)


# ---------------------------------------------------------------------------
# The velocity diagnostics' densities are signed (helicity, transfer): the
# scalar shell binning (K3 + the single-channel walk, or B10) on signed
# input. K3 adds up to 4 signed float32 terms: its error is at most
# 3 * 2^-24 of the sum of their magnitudes, so each shell is held within
# 4 * 2^-24 of its sum of |p| (plus the walk's f64 1e-10); B10 sums the
# float32 values in f64 (1e-10 of the sum of |p|).


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 48), (16, 16, 16), (31, 32, 24), (32, 17, 20)])
def test_scalar_binning_of_signed_densities_matches_plain(cuda_device, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    p = _fields(cuda_device, shape=(nx, ny, nz // 2 + 1), seed=sum(shape))[1]  # signed
    assert (p < 0).any() and (p > 0).any()
    ck.reset_launch_counts()
    counts, got = ck.shell_bin_sums_rfft_scalar(p, nbins, nz)
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    if nx % 2 or ny % 2:
        assert launches["shell_bin_sums_unfolded"] == 1 and launches["fold_quadrants_pair"] == 0
        bound = 1e-10
    else:
        assert launches["fold_quadrants_pair"] == launches["shell_bin_values_folded_1ch"] == 1
        bound = 4 * 2.0**-24 + 1e-10
    ref_counts, ref = ck.shell_bin_sums_rfft_scalar(p.double().cpu(), nbins, nz)
    _, ref_abs = ck.shell_bin_sums_rfft_scalar(p.double().abs().cpu(), nbins, nz)
    assert torch.equal(counts.cpu(), ref_counts)
    assert ((got.cpu() - ref).abs() <= bound * ref_abs).all()
    assert (ref < 0).any()  # shells whose sums cancel to negative values


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 20, 3 * 100003])
def test_pdf2d_on_heavy_tailed_qr_samples_matches_plain(cuda_device, n):
    """Q and R of random float32 3x3 gradient tensors (Q ~ products of two
    normals, R of three: heavy tails) against Q_w-scaled edges, as
    gradient_invariant_pdfs bins them: counts exact."""
    g = torch.randn((3, 3, n), generator=torch.Generator().manual_seed(n)).float().to(cuda_device)
    P = -(g[0, 0] + g[1, 1] + g[2, 2])
    Q = 0.5 * (P * P - sum(g[i, j] * g[j, i] for i in range(3) for j in range(3)))
    R = -torch.linalg.det(g.permute(2, 0, 1))
    qw = float(((g[2, 1] - g[1, 2]) ** 2 + (g[0, 2] - g[2, 0]) ** 2 + (g[1, 0] - g[0, 1]) ** 2)
               .double().mean() / 4.0)
    xe = np.linspace(-8.0 * qw, 8.0 * qw, 101)
    ye = np.linspace(-8.0 * qw**1.5, 8.0 * qw**1.5, 101)
    Q, R = Q.contiguous(), R.contiguous()
    ck.reset_launch_counts()
    got = ck.pdf2d_counts(Q, R, xe, ye)
    torch.cuda.synchronize()
    assert ck.launch_counts()["pdf2d_counts"] == 1
    ref = ck._pdf2d_plain(Q.double(), R.double(), xe, ye)
    assert torch.equal(got, ref)
    assert 0 < int(ref.sum()) < n  # the tails fall outside the range


def _velocity_runs(m):
    return {
        "helmholtz": m.helmholtz_decomposition,
        "vorticity": m.vorticity,
        "dilatation": m.dilatation,
        "enstrophy": m.enstrophy_spectra,
        "helicity": m.helicity_spectra,
        "transfer": lambda: m.transfer_spectra(dealias=True),
        "decomposed": lambda: m.decomposed_kinetic_energy_spectra(weighted=True),
        "anisotropic": lambda: m.anisotropic_kinetic_energy_spectra(axis=0),
        "summary": m.turbulence_summary,
        "gradients": lambda: m.velocity_gradient_statistics(boundary="interior"),
        "qr": m.gradient_invariant_pdfs,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (31, 32, 24)])
def test_velocity_diagnostics_on_cuda_match_the_cpu_path(cuda_device, shape):
    """The 11 analyses on float32 fields against the float64 CPU path on
    the same values: spectra and fields within 1e-5 of scale (float32
    transforms), transfer within 1e-5 of sum |T|, the summary's real-space
    entries 1e-10 (float64 sums), its spectral ones 1e-5, the gradient
    moments 1e-4 of each table's scale (float32 differences), the Q-R
    counts within 1e-3 of the samples moved; K3 + B4 (B10 when x is odd)
    and B8 launched as the wrappers' counts say."""
    rng = np.random.default_rng(sum(shape))
    arrays = {"dens": 1.0 + 0.5 * rng.random(shape), "pres": 1.0 + rng.random(shape)}
    arrays.update({f"vel{a}": rng.standard_normal(shape) for a in "xyz"})
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    odd = shape[0] % 2 == 1
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.from_arrays(arrays, device=dev)
        outs[dev] = {}
        for name, fn in _velocity_runs(m).items():
            ck.reset_launch_counts()
            outs[dev][name] = fn()
            n = ck.launch_counts()
            if dev != "cuda":
                continue
            bins = {"enstrophy": 1, "helicity": 1, "transfer": 1, "decomposed": 3}.get(name, 0)
            if odd:
                assert n["shell_bin_sums_unfolded"] == bins and n["fold_quadrants_pair"] == 0, name
            else:
                assert n["fold_quadrants_pair"] == n["shell_bin_values_folded_1ch"] == bins, name
            assert n["pdf2d_counts"] == (name == "qr"), name
    cpu, gpu = outs["cpu"], outs["cuda"]
    for name in ("enstrophy", "helicity", "decomposed"):
        _spectra_close({k: v for k, v in gpu[name].items() if k != "k"},
                       {k: v for k, v in cpu[name].items() if k != "k"}, 1e-5)
    aniso = {k: v for k, v in cpu["anisotropic"].items() if not k.startswith("k_")}
    _spectra_close(gpu["anisotropic"], aniso, 1e-5)
    scale = np.abs(cpu["transfer"]["transfer"]).sum()
    for key in ("transfer", "flux"):
        assert np.abs(gpu["transfer"][key] - cpu["transfer"][key]).max() <= 1e-5 * scale
    for part in ("solenoidal", "compressive"):
        _spectra_close(gpu["helmholtz"][part], cpu["helmholtz"][part], 1e-5)
    _spectra_close(gpu["vorticity"], cpu["vorticity"], 1e-5)
    _spectra_close(gpu["dilatation"], cpu["dilatation"], 1e-5)
    real_space = {"u_rms", "kinetic_energy", "kinetic_energy_density", "mean_s", "sigma_s",
                  "mach_rms", "mach_max", "sound_speed_mean"}
    for key, r in cpu["summary"].items():
        tol = 1e-10 if key in real_space else 1e-5
        assert abs(gpu["summary"][key] - r) <= tol * max(abs(r), 1e-3), (key, gpu["summary"][key], r)
    c2 = cpu["gradients"]["gradient_moment2"]
    natural = {"gradient_mean": np.sqrt(c2), "gradient_moment2": c2, "gradient_moment3": c2**1.5,
               "gradient_moment4": c2**2, "velocity_mean": np.sqrt(cpu["gradients"]["velocity_variance"])}
    for key, r in cpu["gradients"].items():
        r = np.asarray(r)
        scale = natural.get(key, np.abs(r) if "skewness" not in key else 1.0)
        if key in ("enstrophy", "dilatation_msq"):
            scale = cpu["gradients"]["pseudo_dissipation"]
        err = np.abs(np.asarray(gpu["gradients"][key]) - r) / np.maximum(scale, 1e-300)
        assert err.max() <= 1e-4, (key, err.max())
    moved = np.abs(gpu["qr"]["counts"] - cpu["qr"]["counts"]).sum() / 2
    assert moved <= 1e-3 * np.prod(shape), moved
    np.testing.assert_allclose(gpu["qr"]["q_w"], cpu["qr"]["q_w"], rtol=1e-5)


# ---------------------------------------------------------------------------
# The filtered flux, the two-point and velocity correlations and the four
# streamed statistics drivers on the card against the CPU path (the same
# float32 values in float64). Correlation lines (normalised by R(0)) within
# 1e-5 (float32 transforms); integral scales within 1e-5 * dx * (j + 3)
# where both runs cross zero at the same sample j (the trapezoid's j
# samples and the interpolated triangle); the flux statistics within 1e-5
# of the mean of sum_ij (|bar(rho u_i u_j)| + |rho_b u~_i u~_j|) |d_j u~_i|
# (the terms tau is the difference of); the summary's real-space entries
# 1e-10 and spectral ones 1e-5; gradient moments of each table's natural
# scale 1e-10 streamed against in-core on the card (the same float32
# differences, float64 sums) and 1e-4 against the CPU (float64 differences).


def _corr_close(got, ref, tol=1e-5):
    for key, r in ref.items():
        g = got[key]
        if key.split("_")[0] in ("R", "f", "g", "r"):
            r = np.asarray(r)
            ok = ~np.isnan(r)
            assert np.array_equal(np.isnan(g), np.isnan(r)), key
            assert np.abs(np.asarray(g)[ok] - r[ok]).max() <= tol, key
        elif key == "variance":
            assert abs(g - r) <= tol * abs(r), key
        elif key.startswith(("L11_", "L22_", "integral_scale_")):
            ax = key[-1]
            line = {"L11": "f_", "L22": "g_", "integral": "R_"}[key.split("_")[0]] + ax

            def cross(v):
                neg = np.nonzero(np.asarray(v) <= 0)[0]
                return int(neg[0]) if neg.size else len(v)

            j = cross(ref[line])
            if cross(got[line]) == j:
                assert abs(g - r) <= tol * float(ref[f"r_{ax}"][1]) * (j + 3), key


def _flux_scales(cg, vels, dens, kcs, kernel):
    """Per cutoff, the float64 mean of sum_ij (|bar(rho u_i u_j)| +
    |rho_b u~_i u~_j|) |d_j u~_i| (CPU, float64)."""
    from fava_tpu_torch.ops.velocity import _k_grids

    shape = tuple(vels[0].shape)
    f = {"rho": torch.fft.rfftn(dens), "mom": [torch.fft.rfftn(dens * v) for v in vels],
         "qq": {(i, j): torch.fft.rfftn(dens * vels[i] * vels[j]) for i in range(3)
                for j in range(i, 3)}}
    k2 = cg._k2_int(shape, torch.float64, "cpu")
    dks = _k_grids(shape, torch.float64, "cpu", None, True)
    out = []
    for kc in kcs:
        g = cg._filter_gain(k2, float(kc), kernel)

        def bar(s):
            return torch.fft.irfftn(g * s, s=shape)

        rb = bar(f["rho"])
        ub = [bar(s) / rb for s in f["mom"]]
        drb = [bar(1j * dks[j] * f["rho"]) for j in range(3)]
        total = 0.0
        for i in range(3):
            for j in range(3):
                du = (bar(1j * dks[j] * f["mom"][i]) - ub[i] * drb[j]) / rb
                q = bar(f["qq"][(min(i, j), max(i, j))])
                total += float(((q.abs() + (rb * ub[i] * ub[j]).abs()) * du.abs()).mean())
        out.append(total)
    return np.array(out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 48), (31, 32, 24)])
def test_correlation_volume_binning_matches_plain(cuda_device, shape):
    """two_point_correlation's shell average of a signed correlation
    half-volume: K3 + B4 for even x and y, B10 otherwise, against the plain
    versions (4 * 2^-24 + 1e-10, B10 1e-10, of each shell's sum of |corr|)."""
    from fava_tpu_torch.ops.velocity import _irfft, _rfft

    f = _fields(cuda_device, shape=shape, seed=3)[1]
    fh = _rfft(f - f.double().mean().float())
    corr = _irfft(fh.real.square() + fh.imag.square(), shape) / np.prod(shape)
    p = corr[..., : shape[2] // 2 + 1].contiguous()
    nbins = min(shape) // 2
    ck.reset_launch_counts()
    counts, got = ck.shell_bin_sums_rfft_scalar(p, nbins, shape[2])
    torch.cuda.synchronize()
    n = ck.launch_counts()
    if shape[0] % 2:
        assert n["shell_bin_sums_unfolded"] == 1 and n["fold_quadrants_pair"] == 0
        bound = 1e-10
    else:
        assert n["fold_quadrants_pair"] == n["shell_bin_values_folded_1ch"] == 1
        bound = 4 * 2.0**-24 + 1e-10
    ref_counts, ref = ck.shell_bin_sums_rfft_scalar(p.double().cpu(), nbins, shape[2])
    _, ref_abs = ck.shell_bin_sums_rfft_scalar(p.double().abs().cpu(), nbins, shape[2])
    assert torch.equal(counts.cpu(), ref_counts)
    assert ((got.cpu() - ref).abs() <= bound * ref_abs).all()
    assert (ref < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (31, 32, 24)])
def test_a8c_analyses_on_cuda_match_the_cpu_path(cuda_device, shape):
    """The flux sweep (gaussian Favre, with pressure), both correlations and
    sgs_flux_fields on float32 fields, against the float64 CPU path."""
    from fava_tpu_torch.ops import coarse_grain as cg

    rng = np.random.default_rng(sum(shape) + 1)
    arrays = {"dens": 1.0 + 0.5 * rng.random(shape), "pres": 1.0 + rng.random(shape)}
    arrays.update({f"vel{a}": rng.standard_normal(shape) for a in "xyz"})
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.from_arrays(arrays, device=dev)
        ck.reset_launch_counts()
        outs[dev] = {
            "tp": m.two_point_correlation("dens"),
            "vc": m.velocity_correlations(),
            "flux": m.filtered_kinetic_energy_flux(cutoffs=(2.0, 4.0, 8.0)),
        }
        if dev == "cuda":
            n = ck.launch_counts()
            key = "shell_bin_sums_unfolded" if shape[0] % 2 else "shell_bin_values_folded_1ch"
            assert n[key] == 1 and sum(n.values()) == (1 if shape[0] % 2 else 2), n
    cpu, gpu = outs["cpu"], outs["cuda"]
    _corr_close(gpu["tp"], cpu["tp"])
    _corr_close(gpu["vc"], cpu["vc"])
    c = {k: torch.tensor(v, dtype=torch.float64) for k, v in arrays.items()}
    scales = _flux_scales(cg, [c["velx"], c["vely"], c["velz"]], c["dens"], (2.0, 4.0, 8.0),
                          "gaussian")
    for key in ("pi_mean", "pi_rms"):
        assert (np.abs(gpu["flux"][key] - cpu["flux"][key]) <= 1e-5 * scales).all(), key
    vg = [torch.tensor(arrays[f"vel{a}"], device=cuda_device) for a in "xyz"]
    fields = cg.sgs_flux_fields(*vg, cutoff=4.0, dens=torch.tensor(arrays["dens"], device=cuda_device),
                                pres=torch.tensor(arrays["pres"], device=cuda_device))
    ref = cg.sgs_flux_fields(c["velx"], c["vely"], c["velz"], cutoff=4.0, dens=c["dens"],
                             pres=c["pres"])
    assert fields["pi"].device.type == "cuda" and fields["pi"].dtype == torch.float32
    err = float((fields["pi"].double().cpu() - ref["pi"]).abs().mean())
    assert err <= 1e-5 * scales[1]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_streamed_statistics_on_cuda_match_the_cpu_path_and_incore(cuda_device, tmp_path, wire):
    """The four streamed drivers through the mesh (pinned staging, side
    stream) on the card against the same drivers on the CPU and against the
    card's in-core analyses (bf16 wire: against the CPU's bf16 run)."""
    fields = ("dens", "velx", "vely", "velz", "pres", "gamc")
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(32, 24, 20), seed=8,
                                fields=fields)
    calls = {
        "summary": lambda m, **kw: m.turbulence_summary(**kw),
        "gradients": lambda m, **kw: m.velocity_gradient_statistics(
            **{k: v for k, v in kw.items() if k != "chunk_rows"}),
        "vc": lambda m, **kw: m.velocity_correlations(**kw),
        "lines": lambda m, **kw: m.two_point_correlation("dens", **kw),
    }
    stream = {"streamed": True, "slab_rows": 8, "chunk_rows": 4, "wire_dtype": wire}
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.FLASH(tmp_path, device=dev)
        m.load(file_type="uni")
        ck.reset_launch_counts()
        outs[dev] = {k: fn(m, **stream) for k, fn in calls.items()}
        if dev == "cuda":
            assert not any(ck.launch_counts().values())
            outs["incore"] = {k: fn(m) for k, fn in calls.items()}
    for ref_name in ("cpu", "incore") if wire is None else ("cpu",):
        ref, gpu = outs[ref_name], outs["cuda"]
        real = {"u_rms", "kinetic_energy", "kinetic_energy_density", "mean_s", "sigma_s",
                "mach_rms", "mach_max", "sound_speed_mean"}
        assert list(gpu["summary"]) == list(ref["summary"])
        for key, r in ref["summary"].items():
            tol = 1e-10 if key in real and (wire is None or ref_name == "cpu") else 1e-5
            assert abs(gpu["summary"][key] - r) <= tol * max(abs(r), 1e-3), (ref_name, key)
        c2 = ref["gradients"]["gradient_moment2"]
        natural = {"gradient_mean": np.sqrt(c2), "gradient_moment2": c2, "gradient_moment3": c2**1.5,
                   "gradient_moment4": c2**2}
        tol = 1e-10 if ref_name == "incore" else 1e-4  # the CPU differences are float64
        for key, scale in natural.items():
            err = np.abs(gpu["gradients"][key] - ref["gradients"][key]) / scale
            assert err.max() <= tol, (ref_name, key, err.max())
        _corr_close(gpu["vc"], ref["vc"])
        _corr_close(gpu["lines"], {k: v for k, v in ref["lines"].items() if k in gpu["lines"]})


@pytest.mark.cuda
def test_particle_statistics_on_cuda_match_the_cpu_path(cuda_device, tmp_path):
    path = synthetic.make_particle_file(tmp_path / "rt_hdf5_part_0001", nparticles=100_003, seed=2)
    got = {}
    for dev in ("cuda", "cpu"):
        p = fava_tpu_torch.FlashParticles(path, device=dev)
        p.load()
        assert p.device_column("velx").device.type == dev
        got[dev] = p.statistics()
    assert sorted(got["cuda"]) == sorted(got["cpu"])
    for f, ref in got["cpu"].items():
        np.testing.assert_allclose(got["cuda"][f]["mean"], ref["mean"], rtol=1e-12)
        np.testing.assert_allclose(got["cuda"][f]["rms"], ref["rms"], rtol=1e-12)
        assert (got["cuda"][f]["min"], got["cuda"][f]["max"]) == (ref["min"], ref["max"])


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [None, (1.0, 1.0, 1.0)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pair_structure_on_cuda_matches_the_cpu_path(cuda_device, lengths, dtype):
    from fava_tpu_torch.ops.structure import pair_indices, pair_structure_functions

    rng = np.random.default_rng(61)
    pos = rng.random((200_000, 3)).astype(dtype)
    vel = rng.standard_normal((200_000, 3)).astype(dtype)
    np.testing.assert_array_equal(pair_indices(9, 4096, 200_000, device="cuda").cpu().numpy(),
                                  pair_indices(9, 4096, 200_000, device="cpu").numpy())
    kw = dict(num_pairs=1 << 20, nbins=24, orders=10, lengths=lengths, seed=9)
    gpu = pair_structure_functions(pos, vel, device="cuda", **kw)
    cpu = pair_structure_functions(pos, vel, device="cpu", **kw)
    np.testing.assert_array_equal(gpu["counts"], cpu["counts"])
    np.testing.assert_allclose(gpu["separations"], cpu["separations"], rtol=1e-12)
    for comp in ("longitudinal", "transverse"):
        for o, ref in cpu[comp].items():
            np.testing.assert_allclose(gpu[comp][o], ref, rtol=1e-12, err_msg=f"{comp} {o}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,nanchors", [(5000, 300), (300_000, 1024)])
def test_nn_sweep_on_cuda_matches_the_cpu_path(cuda_device, n, nanchors):
    from fava_tpu_torch.analysis import dispersion as disp

    rng = np.random.default_rng(3)
    coords = rng.uniform(0.0, 1.0, size=(n, 3))
    coords[100:200] = coords[0] + 1e-4 * rng.standard_normal((100, 3))  # a tight cluster
    anchors = rng.choice(n, size=nanchors, replace=False)
    anchors[:5] = [0, 100, 101, 150, 199]
    gpu = disp._nearest_neighbor_pairs(coords, anchors, "cuda")
    np.testing.assert_array_equal(gpu, disp._nearest_neighbor_pairs(coords, anchors, "cpu"))
    if n <= 5000:
        np.testing.assert_array_equal(gpu, disp._nn_host(coords, anchors))


# (nx, ny, nz, d): y-slabs of d ranks; every rank's slab is binned at its
# offset r*ny/d (nonzero but for rank 0), the Nyquist column ny/2 inside one.
SLAB_CASES = [(32, 32, 48, 4), (16, 24, 20, 3), (15, 16, 18, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz,d", SLAB_CASES)
def test_b6_on_transposed_y_slabs_matches_plain(cuda_device, nx, ny, nz, d):
    """The sharded spectra's binning: B6 on each rank's transposed y-slab
    (global y as its slab axis at kx0 = r*ny/d) against its plain twin,
    one launch a slab, and the slabs' sums against B10 on the whole
    half-spectrum's powers (float64 sums in another order; the folded
    path would add its float32 fold's rounding)."""
    from fava_tpu_torch.ops import spectra

    f = _fields(cuda_device, shape=(nx, ny, nz), seed=ny + d)
    nbins = max(nx, ny, nz) // 2 - 1
    ffts = spectra.kinetic_transforms(f[0], f[1:])
    cols = ny // d
    ck.reset_launch_counts()
    acc = torch.zeros(3, nbins, dtype=torch.float64, device=cuda_device)
    for r in range(d):
        lo = r * cols
        jy = torch.arange(lo, lo + cols, device=cuda_device)
        ky = spectra._wavenumbers(ny, torch.float32, cuda_device)[lo : lo + cols]
        total, longi = spectra.rfft_power_volumes([a[:, lo : lo + cols] for a in ffts],
                                                  (nx, ny, nz), jy=jy, ky=ky)
        t, lg = total.transpose(0, 1).contiguous(), longi.transpose(0, 1).contiguous()
        got = ck.shell_bin_values_rfft_chunk(t, lg, nbins, ny, nz, lo)
        ref = ck._shell_bin_unfolded_plain(t.double(), lg.double(), nbins, nz, lo, ny)
        torch.testing.assert_close(got[:2], ref, rtol=1e-10, atol=1e-300)
        acc += spectra.slab_shell_sums([a[:, lo : lo + cols] for a in ffts], (nx, ny, nz), lo, nbins)
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_values_rfft_chunk"] == 2 * d
    whole = ck.shell_bin_sums_unfolded(*spectra.rfft_power_volumes(ffts, (nx, ny, nz)), nbins, nz)
    torch.testing.assert_close(acc[:2], whole, rtol=1e-10, atol=1e-300)


# (nx, ny, nz, d): x-slabs of d ranks of a correlation half-volume, even
# and odd nz, ny != nx.
CORR_SLAB_CASES = [(32, 24, 48, 4), (16, 8, 25, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,nz,d", CORR_SLAB_CASES)
def test_b6_on_correlation_x_slabs_matches_plain(cuda_device, nx, ny, nz, d):
    """The sharded two-point correlation's binning: the one-channel B6 on
    each rank's (nx/d, ny, nz//2+1) x-slab of the signed correlation
    half-volume at kx0 = r*nx/d against its plain twin on the same float32
    values in float64, one launch a slab, and the slabs' sums against B10
    on the whole half-volume (1e-10 of each shell's sum of |corr|: float64
    sums in another order)."""
    shape = (nx, ny, nz)
    f = _fields(cuda_device, shape=shape, seed=nz + d)[1]
    fh = torch.fft.rfftn(f - f.double().mean().float(), norm="forward")
    corr = torch.fft.irfftn(fh.real.square() + fh.imag.square(), s=shape, norm="forward")
    half = corr[..., : nz // 2 + 1]
    nbins = min(shape) // 2
    rows = nx // d
    ck.reset_launch_counts()
    acc = torch.zeros(1, nbins, dtype=torch.float64, device=cuda_device)
    for r in range(d):
        p = half[r * rows : (r + 1) * rows].contiguous()
        got = ck.shell_bin_values_rfft_chunk(p, None, nbins, full_nx=nx, full_nz=nz, kx0=r * rows)
        ref = ck._shell_bin_unfolded_plain(p.double(), None, nbins, nz, r * rows, nx)
        ref_abs = ck._shell_bin_unfolded_plain(p.double().abs(), None, nbins, nz, r * rows, nx)
        assert ((got - ref).abs() <= 1e-10 * ref_abs).all(), r
        acc += got
    torch.cuda.synchronize()
    assert ck.launch_counts()["shell_bin_values_rfft_chunk_1ch"] == d
    whole = ck.shell_bin_sums_unfolded(half.contiguous(), None, nbins, nz)
    whole_abs = ck._shell_bin_unfolded_plain(half.double().abs(), None, nbins, nz)
    assert ((acc - whole).abs() <= 1e-10 * whole_abs).all()


@pytest.mark.cuda
def test_sharded_step_in_a_one_rank_nccl_world(cuda_device):
    """The mesh branch of the flagship step and the pod step in a one-rank
    NCCL world against the single-device step: counts exact, spectra
    within 1e-5 of scale (two float32 transform decompositions), profiles
    rtol 1e-9."""
    import torch.distributed as dist

    from fava_tpu_torch import parallel

    f = _fields(cuda_device, shape=(32, 32, 48), seed=8)
    try:
        mesh = parallel.make_device_mesh((1,), device="cuda")
        pod = parallel.make_device_mesh((1, 1), ("snap", "space"), device="cuda")
        ck.reset_launch_counts()
        got = flagship.uniform_analysis_step(*f, mesh=mesh)
        series = flagship.sharded_series_analysis_step(*(a[None] for a in f), mesh=pod)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ck.launch_counts().items() if v}
        assert launches == {"shell_bin_values_rfft_chunk": 2, "row_moments": 2,
                            "centered_row_moments": 2}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ref = flagship.uniform_analysis_step(*f)
    for out in (got, {k: v[0] for k, v in series.items()}):
        assert torch.equal(out["spectra_counts"], ref["spectra_counts"])
        for key, want in ref.items():
            if key.startswith("spectra_"):
                scale = float(want.abs().max())
                assert float((out[key] - want).abs().max()) <= 1e-5 * scale, key
            else:
                torch.testing.assert_close(out[key], want, rtol=1e-9, atol=1e-12)


def _amr_mesh(device, tmp_path):
    path = synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0001", ncells=(16, 16, 16),
                                   nblks=(4, 1, 1), refine={0: 2, 1: 3, 3: 2})
    mesh = fava_tpu_torch.mesh.FLASH(path, device=device)
    mesh.load()
    return mesh


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3, 8])
def test_block_moments_on_leaf_shares_equal_one_launch(cuda_device, tmp_path, parts):
    """K5/K6 on each share of the zero-padded leaf list, joined and
    trimmed, equal the single launch bit for bit, one launch a share."""
    from fava_tpu_torch.ops import profiles
    from fava_tpu_torch.parallel import Placement

    mesh = _amr_mesh(cuda_device, tmp_path)
    data, geom = mesh._profile_fields(), mesh._profile_geometry(0)
    whole = torch.cat(profiles._stack_stats(data, geom))
    ck.reset_launch_counts()
    joined = torch.cat([torch.cat(profiles._share_stats(
        profiles._leaf_fields(data, geom, Placement(0, r, parts)), geom)) for r in range(parts)], dim=1)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ck.launch_counts().items() if v}
    assert launches == {"block_row_moments": parts, "block_centered_row_moments": parts}
    nleaf = geom.blocklist.size
    sizes = tuple(t.shape[0] for t in profiles._stack_stats(data, geom))
    assert torch.equal(torch.cat(profiles._split_joined(joined, sizes, geom)), whole)
    assert not joined[:, nleaf:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_regrid_slabs_equal_the_whole_regrid(cuda_device, tmp_path, parts):
    """K7 on each rank's slab from its local stack of bmax blocks, copied
    from the host arrays that from_amr passes, stacked, equals the single
    regrid exactly (injection is a copy)."""
    mesh = _amr_mesh(cuda_device, tmp_path)
    names = ["dens", "velx"]
    data = {k: mesh._field_stack(k) for k in names}
    plan = regrid.RegridPlan(block_bounds=mesh.block_bounds, node_type=mesh.node_type,
                             refine_level=mesh.refine_level, ncells_vec=mesh.nCellsVec,
                             nblks_vec=mesh.nBlksVec, ndim=3)
    whole = regrid.regrid_fields(plan, data, names)
    splan = regrid.ShardedRegridPlan(plan, parts)
    assert splan.bmax < mesh.nblocks
    ck.reset_launch_counts()
    # from_amr's inputs: a mesh whose fields are not loaded hands over
    # host arrays read from the file, copied to the card block by block.
    cold = fava_tpu_torch.mesh.FLASH(mesh.filename, device=cuda_device)
    cold.load()
    hosts = {k: cold._host_field_stack(k) for k in names}
    assert all(isinstance(h, np.ndarray) for h in hosts.values())
    slabs = [regrid.regrid_fields_slab(splan, r, hosts, names, cuda_device,
                                       fava_tpu_torch.utils.field_dtype(cuda_device))
             for r in range(parts)]
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {"regrid_fields": parts}
    for k in names:
        assert torch.equal(torch.cat([sl[k] for sl in slabs]), whole[k])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("weight", ["volume", "mass"])
def test_weighted_b8_on_stack_slabs_matches_plain(cuda_device, d, weight):
    """The AMR-side pdf2d of a sharded ``from_amr`` output: the weighted B8
    on each rank's (1, nx/d, ny, nz) slab of the stack and of its weights
    (the cell volume, or times dens) against its plain twin on the same
    float32 values in float64, one launch a slab, and the slabs' sums
    against the plain twin on the whole stack (weighted sums rtol 1e-12)."""
    dens, velx = (f[None] for f in _fields(cuda_device)[:2])
    w = torch.full_like(dens, 0.125)
    if weight == "mass":
        w = w * dens
    nx = dens.shape[1]
    xe = np.linspace(float(dens.min()), float(dens.max()), 13)
    ye = np.linspace(float(velx.min()), float(velx.max()), 11)
    rows = nx // d
    acc = torch.zeros((12, 10), dtype=torch.float64, device=cuda_device)
    for r in range(d):
        x, y, ws = (t.narrow(1, r * rows, rows) for t in (dens, velx, w))
        ck.reset_launch_counts()
        got = ck.pdf2d_counts(x, y, xe, ye, weights=ws)
        torch.cuda.synchronize()
        assert {k: v for k, v in ck.launch_counts().items() if v} == {"pdf2d_weighted": 1}
        ref = ck._pdf2d_plain(x.double(), y.double(), xe, ye, ws.double())
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=0)
        acc += got
    whole = ck._pdf2d_plain(dens.double(), velx.double(), xe, ye, w.double())
    torch.testing.assert_close(acc, whole, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_device_trace_captures_k1_inside_its_span(cuda_device, tmp_path):
    """``device_trace`` on the card records K1's launch by its CUDA name,
    once, inside the ``annotate`` span around it."""
    import json
    import re

    from fava_tpu_torch.utils import profiling

    f = _fields(cuda_device)
    ck.row_moments_volume(*f)  # built and warm
    torch.cuda.synchronize()
    with profiling.device_trace(tmp_path, device="cuda"):
        with profiling.annotate("k1_span"):
            ck.row_moments_volume(*f)
            torch.cuda.synchronize()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and re.search(r"(?<![A-Za-z_])row_moments_kernel", e["name"])]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "k1_span"]
    assert len(k1) == 1 and len(spans) == 1
    s, k = spans[0], k1[0]
    assert s["ts"] <= k["ts"] and k["ts"] + k["dur"] <= s["ts"] + s["dur"]


@pytest.mark.cuda
def test_launch_nan_check_names_the_kernel(cuda_device):
    """Under ``enable_checks`` a NaN in K4's output (from a NaN planted in
    its input power) raises FloatingPointError naming the kernel; after
    ``disable_checks`` it goes through."""
    from fava_tpu_torch.utils import debug

    g = torch.Generator(device=cuda_device).manual_seed(3)
    total = torch.rand((9, 9, 9), generator=g, device=cuda_device)
    longi = torch.rand((9, 9, 9), generator=g, device=cuda_device)
    total[1, 1, 1] = float("nan")
    try:
        debug.enable_checks()
        with pytest.raises(FloatingPointError, match="shell_bin_values_folded"):
            ck.shell_bin_values_folded(total, longi, 7, 16, 16)
        ck.shell_bin_values_folded(longi, longi, 7, 16, 16)  # clean: no error
    finally:
        debug.disable_checks()
    assert torch.isnan(ck.shell_bin_values_folded(total, longi, 7, 16, 16)).any()
