"""fava_tpu_torch's kernel modules held to fava_tpu on the CPU, in float64.

On the CPU every wrapper in fava_tpu_torch.ops.cuda_kernels runs its
plain PyTorch version. fava_tpu runs as its own tests run it: its Pallas
kernels in interpret mode (pk.FORCE_INTERPRET, tests/test_pallas_kernels.py)
and its jnp references. Inputs are made from a seed with numpy and
handed to both packages. Tolerances:

* counts: exact (integer weights summed in float64);
* row moments and shell sums: rtol 1e-10, atol 1e-12, as fava_tpu's own
  float64 interpret tests use — the two sides add up to ~2e5 terms in
  different orders;
* fold: rtol 1e-14 — each output is a sum of <= 4 positive terms whose
  order may differ;
* regrid: exact (values are copied);
* joint histogram: counts exact; weighted sums rtol 1e-12 against numpy
  and rtol 2e-6 against fava_tpu's kernel, which sums each 65,536-sample
  step in float32 on the MXU.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fava_tpu.io import synthetic as jsynthetic
from fava_tpu.mesh import FLASH as JFlashAMR
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu.ops import pallas_pdf2d
from fava_tpu.ops import pallas_regrid
from fava_tpu.ops import profiles as jprofiles
from fava_tpu.ops import regrid as jregrid
from fava_tpu.ops import spectra as jspectra
from fava_tpu_torch.ops import _build
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import profiles as tprofiles
from fava_tpu_torch.ops import regrid as tregrid
from fava_tpu_torch.ops import spectra as tspectra

# Shapes of tests/test_pallas_kernels.py::test_shell_bin_folded_v2_matches_jnp:
# odd nz, several x blocks, nz > 2*128, and ny=126 (several row chunks).
BIN_SHAPES = [(16, 16, 16), (16, 16, 9), (32, 16, 16), (16, 16, 400), (16, 126, 16)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def force_interpret():
    pk.FORCE_INTERPRET = True
    yield
    pk.FORCE_INTERPRET = False


def _t(a):
    return torch.tensor(np.asarray(a))


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    dens = 1.0 + 0.5 * rng.random(shape)
    return [dens] + [rng.standard_normal(shape) for _ in range(3)]


def _powers(shape, seed):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    half = (nx, ny, nz // 2 + 1)
    return np.abs(rng.standard_normal(half)), np.abs(rng.standard_normal(half))


# ---------------------------------------------------------------------------
# K1 / K2: row moments


# (8, 8, 128) and (4, 16, 256) meet fava_tpu's Pallas constraint
# (nz % 128 == 0, ny % 8 == 0) and run its interpret-mode kernels; 16^3
# takes its jnp fallback.
MOMENT_SHAPES = [(8, 8, 128), (4, 16, 256), (16, 16, 16)]


@pytest.mark.parametrize("shape", MOMENT_SHAPES)
def test_row_moments_match_fava_tpu(force_interpret, shape):
    f = _fields(shape, seed=sum(shape))
    assert pk._pallas_ok(shape) == (shape[2] % 128 == 0)
    ref = np.asarray(pk.row_moments_volume(*map(jnp.asarray, f)))
    got = ck.row_moments_volume(*map(_t, f))
    assert got.shape == (13, shape[0]) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", MOMENT_SHAPES)
def test_centered_row_moments_match_fava_tpu(force_interpret, shape):
    f = _fields(shape, seed=3 * sum(shape))
    means = np.stack([v.mean(axis=(1, 2)) for v in f[1:]])
    ref = np.asarray(pk.centered_row_moments(*map(jnp.asarray, f), jnp.asarray(means)))
    got = ck.centered_row_moments(*map(_t, f), _t(means))
    assert got.shape == (9, shape[0]) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# K3 / K4: fold and folded shell binning


@pytest.mark.parametrize("shape", BIN_SHAPES)
def test_fold_quadrants_pair_matches_fava_tpu(force_interpret, shape):
    nx, ny, _ = shape
    total, longi = _powers(shape, seed=nx * ny)
    ref = [np.asarray(a) for a in pk.fold_quadrants_pair(jnp.asarray(total), jnp.asarray(longi))]
    got = ck.fold_quadrants_pair(_t(total), _t(longi))
    nyh = ny // 2 + 1
    for g, r in zip(got, ref):
        # fava_tpu pads the folded rows to a multiple of 8; the port does not.
        assert tuple(g.shape) == (nx // 2 + 1, nyh, r.shape[2])
        assert not r[:, nyh:].any()
        np.testing.assert_allclose(g.numpy(), r[:, :nyh], rtol=1e-14, atol=0)


@pytest.mark.parametrize("shape", BIN_SHAPES)
def test_shell_bin_values_folded_matches_fava_tpu(force_interpret, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    total, longi = _powers(shape, seed=nx * ny + nz)
    jfold = pk.fold_quadrants_pair(jnp.asarray(total), jnp.asarray(longi))
    _, ref = pk.shell_bin_values_folded_v2(*jfold, nbins, nx, ny, nz)
    tfold = ck.fold_quadrants_pair(_t(total), _t(longi))
    got = ck.shell_bin_values_folded(*tfold, nbins, ny, nz)
    assert got.shape == (2, nbins) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:2], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", BIN_SHAPES)
def test_shell_bin_sums_rfft_matches_unfolded_reference(shape):
    """Fold + folded binning + static counts against fava_tpu's jnp
    binning of the unfolded half-spectrum (the oracle the Pallas
    kernels are held to)."""
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    total, longi = _powers(shape, seed=7 * nz + ny)
    c_ref, s_ref = pk._shell_bin_jnp_rfft(
        jnp.asarray(total), jnp.asarray(longi), jnp.asarray(total - longi), nbins, nz
    )
    c_got, s_got = ck.shell_bin_sums_rfft(_t(total), _t(longi), nbins, nz)
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", BIN_SHAPES + [(15, 16, 16), (16, 9, 10)])
def test_folded_counts_match_fava_tpu(shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    fshape = (nx // 2 + 1, ny // 2 + 1, nz // 2 + 1)
    ref = pk._folded_counts(fshape, nbins, "float64", nx, ny, nz)
    np.testing.assert_array_equal(ck._folded_counts(fshape, nbins, nx, ny, nz), ref)


@pytest.mark.parametrize("shape", BIN_SHAPES)
def test_shell_bin_values_folded_1ch_matches_fava_tpu(force_interpret, shape):
    """K4 with one channel against fava_tpu's single-channel v3 kernel
    (the scalar spectra's, pallas_kernels.py:1282) on the same fold."""
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    p, _ = _powers(shape, seed=5 * nx + ny + nz)
    jfold, _ = pk.fold_quadrants_pair(jnp.asarray(p), jnp.asarray(p))
    fshape = tuple(int(s) for s in jfold.shape)
    ref, _ = pk._build_shell_folded_v3_fn(
        fshape, nbins, "float64", True, nx, ny, nz, 16, 2, True, True
    )(jfold, jfold)
    tfold, _ = ck.fold_quadrants_pair(_t(p), _t(p))
    got = ck.shell_bin_values_folded_1ch(tfold, nbins, ny, nz)
    assert got.shape == (nbins,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    two = ck.shell_bin_values_folded(tfold, tfold, nbins, ny, nz)
    assert torch.equal(two[0], got)


# ---------------------------------------------------------------------------
# K5 / K6: block-stack row moments

# (6, 8, 16, 16) meets fava_tpu's Pallas gate (_rows_ok: 256-lane rows)
# and runs its interpret-mode kernels; (5, 8, 6, 10) (60-lane rows) takes
# its jnp fallback.
BLOCK_SHAPES = [(6, 8, 16, 16), (5, 8, 6, 10)]


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_block_row_moments_match_fava_tpu(force_interpret, shape):
    nb, nx, ny, nz = shape
    f = _fields(shape, seed=sum(shape))
    assert pk._rows_ok(nb * nx, ny * nz) == (ny * nz % 128 == 0)
    ref = np.asarray(pk.block_row_moments(*map(jnp.asarray, f)))
    got = ck.block_row_moments(*map(_t, f))
    assert got.shape == (7, nb, nx) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_block_centered_row_moments_match_fava_tpu(force_interpret, shape):
    nb, nx, _, _ = shape
    f = _fields(shape, seed=5 * sum(shape))
    means = np.stack([v.mean(axis=(2, 3)) for v in f[1:]])
    ref = np.asarray(pk.block_centered_row_moments(*map(jnp.asarray, f), jnp.asarray(means)))
    got = ck.block_centered_row_moments(*map(_t, f), _t(means))
    assert got.shape == (9, nb, nx) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_block_moments_reject_mismatched_inputs():
    f = [torch.ones(2, 4, 4, 4) for _ in range(4)]
    with pytest.raises(ValueError, match="same-shaped"):
        ck.block_row_moments(*f[:3], torch.ones(2, 4, 4, 5))
    with pytest.raises(ValueError, match="means must be"):
        ck.block_centered_row_moments(*f, torch.zeros(3, 2, 5))


# ---------------------------------------------------------------------------
# K7: the AMR -> uniform regrid


def _regrid_case(tmp_path, ncells, refine, names=("dens", "velx")):
    path = tmp_path / "rt_hdf5_plt_cnt_0001"
    jsynthetic.make_amr_file(path, ncells=ncells, nblks=(2, 2, 2), refine=refine)
    mesh = JFlashAMR(path)
    mesh.load()
    mesh.load_data(list(names))
    return mesh


def _plans(mesh, **kwargs):
    common = dict(
        block_bounds=mesh.block_bounds,
        node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level),
        ncells_vec=mesh.nCellsVec,
        nblks_vec=mesh.nBlksVec,
        ndim=3,
        **kwargs,
    )
    jplan, tplan = jregrid.RegridPlan(**common), tregrid.RegridPlan(**common)
    for attr in ("leaf_table", "block_offsets", "block_scales", "out_origin", "total_cells",
                 "domain_box", "source_ids", "grid_delta"):
        np.testing.assert_array_equal(getattr(tplan, attr), getattr(jplan, attr), err_msg=attr)
    return jplan, tplan


REGRID_WINDOWS = {
    "full": None,
    "unaligned": np.array([[0.3, 0.8], [0.25, 0.75], [0.2, 0.7]]),
}


@pytest.mark.parametrize("window", sorted(REGRID_WINDOWS))
def test_regrid_fields_match_fava_tpu_pallas(tmp_path, force_interpret, window):
    mesh = _regrid_case(tmp_path, (8, 16, 16), {0: 2, 5: 3})
    jplan, tplan = _plans(mesh, subdomain_coords=REGRID_WINDOWS[window])
    data = {k: mesh._data[k] for k in ("dens", "velx")}
    scale = int(jplan.block_scales[jplan.source_ids].max())
    assert pallas_regrid.regrid_tiles_supported((8, 16, 16), scale)
    ref = pallas_regrid.regrid_fields_pallas(jplan, data, ["dens", "velx"])
    got = tregrid.regrid_fields(tplan, {k: _t(v) for k, v in data.items()}, ["dens", "velx"])
    for k in ("dens", "velx"):
        assert got[k].dtype == torch.float64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_regrid_fields_match_fava_tpu_off_the_tile_gate(tmp_path):
    """Blocks that fava_tpu's tile kernel refuses (not powers of two,
    scale 8 > ncx): K7 has no gate; its twin equals fava_tpu's gather."""
    mesh = _regrid_case(tmp_path, (4, 6, 5), {0: 4, 3: 2})
    jplan, tplan = _plans(mesh, subdomain_coords=np.array([[0.1, 0.9], [0.0, 1.0], [0.0, 1.0]]))
    assert not pallas_regrid.regrid_tiles_supported((4, 6, 5), 8)
    data = {k: mesh._data[k] for k in ("dens", "velx")}
    ref = jregrid.regrid_fields(jplan, data, ["dens", "velx"])
    got = tregrid.regrid_fields(tplan, {k: _t(v) for k, v in data.items()}, ["dens", "velx"])
    for k in ("dens", "velx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_regrid_shifts_are_the_scale_exponents():
    scales = torch.tensor([1, 2, 16, 1024])
    assert ck._regrid_shifts(scales).tolist() == [0, 1, 4, 10]
    with pytest.raises(ValueError, match="powers of two"):
        ck._regrid_shifts(torch.tensor([1, 3]))


# ---------------------------------------------------------------------------
# Dispatch, counters and the build


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ck.reset_launch_counts()
    f = list(map(_t, _fields((8, 8, 8), seed=1)))
    m = ck.row_moments_volume(*f)
    ck.centered_row_moments(*f, m[1:4] / 64.0)
    p = [v.abs()[:, :, :5].contiguous() for v in f[:2]]
    ck.shell_bin_sums_rfft(*p, 3, 8)
    stacks = [v.reshape(2, 4, 8, 8) for v in f]
    raw = ck.block_row_moments(*stacks)
    ck.block_centered_row_moments(*stacks, raw[1:4] / 64.0)
    table = torch.tensor([[[0]], [[1]]], dtype=torch.int32)
    offsets = torch.tensor([[0, 0, 0], [4, 0, 0]])
    scales = torch.ones(2, dtype=torch.int64)
    ck.regrid_fields(stacks, table, offsets, scales, (8, 8, 8), (0, 0, 0), (4, 8, 8))
    ck.shell_bin_sums_rfft_scalar(p[0], 3, 8)
    odd = [v[:7].contiguous() for v in p]
    ck.shell_bin_sums_rfft(*odd, 3, 8)
    ck.shell_bin_sums_rfft_scalar(odd[0], 3, 8)
    edges = np.linspace(-1.0, 1.0, 5)
    ck.pdf2d_counts(f[1], f[2], edges, edges)
    ck.pdf2d_counts(f[1], f[2], edges, edges, weights=f[0])
    assert ck.launch_counts() == dict.fromkeys(ck.KERNELS, 0)


def test_other_devices_raise():
    meta = [torch.empty(4, 4, 4, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="device type 'meta'"):
        ck.row_moments_volume(*meta)
    cpu = torch.ones(4, 4, 4)
    with pytest.raises(ValueError, match="several devices"):
        ck.fold_quadrants_pair(cpu, meta[0])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_is_keyed_by_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    src.write_text("// v2\n")
    second = _build.library_path()
    assert first != second and first.parent == second.parent == _build.BUILD_DIR


def test_package_sources_are_present():
    assert [p.name for p in sorted(_build.CSRC.glob("*.cu"))] == [
        "amr_kernels.cu",
        "dft_kernels.cu",
        "flagship_kernels.cu",
        "fused_spectra_kernels.cu",
        "pdf2d_kernels.cu",
        "spectra_kernels.cu",
        "zy_fft_chirp.cu",
        "zy_fft_mixed.cu",
        "zy_fft_pow2.cu",
    ]
    assert (_build.CSRC / "row_moments.cuh").is_file()
    assert (_build.CSRC / "shell_bins.cuh").is_file()
    assert (_build.CSRC / "zy_fft.cuh").is_file()
    assert set(_build._SIGNATURES) >= {
        "fava_block_row_moments",
        "fava_block_centered_row_moments",
        "fava_regrid_fields",
        "fava_shell_bin_sums_unfolded",
        "fava_pdf2d",
        "fava_shell_bin_powers_fused",
        "fava_shell_bin_sums_folded_onepass",
        "fava_zy_rfft",
    }
    for name in _build._SIGNATURES:  # every entry is defined in a source
        assert any(f"int {name}(" in src.read_text() for src in _build.CSRC.glob("*.cu")), name


def test_library_path_is_keyed_by_the_headers(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    head = tmp_path / "h.cuh"
    head.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    head.write_text("// v2\n")
    assert _build.library_path() != first


# ---------------------------------------------------------------------------
# Plain-torch modules around the kernels


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 16, 9), (16, 8, 8)])
def test_rfft_power_volumes_match_fava_tpu(shape):
    nx, ny, nz = shape
    rng = np.random.default_rng(nx + ny + nz)
    half = (3, nx, ny, nz // 2 + 1)
    ffts = rng.standard_normal(half) + 1j * rng.standard_normal(half)
    jt, jl, _, _ = jspectra.rfft_power_volumes([jnp.asarray(f) for f in ffts], shape)
    tt, tl = tspectra.rfft_power_volumes([_t(f) for f in ffts], shape)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12, atol=0)


def test_rfft_power_volumes_are_contiguous_for_permuted_transforms():
    """cuFFT can hand back permuted strides; the kernels downstream take
    row-major volumes, so the powers must come back contiguous."""
    rng = np.random.default_rng(4)
    f = _t(rng.standard_normal((8, 6, 5)) + 1j * rng.standard_normal((8, 6, 5)))
    permuted = f.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    assert not permuted.is_contiguous()
    total, longi = tspectra.rfft_power_volumes([permuted] * 3, (8, 6, 8))
    assert total.is_contiguous() and longi.is_contiguous()
    ref = tspectra.rfft_power_volumes([f] * 3, (8, 6, 8))
    assert torch.equal(total, ref[0]) and torch.equal(longi, ref[1])


def test_assemble_profile_stats_matches_fava_tpu():
    """Including a vacuum bin (sum(d) == 0), which both guard to rms 0."""
    rng = np.random.default_rng(5)
    nx = 12
    d_row = 1.0 + rng.random(nx)
    d_row[3] = 0.0
    means = rng.standard_normal((3, nx))
    c1 = 0.1 * rng.standard_normal((3, nx))
    cov = np.abs(rng.standard_normal((6, nx))) + 1.0
    c1[:, 3] = 0.0
    cov[:, 3] = 0.0
    layer = 64.0
    ref = jprofiles.assemble_profile_stats(*map(jnp.asarray, (d_row, means, c1, cov)), layer)
    got = tprofiles.assemble_profile_stats(*map(_t, (d_row, means, c1, cov)), layer)
    assert tprofiles.VEL_PAIRS == jprofiles.VEL_PAIRS and tprofiles._DIAG == jprofiles._DIAG
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13, atol=1e-15)
    assert got[2][:, 3].eq(0).all()


# ---------------------------------------------------------------------------
# B8: the joint histogram


def _pdf2d_samples(n, seed):
    """float32 samples with NaN, out-of-range and range-end values; edges
    that are exact in float32, so fava_tpu's float32 compare is exact."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 0.8, n).astype(np.float32)
    y = rng.normal(1.0, 1.5, n).astype(np.float32)
    x[:4] = [np.nan, -9.0, -2.0, 2.0]
    y[4:8] = [np.nan, 9.0, -3.0, 5.0]
    x[8], y[8] = 2.0, 5.0
    return x, y, np.linspace(-2.0, 2.0, 65), np.linspace(-3.0, 5.0, 33)


@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_pdf2d_counts_match_fava_tpu_kernel(force_interpret, n):
    x, y, xe, ye = _pdf2d_samples(max(n, 9), seed=n)
    x, y = x[:n], y[:n]
    ref = np.asarray(pallas_pdf2d.pdf2d_counts(jnp.asarray(x), jnp.asarray(y), xe, ye))
    got = ck.pdf2d_counts(_t(x.astype(np.float64)), _t(y.astype(np.float64)), xe, ye)
    assert got.dtype == torch.int64 and tuple(got.shape) == (64, 32)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.histogram2d(x, y, bins=(xe, ye))[0])


def test_pdf2d_weighted_matches_fava_tpu_kernel(force_interpret):
    x, y, xe, ye = _pdf2d_samples(70001, seed=2)
    w = np.random.default_rng(3).random(x.size).astype(np.float32)
    ref = np.asarray(
        pallas_pdf2d.pdf2d_counts(jnp.asarray(x), jnp.asarray(y), xe, ye, weights=jnp.asarray(w))
    )
    got = ck.pdf2d_counts(*(_t(a.astype(np.float64)) for a in (x, y)), xe, ye,
                          weights=_t(w.astype(np.float64)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref[0] + ref[1], rtol=2e-6, atol=0)
    np.testing.assert_allclose(
        got.numpy(), np.histogram2d(x, y, bins=(xe, ye), weights=w)[0], rtol=1e-12, atol=0
    )


def test_pdf2d_counts_reject_bad_edges_and_shapes():
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="monotonically"):
        ck.pdf2d_counts(x, x, [0.0, 1.0, 0.5], [0.0, 1.0])
    with pytest.raises(ValueError, match="share one shape"):
        ck.pdf2d_counts(x, torch.zeros(5, dtype=torch.float64), [0.0, 1.0], [0.0, 1.0])
