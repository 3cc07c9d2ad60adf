"""fava_tpu_torch's fused-spectrum path held to fava_tpu on the CPU, in float64.

The path: fields -> sqrt(rho)*v -> stacked transforms (or the fused z+y
transform B12 and an FFT along x) -> the fused powers + fold + shell
binning B9 -> (counts, sums[3]); beside it the one-pass and the
row-chunked folded binning (B11). On the CPU every wrapper runs its plain
PyTorch version. fava_tpu runs as its own tests run it: its Pallas kernels
in interpret mode (pk.FORCE_INTERPRET, tests/test_pallas_kernels.py) and
its jnp references. Inputs are made from a seed with numpy and handed to
both packages. Tolerances:

* counts: exact (integer weights summed in float64);
* shell sums: rtol 1e-10, atol 1e-12, as fava_tpu's own float64 interpret
  tests: both sides add the same float64 powers in different orders;
* transforms (B12, the stacked rfftn): rtol 1e-9, atol 1e-9 of
  coefficients of size ~1e2, as tests/test_dft.py holds fava_tpu's fused
  transform: float64 dense DFT products against FFTs;
* the whole path: counts exact, sums rtol 1e-10, atol 1e-12 times the
  largest sum: float64 transforms of different algorithms, then the same
  powers summed in different orders.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fava_tpu.experiments import pallas_dft
from fava_tpu.experiments import planar_dft as jplanar
from fava_tpu.ops import dft as jdft
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu.ops import spectra as jspectra
from fava_tpu_torch.experiments import folded_bins, fused_dft, planar_dft
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import dft
from fava_tpu_torch.ops import spectra as tspectra

# Shapes of tests/test_pallas_kernels.py::test_shell_bin_powers_fused_matches_jnp
# (x/y Nyquist rows, odd z), and one with nx, ny, nz all different.
FUSED_SHAPES = [(16, 16, 16), (8, 16, 9), (16, 8, 8), (12, 20, 15)]
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


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10, atol=1e-12)


def _stacks(shape, seed):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    half = (3, nx, ny, nz // 2 + 1)
    return rng.standard_normal(half), rng.standard_normal(half)


def _port_stacks(re, im, layout):
    """Planar contiguous stacks, or the two view_as_real halves of one
    complex stack (the layout cuFFT's output gives the path)."""
    if layout == "planar":
        return _t(re), _t(im)
    r = torch.view_as_real(torch.tensor(re + 1j * im))
    return r[..., 0], r[..., 1]


# ---------------------------------------------------------------------------
# B9: powers + fold + shell binning straight from the transforms


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_powers_fused_matches_fava_tpu(force_interpret, shape, layout):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    re, im = _stacks(shape, seed=nx + ny + nz)
    c_ref, s_ref = pk.shell_bin_powers_fused(jnp.asarray(re), jnp.asarray(im), nbins, nz)
    counts, sums = ck.shell_bin_powers_fused(*_port_stacks(re, im, layout), nbins, nz)
    assert counts.dtype == sums.dtype == torch.float64 and sums.shape == (3, nbins)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    _close(sums, s_ref)
    # ... and against fava_tpu's unfused path: powers, then the jnp binning.
    ffts = [jnp.asarray(re[c] + 1j * im[c]) for c in range(3)]
    total, longi, trans, _ = jspectra.rfft_power_volumes(ffts, shape)
    c_jnp, s_jnp = pk._shell_bin_jnp_rfft(total, longi, trans, nbins, nz)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_jnp))
    _close(sums, s_jnp)


@pytest.mark.parametrize("shape", [(9, 16, 8), (16, 9, 8)])
def test_powers_fused_rejects_odd_xy(force_interpret, shape):
    re, im = _stacks(shape, seed=1)
    with pytest.raises(ValueError):
        pk.shell_bin_powers_fused(jnp.asarray(re), jnp.asarray(im), 3, shape[2])
    with pytest.raises(ValueError, match="even x and y"):
        ck.shell_bin_powers_fused(_t(re), _t(im), 3, shape[2])


def test_powers_fused_rejects_bad_stacks():
    re, im = (_t(a) for a in _stacks((8, 8, 8), seed=2))
    with pytest.raises(ValueError, match="z extent"):
        ck.shell_bin_powers_fused(re, im, 3, 10)
    with pytest.raises(ValueError, match="stacks"):
        ck.shell_bin_powers_fused(re[:2], im[:2], 3, 8)


# ---------------------------------------------------------------------------
# B11: the one-pass (counts in the kernel) and the row-chunked folded binning


def _folds(shape, seed):
    """fava_tpu's pad8 folds of seeded power volumes, with their unfolded
    volumes."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    half = (nx, ny, nz // 2 + 1)
    total = jnp.asarray(np.abs(rng.standard_normal(half)))
    longi = jnp.asarray(np.abs(rng.standard_normal(half)))
    folded = [pk._fold_quadrants(v) for v in (total, longi)]
    return (total, longi), folded


@pytest.mark.parametrize("shape", BIN_SHAPES)
def test_onepass_folded_matches_fava_tpu(force_interpret, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    (total, longi), folded = _folds(shape, seed=nx * ny + nz)
    fshape = tuple(int(s) for s in folded[0].shape)
    assert fshape[1] % 8 == 0 and fshape[1] >= ny // 2 + 1  # fava_tpu's padded rows
    c_ref, s_ref = pk._build_shell_folded_fn(fshape, nbins, "float64", True, nx, ny, nz)(*folded)
    counts, sums = ck.shell_bin_sums_folded_onepass(*map(_t, folded), nbins, nx, ny, nz)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    _close(sums, s_ref)
    c_jnp, s_jnp = pk._shell_bin_jnp_rfft(total, longi, total - longi, nbins, nz)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_jnp))
    _close(sums, s_jnp)


@pytest.mark.parametrize("shape", BIN_SHAPES)
def test_rows_folded_matches_fava_tpu(force_interpret, shape):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    _, folded = _folds(shape, seed=nx * ny + nz + 1)
    fshape = tuple(int(s) for s in folded[0].shape)
    if ny == 126:  # several row chunks in fava_tpu's kernel
        assert pk._pick_row_chunk(fshape[1]) < fshape[1]
    t_ref, l_ref = pk._build_shell_folded_v2_fn(fshape, nbins, "float64", True, nx, ny, nz)(*folded)
    t_sum, l_sum = ck.shell_bin_values_folded_rows(*map(_t, folded), nbins, nx, ny, nz)
    _close(t_sum, t_ref)
    _close(l_sum, l_ref)


@pytest.mark.parametrize("which", ["onepass", "rows"])
def test_folded_binning_ignores_what_the_pad_rows_hold(which):
    nx, ny, nz = 16, 20, 12  # ny/2+1 = 11 rows, fava_tpu pads to 16
    nbins = max(nx, ny, nz) // 2 - 1
    _, folded = _folds((nx, ny, nz), seed=9)
    clean = [_t(f) for f in folded]
    dirty = [c.clone() for c in clean]
    for d in dirty:
        d[:, ny // 2 + 1 :] = float("nan")
    if which == "onepass":
        for got, ref in zip(ck.shell_bin_sums_folded_onepass(*dirty, nbins, nx, ny, nz),
                            ck.shell_bin_sums_folded_onepass(*clean, nbins, nx, ny, nz)):
            assert torch.equal(got, ref)
    else:
        for got, ref in zip(ck.shell_bin_values_folded_rows(*dirty, nbins, nx, ny, nz),
                            ck.shell_bin_values_folded_rows(*clean, nbins, nx, ny, nz)):
            assert torch.equal(got, ref)
    unpadded = [c[:, : ny // 2 + 1] for c in clean]
    torch.testing.assert_close(
        torch.stack(ck.shell_bin_values_folded_rows(*dirty, nbins, nx, ny, nz)),
        ck.shell_bin_values_folded(*unpadded, nbins, ny, nz), rtol=1e-14, atol=0,
    )


def test_folded_binning_rejects_bad_folds():
    p = torch.ones(9, 8, 9)  # a fold of (16, 16, 16) needs >= 9 rows
    with pytest.raises(ValueError, match="fold of a"):
        ck.shell_bin_sums_folded_onepass(p, p, 7, 16, 16, 16)
    with pytest.raises(ValueError, match="fold of a"):
        ck.shell_bin_values_folded_rows(p, p, 7, 16, 16, 18)


# ---------------------------------------------------------------------------
# Transforms: the stacked rfftn, the DFT matrices, B12 and rfftn_fused


@pytest.mark.parametrize("karatsuba", [False, True])
def test_planar_stacked_matches_fava_tpu(karatsuba):
    rng = np.random.default_rng(2)
    vols = [rng.standard_normal((8, 12, 10)) for _ in range(3)]
    re_ref, im_ref = jplanar.rfftn_mxu_planar_stacked([jnp.asarray(v) for v in vols],
                                                     karatsuba=karatsuba)
    re, im = planar_dft.rfftn_planar_stacked([_t(v) for v in vols])
    assert re.shape == im.shape == (3, 8, 12, 6)
    np.testing.assert_allclose(re.numpy(), np.asarray(re_ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_ref), rtol=1e-10, atol=1e-10)
    for c in range(3):
        ref = np.fft.rfftn(vols[c])
        np.testing.assert_allclose(re[c].numpy(), ref.real, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(im[c].numpy(), ref.imag, rtol=1e-10, atol=1e-10)
    fwd = planar_dft.rfftn_planar_stacked(torch.stack([_t(v) for v in vols]), norm="forward")
    np.testing.assert_allclose(fwd[0].numpy() * vols[0].size, re.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [8, 15, 128])
def test_dft_matrices_match_fava_tpu(n):
    for got, ref in zip(dft._rdft_mats(n, "float64"), jdft._rdft_mats(n, "float64")):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(dft._dft_mat(n, "float64"), jdft._dft_mat(n, "float64"))
    assert dft._dft_mat(n, "float32").dtype == np.complex64


def test_zy_rfft_matches_fava_tpu(force_interpret):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((4, 128, 128))
    assert pallas_dft.use_fused_zy(v.shape)
    re_ref, im_ref = pallas_dft.zy_rfft_planar(jnp.asarray(v))
    re, im = fused_dft.zy_rfft_planar(_t(v))
    assert re.shape == im.shape == (4, 128, 65) and re.dtype == torch.float64
    np.testing.assert_allclose(re.numpy(), np.asarray(re_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_ref), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("shape", [(4, 128, 128), (3, 20, 15)])
def test_rfftn_fused_matches_numpy(shape):
    v = np.random.default_rng(sum(shape)).standard_normal(shape)
    got = fused_dft.rfftn_fused(_t(v))
    np.testing.assert_allclose(got.numpy(), np.fft.rfftn(v), rtol=1e-9, atol=1e-9)


def test_use_fused_zy():
    for shape in [(4, 128, 128), (3, 20, 15), (1, 1024, 1024), (2, 1, 7)]:
        assert fused_dft.use_fused_zy(shape), shape
    for shape in [(4, 128), (2, 1025, 8), (2, 8, 1025), (0, 8, 8), (70000, 8, 8)]:
        assert not fused_dft.use_fused_zy(shape), shape
    # fava_tpu's TPU gate (multiples of 128) is not the port's: odd extents run.
    assert not pallas_dft.use_fused_zy((3, 20, 15))


# ---------------------------------------------------------------------------
# The slice as a whole


def _probe_fused_path(fields, nbins):
    """fava_tpu's fused-spectrum path (scripts/tpu_fused_bin_probe.py):
    planar stacked transforms, normalized, into the fused kernel."""
    dens, *vels = (jnp.asarray(f) for f in fields)
    sd = jnp.sqrt(dens)
    ntot = dens.size
    re, im = jplanar.rfftn_mxu_planar_stacked([sd * v for v in vels])
    return pk.shell_bin_powers_fused(re / ntot, im / ntot, nbins, dens.shape[2])


def _volumes_route(dens, vels, nbins):
    """The spectra through the power volumes and ``shell_bin_sums_rfft``
    (K3 + K4 for even x and y, B10 for odd): the route of every 3D KE
    spectrum before B9 took the even extents."""
    return ck.shell_bin_sums_rfft(*tspectra.kinetic_power_volumes(dens, vels), nbins,
                                  int(dens.shape[2]))


def _fava_tpu_shell_sums(fields, nbins):
    """fava_tpu's float64 reference of the rfft shell sums: its power
    volumes and the jnp Hermitian binning of the half-spectrum."""
    dens, *vels = (jnp.asarray(f) for f in fields)
    sd = jnp.sqrt(dens)
    ffts = [jnp.fft.rfftn(sd * v) / dens.size for v in vels]
    total, longi, _, _ = jspectra.rfft_power_volumes(ffts, dens.shape)
    return pk._shell_bin_jnp_rfft(total, longi, total - longi, nbins, dens.shape[2])


def _spied(monkeypatch, names):
    """Calls of each named ``cuda_kernels`` wrapper, counted as it runs."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(ck, name)

        def spy(*args, real=real, name=name, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(ck, name, spy)
    return calls


ROUTE_WRAPPERS = ("shell_bin_powers_fused", "fold_quadrants_pair", "shell_bin_values_folded",
                  "shell_bin_sums_unfolded")


@pytest.mark.parametrize("shape,route", [
    ((8, 12, 10), {"shell_bin_powers_fused": 1}),
    ((16, 8, 9), {"shell_bin_powers_fused": 1}),
    ((6, 6, 1), {"shell_bin_powers_fused": 1}),
    ((9, 8, 10), {"shell_bin_sums_unfolded": 1}),
    ((8, 7, 9), {"shell_bin_sums_unfolded": 1}),
])
def test_rfft_shell_sums_equal_the_volumes_route(monkeypatch, shape, route):
    """``rfft_shell_sums`` bins the transforms' stack with B9 for even x
    and y extents and equals the power volumes binned by K3 + K4; odd x
    or y still take the volumes and B10. Both held to fava_tpu's float64
    reference: counts exact, sums rtol 1e-10."""
    rng = np.random.default_rng(sum(shape) + 3)
    fields = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    nbins = max(shape) // 2 - 1
    dens, *vels = (_t(f) for f in fields)
    old_counts, old_sums = _volumes_route(dens, vels, nbins)
    calls = _spied(monkeypatch, ROUTE_WRAPPERS)
    counts, sums = tspectra.rfft_shell_sums(dens, vels, nbins)
    assert calls == {**dict.fromkeys(ROUTE_WRAPPERS, 0), **route}
    assert counts.dtype == sums.dtype == torch.float64 and sums.shape == (3, nbins)
    np.testing.assert_array_equal(counts.numpy(), old_counts.numpy())
    np.testing.assert_allclose(sums.numpy(), old_sums.numpy(), rtol=1e-10, atol=0)
    c_ref, s_ref = (np.asarray(a) for a in _fava_tpu_shell_sums(fields, nbins))
    np.testing.assert_array_equal(counts.numpy(), c_ref)
    np.testing.assert_allclose(sums.numpy(), s_ref, rtol=1e-10, atol=1e-12 * np.abs(s_ref).max())


def test_kinetic_transforms_are_one_contiguous_stack():
    """The three normalized transforms in one (3, nx, ny, nz//2+1) stack,
    the inputs left as they were (the products are formed in buffers of
    the function's own)."""
    shape = (6, 4, 7)
    rng = np.random.default_rng(5)
    fields = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    dens, *vels = (_t(f) for f in fields)
    spec = tspectra.kinetic_transforms(dens, vels)
    assert spec.shape == (3, 6, 4, 4) and spec.dtype == torch.complex128 and spec.is_contiguous()
    for c in range(3):
        ref = np.fft.rfftn(np.sqrt(fields[0]) * fields[c + 1]) / fields[0].size
        np.testing.assert_allclose(spec[c].numpy(), ref, rtol=1e-12, atol=1e-15)
    for got, want in zip([dens, *vels], fields):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 10)])
def test_fused_path_matches_fava_tpu(force_interpret, shape):
    rng = np.random.default_rng(sum(shape))
    fields = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    nbins = max(shape) // 2 - 1
    c_ref, s_ref = (np.asarray(a) for a in _probe_fused_path(fields, nbins))
    dens, *vels = (_t(f) for f in fields)
    runs = {
        "stacked cuFFT + B9": planar_dft.rfft_shell_sums_fused(dens, vels, nbins),
        "B12 + FFT along x + B9": planar_dft.rfft_shell_sums_fused_zy(dens, vels, nbins),
        "power volumes + K3 + K4": _volumes_route(dens, vels, nbins),
    }
    for what, (counts, sums) in runs.items():
        np.testing.assert_array_equal(counts.numpy(), c_ref, err_msg=what)
        np.testing.assert_allclose(sums.numpy(), s_ref, rtol=1e-10,
                                   atol=1e-12 * np.abs(s_ref).max(), err_msg=what)


@pytest.mark.parametrize("shape", [(8, 12, 10), (3, 20, 15)])
def test_velocity_transforms_match_numpy(shape):
    rng = np.random.default_rng(sum(shape) + 2)
    fields = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    dens, *vels = (_t(f) for f in fields)
    ref = [np.fft.rfftn(np.sqrt(fields[0]) * v) / fields[0].size for v in fields[1:]]
    for re, im in (planar_dft.velocity_transforms(dens, vels),
                   planar_dft.velocity_transforms_fused_zy(dens, vels)):
        assert re.shape == im.shape == (3,) + shape[:2] + (shape[2] // 2 + 1,)
        for c in range(3):
            np.testing.assert_allclose(re[c].numpy(), ref[c].real, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(im[c].numpy(), ref[c].imag, rtol=1e-9, atol=1e-12)


def _probe_folded_path(fields, nbins, binning):
    """The spectra paths of fava_tpu's binning probes
    (scripts/tpu_shellbin_v2_probe.py, scripts/tpu_zsplit_probe.py): the
    power volumes, the pad8 fold, then the v1 (one-pass) or the v2
    (row-chunked) folded binning kernel."""
    dens, *vels = (jnp.asarray(f) for f in fields)
    nx, ny, nz = dens.shape
    sd = jnp.sqrt(dens)
    ffts = [jnp.fft.rfftn(sd * v) / dens.size for v in vels]
    total, longi, _, _ = jspectra.rfft_power_volumes(ffts, (nx, ny, nz))
    folded = [pk._fold_quadrants(v) for v in (total, longi)]
    fshape = tuple(int(s) for s in folded[0].shape)
    if binning == "onepass":
        return pk._build_shell_folded_fn(fshape, nbins, "float64", True, nx, ny, nz)(*folded)
    t_sum, l_sum = pk._build_shell_folded_v2_fn(fshape, nbins, "float64", True, nx, ny, nz)(*folded)
    counts = pk._folded_counts(fshape, nbins, "float64", nx, ny, nz)
    return counts, jnp.stack([t_sum, l_sum, t_sum - l_sum])


@pytest.mark.parametrize("binning", folded_bins.BINNINGS)
@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 10)])
def test_folded_path_matches_fava_tpu(force_interpret, shape, binning):
    rng = np.random.default_rng(sum(shape) + 1)
    fields = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    nbins = max(shape) // 2 - 1
    c_ref, s_ref = (np.asarray(a) for a in _probe_folded_path(fields, nbins, binning))
    dens, *vels = (_t(f) for f in fields)
    counts, sums = folded_bins.rfft_shell_sums_folded(dens, vels, nbins, binning)
    np.testing.assert_array_equal(counts.numpy(), c_ref)
    np.testing.assert_allclose(sums.numpy(), s_ref, rtol=1e-10, atol=1e-12 * np.abs(s_ref).max())
    volumes = _volumes_route(dens, vels, nbins)
    np.testing.assert_array_equal(counts.numpy(), volumes[0].numpy())
    np.testing.assert_allclose(sums.numpy(), volumes[1].numpy(), rtol=1e-12, atol=0)


def test_pad_rows8_is_fava_tpus_fold_layout():
    _, folded = _folds((16, 20, 12), seed=4)
    nyh = 20 // 2 + 1
    got = folded_bins.pad_rows8(_t(folded[0])[:, :nyh])
    np.testing.assert_array_equal(got.numpy(), np.asarray(folded[0]))
    nan_pad = folded_bins.pad_rows8(_t(folded[0])[:, :nyh], float("nan"))
    assert torch.isnan(nan_pad[:, nyh:]).all() and torch.equal(nan_pad[:, :nyh], got[:, :nyh])
    with pytest.raises(ValueError, match="binning"):
        folded_bins.shell_sums_padded_fold(got, got, 5, 12, "v3")


def test_rfft_shell_counts_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ck.rfft_shell_counts((8, 8, 8), 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.rfft_shell_counts((8, 8, 8), 3)
    np.testing.assert_array_equal(
        ck.rfft_shell_counts((8, 8, 8), 3, device="cpu").numpy(),
        pk.rfft_shell_counts((8, 8, 8), 3, "float64"),
    )


def test_experiments_import_leaves_jax_out():
    code = (
        "import sys; "
        "from fava_tpu_torch.experiments import folded_bins, fused_dft, planar_dft; "
        "from fava_tpu_torch.ops import dft; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'fava_tpu')]; "
        "assert not bad, bad"
    )
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
