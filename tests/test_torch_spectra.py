"""fava_tpu_torch's kinetic-energy and scalar spectra held to fava_tpu on the
CPU, in float64, for even and odd extents and for 2D datasets.

Inputs are made from a seed with numpy and handed to both packages.
fava_tpu runs its Pallas kernels in interpret mode (pk.FORCE_INTERPRET),
as its own tests do: with it, fava_tpu folds even x/y extents, bins odd x
with ny % 8 == 0 through ``_shell_kernel`` (B10's Pallas kernel) and the
rest through its jnp binning. The port runs the plain twins of its kernels
(CPU tensors): fold + K4 for even x and y, B10 otherwise.

Tolerances: spectra rtol 1e-10 with atol 1e-12 of the output's scale (its
largest magnitude); float64 on both sides, FFTs and sums in different
orders. Shell counts exact; shell sums rtol 1e-10, atol 1e-12, as
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu import flagship as jflag
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu_torch import flagship as tflag
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import spectra as tspectra

# Even, odd x, odd y, odd z, odd x and y, and non-cubic volumes.
SHAPES_3D = [(16, 16, 16), (15, 16, 16), (16, 9, 16), (16, 16, 9), (15, 9, 10), (12, 16, 20)]
SHAPES_LOW = [(16, 12), (15, 9), (32,)]


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


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    out = {"dens": 1.0 + 0.5 * rng.random(shape)}
    for a in "xyz"[: len(shape)]:
        out[f"vel{a}"] = rng.standard_normal(shape)
    out["flam"] = rng.random(shape)
    return out


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    scale = float(np.nanmax(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * scale, err_msg=what)


def _models(shape, seed):
    arrays = _arrays(shape, seed)
    return fava_tpu.from_arrays(arrays), fava_tpu_torch.from_arrays(arrays, device="cpu")


# ---------------------------------------------------------------------------
# The analyses, through from_arrays


@pytest.mark.parametrize("shape", SHAPES_3D + SHAPES_LOW)
def test_kinetic_energy_spectra_match_fava_tpu(force_interpret, shape):
    jm, tm = _models(shape, seed=sum(shape))
    ref, got = jm.kinetic_energy_spectra(), tm.kinetic_energy_spectra()
    assert sorted(got) == sorted(ref) == ["k", "longitudinal", "total", "transverse"]
    for key in ref:
        _close(got[key], ref[key], key)


@pytest.mark.parametrize("shape", SHAPES_3D + SHAPES_LOW)
def test_scalar_spectra_match_fava_tpu(force_interpret, shape):
    jm, tm = _models(shape, seed=2 * sum(shape))
    ref, got = jm.scalar_spectra("flam"), tm.scalar_spectra("flam")
    assert list(got) == ["flam"] and sorted(got["flam"]) == ["k", "power"]
    for key in ("k", "power"):
        _close(got["flam"][key], ref["flam"][key], key)


@pytest.mark.parametrize("shape", [(8194, 96, 6), (8195, 96, 5)])
def test_spectra_past_4095_shells_match_fava_tpu(shape):
    """4096 shells (the card's wide walk): the port's twins take the exact
    shell of each integer k^2, as fava_tpu's float64 binning does. These
    volumes hold cells at k^2 = s^2 + s, s >= 2048, which float32's
    sqrt puts one shell too far (1e-3 of scale off)."""
    i = np.arange(shape[0] // 2 + 1)[:, None, None]
    j = np.arange(shape[1] // 2 + 1)[None, :, None]
    z = np.arange(shape[2] // 2 + 1)[None, None, :]
    k2 = i * i + j * j + z * z
    s = np.floor(np.sqrt(k2)).astype(np.int64)
    assert ((k2 == s * s + s) & (s >= 2048) & (s < max(shape) // 2 - 1)).any()
    jm, tm = _models(shape, seed=5)
    ref, got = jm.kinetic_energy_spectra(), tm.kinetic_energy_spectra()
    for key in ref:
        _close(got[key], ref[key], key)


def test_spectra_of_a_uniform_file_match_fava_tpu(uniform_file):
    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    ref, got = jm.kinetic_energy_spectra(), tm.kinetic_energy_spectra()
    for key in ref:
        _close(got[key], ref[key], key)
    _close(tm.scalar_spectra("dens")["dens"]["power"], jm.scalar_spectra("dens")["dens"]["power"],
           "dens")


@pytest.mark.parametrize("shape", [(15, 16, 16), (16, 9, 16), (15, 9, 12)])
def test_flagship_step_of_odd_extents_matches_fava_tpu(shape):
    """Odd x or y extents bin through B10 (the twin here) where fava_tpu
    takes its jnp binning: the whole step agrees."""
    rng = np.random.default_rng(sum(shape))
    f = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    ref = jflag.jitted_analysis_step(None)(*map(jnp.asarray, f))
    got = tflag.uniform_analysis_step(*map(_t, f))
    for key, r in ref.items():
        g = got[key].numpy()
        if key == "spectra_counts":
            np.testing.assert_array_equal(g, np.asarray(r), err_msg=key)
        else:
            _close(g, r, key)


def test_odd_window_flagship_analysis_runs_through_the_entry_point():
    arrays = {k: v for k, v in _arrays((15, 16, 16), seed=4).items() if k != "flam"}
    ref = fava_tpu.from_arrays(arrays).flagship_analysis()
    got = fava_tpu_torch.from_arrays(arrays, device="cpu").flagship_analysis()
    for key in ref:
        if key == "spectra_counts":
            np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
        else:
            _close(got[key], ref[key], key)


# ---------------------------------------------------------------------------
# B10 and the single-channel K4 against fava_tpu's kernels


def _half_powers(shape, seed, full=False):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    vshape = shape if full else (nx, ny, nz // 2 + 1)
    return np.abs(rng.standard_normal(vshape)), np.abs(rng.standard_normal(vshape))


# (nx, ny, full_nz, full grid): half-spectra of odd x and y extents, and
# full grids (nzr == full_nz) of odd and even z.
UNFOLDED_CASES = [
    ((15, 16, 16), False), ((15, 16, 9), False), ((16, 9, 12), False), ((9, 9, 9), False),
    ((15, 16, 9), True), ((10, 16, 12), True),
]


@pytest.mark.parametrize("shape,full", UNFOLDED_CASES)
def test_shell_bin_sums_unfolded_matches_shell_kernel(force_interpret, shape, full):
    """B10's twin against fava_tpu's ``_shell_kernel`` (interpret mode):
    counts exact, sums rtol 1e-10; one and two channels."""
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    total, longi = _half_powers(shape, seed=nx * ny + nz, full=full)
    vshape = total.shape
    fn = pk._build_shell_fn(vshape, nbins, "float64", True, nz)
    c_ref, s_ref = fn(jnp.asarray(total), jnp.asarray(longi), jnp.asarray(total - longi))
    c_got = ck._static_counts(vshape, nbins, nz, "cpu")
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
    two = ck.shell_bin_sums_unfolded(_t(total), _t(longi), nbins, nz)
    one = ck.shell_bin_sums_unfolded(_t(total), None, nbins, nz)
    assert two.shape == (2, nbins) and one.shape == (1, nbins) and two.dtype == torch.float64
    s_ref = np.asarray(s_ref)
    np.testing.assert_allclose(two.numpy(), s_ref[:2], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(one.numpy()[0], s_ref[0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 16, 9), (32, 16, 16), (15, 16, 16), (16, 9, 10)])
def test_shell_bin_sums_rfft_scalar_matches_fava_tpu(force_interpret, shape):
    """Even x and y: fava_tpu's single-channel v3 kernel (interpret) vs
    fold + single-channel K4; odd: its jnp binning vs B10 (one channel)."""
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    p, _ = _half_powers(shape, seed=3 * nx + ny + nz)
    c_ref, s_ref = pk.shell_bin_sums_rfft_scalar(jnp.asarray(p), nbins, nz)
    c_got, s_got = ck.shell_bin_sums_rfft_scalar(_t(p), nbins, nz)
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
    assert s_got.shape == (nbins,) and s_got.dtype == torch.float64
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(15, 16, 16), (16, 9, 16)])
def test_odd_extents_bin_like_the_full_grid(shape):
    """The rfft shell sums of odd x or y extents equal fava_tpu's full-grid
    binning of the same volumes' full-grid powers (tests/test_spectra.py's
    Hermitian identity, through B10)."""
    rng = np.random.default_rng(sum(shape))
    dens = 1.0 + 0.5 * rng.random(shape)
    vels = [rng.standard_normal(shape) for _ in range(3)]
    nbins = max(shape) // 2 - 1
    counts, sums = tspectra.rfft_shell_sums(_t(dens), [_t(v) for v in vels], nbins)
    w = np.sqrt(dens)
    ffts = [np.fft.fftn(w * v, norm="forward") for v in vels]
    ks = np.meshgrid(*(np.where(np.arange(n) <= (n - 1) // 2, np.arange(n), np.arange(n) - n)
                       for n in shape), indexing="ij")
    k_abs = np.sqrt(sum(k * k for k in ks))
    total = 0.5 * sum(np.abs(f) ** 2 for f in ffts)
    longi = np.abs(sum(k * f for k, f in zip(ks, ffts)) / np.maximum(k_abs, 1e-30)) ** 2
    c_ref, s_ref = pk._shell_bin_jnp(*map(jnp.asarray, (total, longi, total - longi)), nbins)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref), rtol=1e-10, atol=1e-12)


def test_unfolded_binning_rejects_a_mismatched_z_extent():
    p = torch.ones(5, 6, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="z extent"):
        ck.shell_bin_sums_unfolded(p, None, 2, 9)


# ---------------------------------------------------------------------------
# Helpers


def test_shell_integral_factor_and_squeeze_match_fava_tpu():
    from fava_tpu.ops import spectra as jspectra

    for nbins, ndim in ((7, 1), (7, 2), (15, 3)):
        for g, r in zip(tspectra._shell_integral_factor(nbins, ndim),
                        jspectra._shell_integral_factor(nbins, ndim)):
            np.testing.assert_array_equal(g, r)
    assert tuple(tspectra._squeeze_trailing(torch.ones(4, 5, 1), 2).shape) == (4, 5)
    with pytest.raises(ValueError, match="non-singleton"):
        tspectra._squeeze_trailing(torch.ones(4, 5, 2), 2)
    grid = tspectra._wavenumber_grid((5, 4), torch.float64, "cpu")
    ref = jspectra._wavenumber_grid((5, 4), jnp.float64)
    for g, r in zip(grid, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_spectra_analyses_are_registered():
    for name in ("kinetic_energy_spectra", "scalar_spectra"):
        assert callable(getattr(fava_tpu_torch.Model, name)), name
