"""fava_tpu_torch's velocity diagnostics held to fava_tpu on the CPU, in
float64, and to the NumPy oracle of tests/oracles/velocity.py.

The same seeded numpy fields go through fava_tpu/ops/velocity.py (JAX on
the CPU, x64) and fava_tpu_torch/ops/velocity.py (CPU tensors, so the
shell binning runs the plain twins of K3 + the single-channel walk for
even x and y extents and of B10 otherwise); the cases mirror
tests/test_velocity.py (the sharded one aside, which is ROADMAP A11) and
tests/test_2d.py:69-135, and add odd extents, domain lengths, every
anisotropic axis, the meshes, the registered analyses and
``summary_series``. fava_tpu's 3D binning runs its jnp reference, as its
own tests run it; one case runs its Pallas kernels in interpret mode.

Tolerances: rtol 1e-10 with atol 1e-12 of the output's scale (its largest
finite magnitude) for spectra, fields and summaries: float64 on both
sides, FFTs and sums in another order. NaN (empty shells) in the same
places. The transfer spectrum is a cancellation of large signed shell
sums: its atol is 1e-12 of the largest |T|, and the conservation checks
hold sum(T) to 1e-12 (1e-11 dealiased) of it, as fava_tpu's tests.
Oracles: fava_tpu's own test tolerances (rtol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu.ops import velocity as jvel
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import velocity as tvel
from tests.oracles import velocity as oracle

SHAPES_3D = [(16, 16, 16), (16, 12, 8), (8, 8, 9), (15, 9, 10), (9, 16, 12)]
LENGTHS_3D = [None, (1.0, 2.0, 0.5)]
NAMES = ("velx", "vely", "velz")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, seed=0, n=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n or len(shape))]


def _t(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, what, rtol=1e-10, atol_rel=1e-12):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    finite = ref[np.isfinite(ref)]
    scale = float(np.abs(finite).max()) if finite.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * scale, equal_nan=True,
                               err_msg=what)


def _close_dict(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k in ref:
        if isinstance(ref[k], dict):
            _close_dict(got[k], ref[k], f"{what}/{k}")
        else:
            _close(got[k], ref[k], f"{what}/{k}")


# ---------------------------------------------------------------------------
# Helmholtz decomposition, vorticity, dilatation


@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("lengths", LENGTHS_3D)
def test_helmholtz_matches_fava_tpu_and_sums_exactly(shape, lengths):
    vels = _fields(shape, 1)
    got = tvel.helmholtz_decompose(*_t(vels), lengths=lengths)
    ref = jvel.helmholtz_decompose(*_j(vels), lengths=lengths)
    _close_dict(got, {p: {k: np.asarray(v) for k, v in c.items()} for p, c in ref.items()},
                "helmholtz")
    sol_ref, comp_ref = oracle.helmholtz_oracle(vels, lengths)
    for i, name in enumerate(NAMES):
        np.testing.assert_allclose(got["compressive"][name].numpy(), comp_ref[i], rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(got["solenoidal"][name].numpy(), sol_ref[i], rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(
            (got["solenoidal"][name] + got["compressive"][name]).numpy(), vels[i], rtol=1e-12,
            atol=1e-12)


def test_helmholtz_parts_are_curl_and_divergence_free():
    vels = _fields((16, 16, 16), 2)
    out = tvel.helmholtz_decompose(*_t(vels))
    comp = [out["compressive"][n].numpy() for n in NAMES]
    sol = [out["solenoidal"][n].numpy() for n in NAMES]
    assert np.max(np.abs(oracle.dilatation_oracle(sol))) < 1e-10
    for c in oracle.vorticity_oracle(comp):
        assert np.max(np.abs(c)) < 1e-10


def test_helmholtz_pure_modes():
    n = 16
    x = np.arange(n) / n
    X, Y, _ = np.meshgrid(x, x, x, indexing="ij")
    z = np.zeros_like(X)
    out = tvel.helmholtz_decompose(*_t([np.sin(2 * np.pi * Y), z, z]))
    for name in NAMES:
        assert out["compressive"][name].abs().max() < 1e-12
    grad = [np.sin(2 * np.pi * X), z, z]
    out = tvel.helmholtz_decompose(*_t(grad))
    np.testing.assert_allclose(out["compressive"]["velx"].numpy(), grad[0], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("lengths", LENGTHS_3D)
def test_vorticity_and_dilatation_match_fava_tpu(shape, lengths):
    vels = _fields(shape, 3)
    got = tvel.vorticity(*_t(vels), lengths=lengths)
    ref = jvel.vorticity(*_j(vels), lengths=lengths)
    for g, r, o in zip(got, ref, oracle.vorticity_oracle(vels, lengths)):
        _close(g, r, "vorticity")
        np.testing.assert_allclose(g.numpy(), o, rtol=1e-9, atol=1e-9)
    d = tvel.dilatation(*_t(vels), lengths=lengths)
    _close(d, jvel.dilatation(*_j(vels), lengths=lengths), "dilatation")
    np.testing.assert_allclose(d.numpy(), oracle.dilatation_oracle(vels, lengths), rtol=1e-9,
                               atol=1e-9)


def test_dilatation_of_solenoidal_field_is_zero():
    n = 16
    x = np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    vels = [np.sin(2 * np.pi * Y) + np.cos(2 * np.pi * Z), np.sin(2 * np.pi * Z),
            np.cos(2 * np.pi * X)]
    assert tvel.dilatation(*_t(vels)).abs().max() < 1e-12


# ---------------------------------------------------------------------------
# Enstrophy, helicity and transfer spectra


@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("lengths", LENGTHS_3D)
def test_enstrophy_spectrum_matches_fava_tpu(shape, lengths):
    vels = _fields(shape, 4)
    got = tvel.enstrophy_spectrum(*_t(vels), lengths=lengths)
    ref = jvel.enstrophy_spectrum(*_j(vels), lengths=lengths)
    _close_dict(got, ref, "enstrophy")
    np.testing.assert_allclose(got["power"], oracle.enstrophy_spectrum_oracle(vels, lengths)["power"],
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8)])
def test_enstrophy_spectrum_matches_fava_tpu_kernels_in_interpret_mode(shape):
    """fava_tpu's fold and folded-walk Pallas kernels (interpret mode)
    against the port's plain twins of K3 and the single-channel walk."""
    vels = _fields(shape, 14)
    pk.FORCE_INTERPRET = True
    try:
        ref = jvel.enstrophy_spectrum(*_j(vels))
    finally:
        pk.FORCE_INTERPRET = False
    _close_dict(tvel.enstrophy_spectrum(*_t(vels)), ref, "enstrophy (interpret)")


@pytest.mark.parametrize("shape", [(16, 12, 8), (15, 9, 10)])
@pytest.mark.parametrize("lengths", [None, (2.0, 1.0, 1.5)])
def test_helicity_spectrum_matches_fava_tpu(shape, lengths):
    vels = _fields(shape, 5)
    got = tvel.helicity_spectrum(*_t(vels), lengths=lengths)
    _close_dict(got, jvel.helicity_spectrum(*_j(vels), lengths=lengths), "helicity")
    np.testing.assert_allclose(got["power"], oracle.helicity_spectrum_oracle(vels, lengths)["power"],
                               rtol=1e-9, atol=1e-12)
    finite = got["power"][np.isfinite(got["power"])]
    assert (finite > 0).any() and (finite < 0).any()  # signed


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8), (15, 9, 10)])
@pytest.mark.parametrize("lengths", [None, (2.0, 1.0, 1.5)])
@pytest.mark.parametrize("dealias", [False, True])
def test_transfer_spectrum_matches_fava_tpu(shape, lengths, dealias):
    vels = _fields(shape, 6)
    got = tvel.transfer_spectrum(*_t(vels), lengths=lengths, dealias=dealias)
    _close_dict(got, jvel.transfer_spectrum(*_j(vels), lengths=lengths, dealias=dealias),
                "transfer")
    ref = oracle.transfer_spectrum_oracle(vels, lengths, dealias=dealias)
    np.testing.assert_allclose(got["transfer"], ref["transfer"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["flux"], ref["flux"], rtol=1e-9, atol=1e-11)


def _band_limited_solenoidal(n=16, kmax=2.0, seed=5):
    rng = np.random.default_rng(seed)
    k1 = np.fft.fftfreq(n, 1.0 / n)
    KX, KY, KZ = np.meshgrid(k1, k1, k1, indexing="ij")
    k2 = KX**2 + KY**2 + KZ**2
    mask = np.sqrt(k2) <= kmax
    vh = [np.fft.fftn(rng.standard_normal((n, n, n))) * mask for _ in range(3)]
    div = (KX * vh[0] + KY * vh[1] + KZ * vh[2]) / np.maximum(k2, 1e-300)
    vh = [w - k * div for w, k in zip(vh, (KX, KY, KZ))]
    return [np.fft.ifftn(w).real for w in vh]


def test_transfer_conserves_energy_for_band_limited_solenoidal_flow():
    out = tvel.transfer_spectrum(*_t(_band_limited_solenoidal()))
    tmax = np.abs(out["transfer"]).max()
    assert tmax > 1e-6
    assert abs(out["transfer"].sum()) < 1e-12 * tmax
    assert abs(out["flux"][-1]) < 1e-12 * tmax
    np.testing.assert_allclose(out["flux"], -np.cumsum(out["transfer"]), rtol=1e-12)


def test_transfer_dealiased_conserves_for_full_spectrum_solenoidal_field():
    n = 16
    out = tvel.transfer_spectrum(*_t(_band_limited_solenoidal(n=n, kmax=100.0, seed=9)),
                                 dealias=True)
    assert out["transfer"].shape == (tvel.dealiased_nbins((n, n, n)),)
    assert tvel.dealiased_nbins((n, n, n)) == jvel.dealiased_nbins((n, n, n))
    tmax = np.abs(out["transfer"]).max()
    assert tmax > 1e-6
    assert abs(out["transfer"].sum()) < 1e-11 * tmax
    assert abs(out["flux"][-1]) < 1e-11 * tmax


def _abc(n=16):
    x = 2 * np.pi * np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return [np.sin(Z) + np.cos(Y), np.sin(X) + np.cos(Z), np.sin(Y) + np.cos(X)]


def test_transfer_of_beltrami_flow_vanishes_shell_by_shell():
    out = tvel.transfer_spectrum(*_t(_abc()))
    assert np.abs(out["transfer"]).max() < 1e-13
    assert np.abs(out["flux"]).max() < 1e-13


@pytest.mark.parametrize("shape", [(16, 12), (15, 9)])
def test_transfer_2d_matches_fava_tpu_and_conserves(shape):
    vels = _fields(shape, 33)
    for dealias in (False, True):
        got = tvel.transfer_spectrum(*_t(vels), dealias=dealias)
        _close_dict(got, jvel.transfer_spectrum(*_j(vels), dealias=dealias), "transfer 2d")
    ref = oracle.transfer_spectrum_oracle(vels, dealias=True)
    np.testing.assert_allclose(got["transfer"], ref["transfer"], rtol=1e-9, atol=1e-11)
    n = 16
    x = 2 * np.pi * np.arange(n) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    tg = [np.cos(X) * np.sin(Y), -np.sin(X) * np.cos(Y)]
    assert abs(tvel.transfer_spectrum(*_t(tg))["transfer"].sum()) < 1e-13


def test_beltrami_field_maximal_helicity():
    vels = _abc()
    hel = tvel.helicity_spectrum(*_t(vels))
    ens = tvel.enstrophy_spectrum(*_t(vels))
    mask = np.isfinite(hel["power"]) & (ens["power"] > 1e-20)
    np.testing.assert_allclose(hel["power"][mask], 2.0 * ens["power"][mask], rtol=1e-9)


# ---------------------------------------------------------------------------
# 2D data and validation


@pytest.mark.parametrize("shape", [(16, 16), (16, 12), (8, 9), (15, 9)])
def test_2d_diagnostics_match_fava_tpu(shape):
    vels = _fields(shape, 31)
    got = tvel.helmholtz_decompose(*_t(vels))
    ref = jvel.helmholtz_decompose(*_j(vels))
    _close_dict(got, {p: {k: np.asarray(v) for k, v in c.items()} for p, c in ref.items()},
                "helmholtz 2d")
    assert set(got["solenoidal"]) == {"velx", "vely"}
    w = tvel.vorticity(*_t(vels), lengths=(2.0, 3.0))
    _close(w, jvel.vorticity(*_j(vels), lengths=(2.0, 3.0)), "vorticity 2d")
    np.testing.assert_allclose(w.numpy(), oracle.vorticity_2d_oracle(vels, (2.0, 3.0)), rtol=1e-9,
                               atol=1e-9)
    _close(tvel.dilatation(*_t(vels)), jvel.dilatation(*_j(vels)), "dilatation 2d")
    ens = tvel.enstrophy_spectrum(*_t(vels), lengths=(2.0, 3.0))
    _close_dict(ens, jvel.enstrophy_spectrum(*_j(vels), lengths=(2.0, 3.0)), "enstrophy 2d")
    np.testing.assert_allclose(
        ens["power"], oracle.enstrophy_spectrum_2d_oracle(vels, (2.0, 3.0))["power"], rtol=1e-9,
        atol=1e-12)


def test_2d_component_count_validation():
    v2, v3 = torch.zeros((8, 8)), torch.zeros((8, 8, 8))
    with pytest.raises(ValueError):
        tvel.helmholtz_decompose(v2, v2, v2)
    with pytest.raises(ValueError):
        tvel.vorticity(v3, v3)
    with pytest.raises(ValueError):
        tvel.helicity_spectrum(v2, v2, v2)


def test_shape_validation():
    v2 = torch.zeros((8, 8), dtype=torch.float64)
    for fn in (tvel.helmholtz_decompose, tvel.vorticity, tvel.enstrophy_spectrum):
        with pytest.raises(ValueError):
            fn(v2, v2, v2)
    v3 = torch.zeros((4, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tvel.dilatation(v3, v3, v3, lengths=(1.0, 2.0))
    with pytest.raises(ValueError, match="component 2"):
        tvel.helmholtz_decompose(v3, v3, torch.zeros((4, 4, 1), dtype=torch.float64))
    ones = torch.ones((4, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="gamma shape"):
        tvel.turbulence_summary(v3, v3, v3, dens=ones, pres=ones,
                                gamma=torch.ones((4, 4, 1), dtype=torch.float64))


# ---------------------------------------------------------------------------
# Decomposed and anisotropic spectra


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8), (15, 9, 10), (16, 12)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lengths", [None, "box"])
def test_decomposed_spectra_match_fava_tpu_and_sum_exactly(shape, weighted, lengths):
    rng = np.random.default_rng(41)
    vels = [rng.standard_normal(shape) for _ in range(len(shape))]
    dens = 1.5 + 0.4 * rng.random(shape) if weighted else None
    lengths = None if lengths is None else tuple(0.5 * (i + 2) for i in range(len(shape)))
    got = tvel.decomposed_ke_spectra(*_t(vels), dens=None if dens is None else torch.tensor(dens),
                                     lengths=lengths)
    ref = jvel.decomposed_ke_spectra(*_j(vels), dens=None if dens is None else jnp.asarray(dens),
                                     lengths=lengths)
    _close_dict(got, ref, "decomposed")
    oref = oracle.decomposed_ke_spectra_oracle(vels, dens, lengths)
    for name in ("total", "solenoidal", "compressive"):
        np.testing.assert_allclose(got[name], oref[name], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["total"], got["solenoidal"] + got["compressive"], rtol=1e-12,
                               atol=1e-14)


def test_decomposed_spectra_consistent_with_helmholtz_fields():
    vels = _fields((16, 16, 16), 42)
    got = tvel.decomposed_ke_spectra(*_t(vels))
    hd = tvel.helmholtz_decompose(*_t(vels))
    for part in ("solenoidal", "compressive"):
        ref = oracle.decomposed_ke_spectra_oracle([hd[part][n].numpy() for n in NAMES], None)
        np.testing.assert_allclose(got[part], ref["total"], rtol=1e-9, atol=1e-13)


def test_decomposed_spectra_pure_modes():
    n = 16
    x = np.arange(n) / n
    X, Y, _ = np.meshgrid(x, x, x, indexing="ij")
    z = np.zeros_like(X)
    out = tvel.decomposed_ke_spectra(*_t([np.sin(2 * np.pi * Y), z, z]))
    assert np.nanmax(out["compressive"]) < 1e-14 and np.nansum(out["solenoidal"]) > 0
    out = tvel.decomposed_ke_spectra(*_t([np.sin(4 * np.pi * X), z, z]))
    assert np.nanmax(out["solenoidal"]) < 1e-14 and np.nansum(out["compressive"]) > 0


def test_decomposed_spectra_dens_shape_is_checked():
    vels = _fields((16, 12), 43)
    with pytest.raises(ValueError, match="dens shape"):
        tvel.decomposed_ke_spectra(*_t(vels), dens=torch.zeros((4, 4), dtype=torch.float64))


@pytest.mark.parametrize("shape", [(16, 12, 8), (15, 9, 10), (16, 12), (9, 8)])
def test_anisotropic_spectra_match_fava_tpu_every_axis(shape):
    nd = len(shape)
    vels = _fields(shape, 44)
    ke = 0.5 * sum(np.mean(v**2) for v in vels)
    for axis in range(nd):
        got = tvel.anisotropic_ke_spectra(*_t(vels), axis=axis)
        _close_dict(got, jvel.anisotropic_ke_spectra(*_j(vels), axis=axis), f"aniso axis {axis}")
        ref = oracle.anisotropic_ke_spectra_oracle(vels, axis=axis)
        for name in ("par_total", "par_axial", "par_transverse", "perp_total", "perp_axial",
                     "perp_transverse"):
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-9, atol=1e-13,
                                       err_msg=f"axis {axis} {name}")
        np.testing.assert_allclose(np.sum(got["par_total"]), ke, rtol=1e-10)
        np.testing.assert_allclose(np.sum(got["perp_total"]), ke, rtol=1e-10)


def test_anisotropic_spectra_pure_modes_and_validation():
    n = 16
    x = np.arange(n) / n
    X = np.meshgrid(x, x, x, indexing="ij")[0]
    z = np.zeros((n, n, n))
    out = tvel.anisotropic_ke_spectra(*_t([z, np.sin(4 * np.pi * X), z]), axis=0)
    assert np.argmax(out["par_total"]) == 2
    np.testing.assert_allclose(np.sum(out["par_axial"]), 0.0, atol=1e-15)
    np.testing.assert_allclose(out["par_total"][2], 0.25, rtol=1e-12)
    assert np.argmax(out["perp_total"]) == 0
    np.testing.assert_allclose(np.sum(out["perp_total"][1:]), 0.0, atol=1e-15)
    with pytest.raises(ValueError, match="axis"):
        tvel.anisotropic_ke_spectra(*_t([z, z, z]), axis=3)


# ---------------------------------------------------------------------------
# Turbulence summary


def test_turbulence_summary_single_mode_identities():
    n, k0 = 32, 3
    y = np.arange(n) / n
    Y = np.meshgrid(y, y, y, indexing="ij")[1]
    vx, z = np.sin(2 * np.pi * k0 * Y), np.zeros((n, n, n))
    out = tvel.turbulence_summary(*_t([vx, z, z]), lengths=(1.0, 1.0, 1.0))
    kp = 2 * np.pi * k0
    np.testing.assert_allclose(out["u_rms"], np.sqrt(0.5), rtol=1e-12)
    np.testing.assert_allclose(out["integral_scale"], (3 * np.pi / 4) / kp, rtol=1e-12)
    np.testing.assert_allclose(out["taylor_scale"], np.sqrt(5.0) / kp, rtol=1e-12)
    np.testing.assert_allclose(out["compressive_fraction"], 0.0, atol=1e-14)
    np.testing.assert_allclose(out["vorticity_rms"], kp * np.sqrt(0.5), rtol=1e-12)
    np.testing.assert_allclose(out["dilatation_rms"], 0.0, atol=1e-12)
    X = np.meshgrid(y, y, y, indexing="ij")[0]
    out2 = tvel.turbulence_summary(*_t([np.sin(2 * np.pi * k0 * X), z, z]))
    np.testing.assert_allclose(out2["compressive_fraction"], 1.0, rtol=1e-12)
    np.testing.assert_allclose(out2["vorticity_rms"], 0.0, atol=1e-12)


@pytest.mark.parametrize("shape", [(16, 12, 8), (15, 9, 10), (16, 12)])
@pytest.mark.parametrize("fields", ["vel", "dens", "pres scalar gamma", "pres gamc"])
def test_turbulence_summary_matches_fava_tpu(shape, fields):
    nd = len(shape)
    rng = np.random.default_rng(46)
    vels = [rng.standard_normal(shape) for _ in range(nd)]
    dens = 1.5 + 0.4 * rng.random(shape)
    pres = 2.0 + rng.random(shape)
    gamc = 1.3 + 0.2 * rng.random(shape)
    lengths = tuple(0.5 * (i + 1) for i in range(nd))
    kw_np = {}
    if fields != "vel":
        kw_np["dens"] = dens
    if fields.startswith("pres"):
        kw_np["pres"] = pres
        kw_np["gamma"] = 1.4 if fields == "pres scalar gamma" else gamc
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw_np.items()}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw_np.items()}
    got = tvel.turbulence_summary(*_t(vels), lengths=lengths, **tkw)
    ref = jvel.turbulence_summary(*_j(vels), lengths=lengths, **jkw)
    assert list(got) == list(ref)
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, rtol=1e-10, atol=1e-14, err_msg=name)
    if fields == "pres gamc":
        oref = oracle.turbulence_summary_oracle(vels, dens, pres, gamc, lengths=lengths)
        for name, val in oref.items():
            np.testing.assert_allclose(got[name], val, rtol=1e-9, err_msg=name)


def test_turbulence_summary_accumulates_float32_fields_in_float64():
    """float32 fields (the card's dtype), here on the CPU: the real-space
    entries, mean_s above all, are float64 sums of the widened values, so
    they equal fava_tpu's float64 run on the same values up to summation
    order."""
    rng = np.random.default_rng(48)
    shape = (16, 12, 8)
    vels = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    dens = (1.0 + 1e-3 * rng.random(shape)).astype(np.float32)  # small ln rho contrast
    got = tvel.turbulence_summary(*[torch.from_numpy(v) for v in vels], dens=torch.from_numpy(dens))
    ref = jvel.turbulence_summary(*[jnp.asarray(v, dtype=jnp.float64) for v in vels],
                                  dens=jnp.asarray(dens, dtype=jnp.float64))
    for name in ("u_rms", "kinetic_energy", "kinetic_energy_density", "mean_s", "sigma_s"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-10, atol=1e-15, err_msg=name)


def test_turbulence_summary_validation():
    v = torch.zeros((8, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="BOTH pres and dens"):
        tvel.turbulence_summary(v, v, v, pres=v)
    with pytest.raises(ValueError, match="dens shape"):
        tvel.turbulence_summary(v, v, v, dens=torch.zeros((4, 4, 4), dtype=torch.float64))


def test_turbulence_summary_device_names_are_fava_tpus():
    for has_dens in (False, True):
        for has_pres in (False, True) if has_dens else (False,):
            v = [jnp.ones((4, 4, 4))] * 3
            kw = {"dens": v[0]} if has_dens else {}
            if has_pres:
                kw["pres"] = v[0]
            _, names = jvel.turbulence_summary_device(*v, **kw)
            assert tvel.summary_names(has_dens, has_pres) == names


# ---------------------------------------------------------------------------
# Meshes, registration, series


def _uniform_pair(path, fields=("dens", "velx", "vely", "velz"), ncells=(16, 12, 8), seed=3):
    from fava_tpu.io import synthetic

    synthetic.make_uniform_file(path, ncells=ncells, fields=fields, seed=seed)
    jm, tm = fava_tpu.FLASH(path.parent), fava_tpu_torch.FLASH(path.parent, device="cpu")
    jm.load(file_type="uni")
    tm.load(file_type="uni")
    return jm, tm


MODEL_CALLS = {
    "helmholtz_decomposition": {},
    "vorticity": {},
    "dilatation": {},
    "enstrophy_spectra": {},
    "helicity_spectra": {},
    "transfer_spectra": {"dealias": True},
    "decomposed_kinetic_energy_spectra": {"weighted": True},
    "anisotropic_kinetic_energy_spectra": {"axis": 2},
    "turbulence_summary": {},
}


@pytest.mark.parametrize("name", sorted(MODEL_CALLS))
def test_registered_analyses_match_fava_tpu_on_a_uniform_file(tmp_path, name):
    jm, tm = _uniform_pair(tmp_path / "rt_hdf5_uniform_0001",
                           fields=("dens", "velx", "vely", "velz", "pres", "gamc"))
    got = getattr(tm, name)(**MODEL_CALLS[name])
    ref = getattr(jm, name)(**MODEL_CALLS[name])
    if name == "turbulence_summary":
        assert "mach_rms" in got and list(got) == list(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-14, err_msg=k)
    else:
        _close_dict(got, ref, name)


def test_2d_mesh_diagnostics_match_fava_tpu():
    """tests/test_2d.py:69-135 on the port: a (16, 12, 1) dataset."""
    rng = np.random.default_rng(61)
    arrays = {k: rng.standard_normal((16, 12)) for k in ("velx", "vely")}
    arrays["dens"] = 1.0 + 0.3 * rng.random((16, 12))
    bounds = [[0.0, 2.0], [0.0, 1.5]]
    jm = fava_tpu.from_arrays(arrays, domain_bounds=bounds)
    tm = fava_tpu_torch.from_arrays(arrays, domain_bounds=bounds, device="cpu")
    for name, kw in (("helmholtz_decomposition", {}), ("vorticity", {}), ("dilatation", {}),
                     ("enstrophy_spectra", {}), ("decomposed_kinetic_energy_spectra",
                                                 {"weighted": True}),
                     ("transfer_spectra", {}), ("anisotropic_kinetic_energy_spectra", {"axis": 1})):
        _close_dict(getattr(tm, name)(**kw), getattr(jm, name)(**kw), f"2d {name}")
    assert set(tm.vorticity()) == {"vortz"}
    got, ref = tm.turbulence_summary(), jm.turbulence_summary()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-14, err_msg=k)
    vels = [arrays["velx"], arrays["vely"]]
    np.testing.assert_allclose(
        tm.vorticity()["vortz"], oracle.vorticity_2d_oracle(vels, (2.0, 1.5)), rtol=1e-9,
        atol=1e-9)
    with pytest.raises(ValueError, match="2D"):
        tm.helicity_spectra()


def test_streamed_paths_name_roadmap_a10(tmp_path):
    """The summary and the gradient statistics through ``streamed=True``
    (ROADMAP A10, now ported) equal the in-core analyses on the same file:
    float64 on both sides, the transforms and sums split by slab and kx
    chunk (rtol 1e-10, atol 1e-12 of scale). The mean of a periodic
    central difference telescopes to 0, so the gradient means are held to
    1e-12 of their natural scale, the largest gradient rms."""
    _, tm = _uniform_pair(tmp_path / "rt_hdf5_uniform_0001")
    for name in ("turbulence_summary", "velocity_gradient_statistics"):
        incore = getattr(tm.mesh, name)(streamed=False)
        streamed = getattr(tm.mesh, name)(streamed=True, slab_rows=4)
        assert list(streamed) == list(incore), name
        if "gradient_mean" in incore:
            rms = float(np.sqrt(np.max(incore["gradient_moment2"])))
            np.testing.assert_allclose(streamed.pop("gradient_mean"), incore.pop("gradient_mean"),
                                       rtol=0, atol=1e-12 * rms)
        _close_dict(streamed, incore, f"{name}(streamed=True)")


def _series_dir(path, fields, times=(0.0, 0.1, 0.2)):
    from fava_tpu.io import synthetic

    for i, t in enumerate(times, start=1):
        synthetic.make_uniform_file(path / f"rt_hdf5_uniform_{i:04d}", ncells=(8, 12, 8),
                                    fields=fields, seed=i, time=t)


@pytest.mark.parametrize("fields", [("dens", "velx", "vely", "velz"),
                                    ("dens", "velx", "vely", "velz", "pres", "gamc")])
def test_summary_series_matches_fava_tpu(tmp_path, fields):
    _series_dir(tmp_path, fields)
    ref = fava_tpu.FLASH(tmp_path).summary_series(file_type="uni")
    tm = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    got = tm.summary_series(file_type="uni")
    assert list(got) == list(ref) and ("mach_rms" in got) == ("pres" in fields)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-14, err_msg=k)
    for row in range(3):
        tm.load(file_type="uni", file_index=row)
        for k, v in tm.turbulence_summary().items():
            assert got[k][row] == v, k


def test_summary_series_refuses_ragged_columns(tmp_path):
    from fava_tpu.io import synthetic

    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(8, 8, 8), seed=1)
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0002", ncells=(8, 8, 8), seed=2,
                                fields=("dens", "velx", "vely", "velz", "pres", "gamc"), time=0.1)
    with pytest.raises(ValueError, match="inconsistent stat columns"):
        fava_tpu_torch.FLASH(tmp_path, device="cpu").summary_series(file_type="uni")


def test_a8b_analyses_are_registered():
    for name in list(MODEL_CALLS) + ["velocity_gradient_statistics", "gradient_invariant_pdfs",
                                     "summary_series", "gradient_series"]:
        assert callable(getattr(fava_tpu_torch.Model, name)), name
    assert ck.shell_bin_sums_rfft_scalar is tvel.cuda_kernels.shell_bin_sums_rfft_scalar
