"""fava_tpu_torch's two-point and velocity correlations held to fava_tpu on
the CPU, in float64, and to the brute-force oracles of tests/test_twopoint.py.

The same seeded numpy fields go through fava_tpu/ops/twopoint.py (JAX on
the CPU, x64) and fava_tpu_torch/ops/twopoint.py (CPU tensors, so the
shell average of the correlation volume runs the plain twins of K3 + the
single-channel walk for even x and y extents and of B10 otherwise, and
index_add_ in 2D). fava_tpu's 3D binning runs its jnp reference, as its
own tests run it; one case runs its Pallas kernels in interpret mode.
Cases: 2D and 3D, even and odd extents, domain lengths, other nbins, a
strong mean, the meshes (file and from_arrays, 2D and 3D) and the
registered analyses.

Tolerances: rtol 1e-10 with atol 1e-12 of each output's scale (its
largest finite magnitude): float64 on both sides, FFTs and sums in
another order. NaN (empty shells) in the same places. The integral
scales are held the same way: in float64 both runs cross zero at the
same sample. Oracles: fava_tpu's own test tolerances.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu.ops import twopoint as jtp
from fava_tpu_torch.ops import twopoint as ttp
from tests.test_twopoint import _brute_line

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(16, 12, 8), (15, 9, 10), (8, 8, 9), (9, 16, 12), (16, 12), (9, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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
        _close(got[k], ref[k], f"{what}/{k}")


def _lengths(shape, kind):
    return None if kind is None else tuple(0.5 * (i + 1) for i in range(len(shape)))


# ---------------------------------------------------------------------------
# two_point_correlation


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lengths", [None, "box"])
def test_two_point_correlation_matches_fava_tpu(shape, lengths):
    f = np.random.default_rng(sum(shape)).standard_normal(shape)
    ls = _lengths(shape, lengths)
    got = ttp.two_point_correlation(torch.tensor(f), lengths=ls)
    ref = jtp.two_point_correlation(jnp.asarray(f), lengths=ls)
    _close_dict(got, ref, f"two_point {shape}")
    assert got["R_shell"].size == max(min(shape) // 2, 1)


@pytest.mark.parametrize("shape,nbins", [((16, 12, 8), 4), ((15, 9, 10), 9), ((16, 12), 7)])
def test_two_point_correlation_nbins_and_strong_mean(shape, nbins):
    """Other shell counts, on a field whose mean is 10 times its spread:
    the float64 mean removal leaves the variance exact."""
    f = 10.0 + np.random.default_rng(nbins).standard_normal(shape)
    got = ttp.two_point_correlation(torch.tensor(f), nbins=nbins)
    ref = jtp.two_point_correlation(jnp.asarray(f), nbins=nbins)
    _close_dict(got, ref, f"two_point nbins={nbins}")
    np.testing.assert_allclose(got["variance"], np.var(f), rtol=1e-10)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8)])
def test_two_point_correlation_matches_fava_tpu_kernels_in_interpret_mode(shape):
    """fava_tpu's fold and folded-walk Pallas kernels (interpret mode) on
    the signed correlation volume against the port's plain twins of K3 and
    the single-channel walk."""
    f = np.random.default_rng(3).standard_normal(shape)
    pk.FORCE_INTERPRET = True
    try:
        ref = jtp.two_point_correlation(jnp.asarray(f))
    finally:
        pk.FORCE_INTERPRET = False
    _close_dict(ttp.two_point_correlation(torch.tensor(f)), ref, "two_point (interpret)")


@pytest.mark.parametrize("shape", [(16, 12, 8), (16, 12)])
def test_scalar_lines_match_brute_force(shape):
    f = np.random.default_rng(5).standard_normal(shape)
    got = ttp.two_point_correlation(torch.tensor(f))
    for a, ax in enumerate("xyz"[: len(shape)]):
        ref = _brute_line(f, a)[: shape[a] // 2 + 1]
        np.testing.assert_allclose(got[f"R_{ax}"] * got["variance"], ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["variance"], np.var(f), rtol=1e-10)
    np.testing.assert_allclose(got["R_shell"][0], 1.0, rtol=1e-10)


def test_shell_average_matches_brute_force():
    f = np.random.default_rng(6).standard_normal((8, 8, 8))
    fm = f - f.mean()
    R = np.zeros(f.shape)
    for i in range(8):
        for j in range(8):
            for k in range(8):
                R[i, j, k] = np.mean(fm * np.roll(fm, (-i, -j, -k), axis=(0, 1, 2)))
    d = np.minimum(np.arange(8), 8 - np.arange(8)).astype(np.float64)
    r_abs = np.sqrt(d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2)
    nb = 4
    idx = np.clip(np.floor(r_abs + 0.5).astype(int), 0, nb - 1)
    mask = r_abs <= nb - 0.5
    ref = np.array([R[mask & (idx == b)].mean() for b in range(nb)])
    got = ttp.two_point_correlation(torch.tensor(f), nbins=nb)
    np.testing.assert_allclose(got["R_shell"] * got["variance"], ref, rtol=1e-9)


def test_single_mode_closed_form():
    """f = cos(2 pi k0 x / n): R(r)/R(0) = cos(2 pi k0 r / n) exactly, the
    integral scale is L/(2 pi k0), and the y line is identically 1."""
    n, k0 = 64, 3
    x = np.arange(n) / n
    f = np.broadcast_to(np.cos(2 * np.pi * k0 * x)[:, None, None], (n, n, n)).copy()
    got = ttp.two_point_correlation(torch.tensor(f))
    np.testing.assert_allclose(got["R_x"], np.cos(2 * np.pi * k0 * np.arange(n // 2 + 1) / n),
                               rtol=1e-8, atol=1e-10)
    assert abs(got["integral_scale_x"] - 1.0 / (2 * np.pi * k0)) < 2e-3
    np.testing.assert_allclose(got["R_y"], 1.0, rtol=1e-8)


def test_integral_scale_is_fava_tpus():
    lines = [np.array([1.0, 0.5, 0.0, -0.5]), np.array([2.0, 1.0, 1.0]),
             np.array([0.0, 0.0]), np.array([1.0, -0.2, 0.3]), np.array([np.nan, 1.0])]
    for line in lines:
        for dx in (0.5, 1.0):
            got, ref = ttp._integral_scale(line, dx), jtp._integral_scale(line, dx)
            assert got == ref or (np.isnan(got) and np.isnan(ref)), (line, dx)
    np.testing.assert_allclose(ttp._integral_scale(lines[0], 0.5), 0.5)
    np.testing.assert_allclose(ttp._integral_scale(lines[1], 1.0), 1.25)


# ---------------------------------------------------------------------------
# velocity_correlations


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lengths", [None, "box"])
def test_velocity_correlations_match_fava_tpu(shape, lengths):
    rng = np.random.default_rng(7 + sum(shape))
    vels = [rng.standard_normal(shape) for _ in shape]
    ls = _lengths(shape, lengths)
    got = ttp.velocity_correlations(*[torch.tensor(v) for v in vels], lengths=ls)
    ref = jtp.velocity_correlations(*[jnp.asarray(v) for v in vels], lengths=ls)
    _close_dict(got, ref, f"velocity_correlations {shape}")


def test_velocity_correlations_strong_mean_flow():
    rng = np.random.default_rng(34)
    shape = (16, 12, 10)
    vels = [10.0 + rng.standard_normal(shape), rng.standard_normal(shape) - 5.0,
            rng.standard_normal(shape)]
    got = ttp.velocity_correlations(*[torch.tensor(v) for v in vels])
    ref = jtp.velocity_correlations(*[jnp.asarray(v) for v in vels])
    _close_dict(got, ref, "velocity_correlations mean flow")


@pytest.mark.parametrize("shape", [(16, 12, 8), (16, 12)])
def test_velocity_correlations_match_brute_force(shape):
    nd = len(shape)
    rng = np.random.default_rng(7)
    vels = [rng.standard_normal(shape) for _ in range(nd)]
    got = ttp.velocity_correlations(*[torch.tensor(v) for v in vels],
                                    lengths=tuple(0.5 * (i + 1) for i in range(nd)))
    packed = ttp._velocity_corr([[torch.tensor(v) for v in vels]],
                                fava_tpu_torch.parallel.SpaceRanks()).numpy()
    halves = [n // 2 + 1 for n in shape]
    for a, ax in enumerate("xyz"[:nd]):
        fl = _brute_line(vels[a], a)
        np.testing.assert_allclose(got[f"f_{ax}"], (fl / fl[0])[: halves[a]], rtol=1e-9, atol=1e-12)
        gs = [_brute_line(vels[i], a) for i in range(nd) if i != a]
        gn = np.mean([(g / g[0])[: halves[a]] for g in gs], axis=0)
        np.testing.assert_allclose(got[f"g_{ax}"], gn, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got[f"r_{ax}"][1], 0.5 * (a + 1) / shape[a], rtol=1e-12)
        # the raw line at r = 0 is the component variance (comp-major packing)
        np.testing.assert_allclose(packed[a * sum(halves) + sum(halves[:a])], np.var(vels[a]),
                                   rtol=1e-9)
        np.testing.assert_allclose(got[f"isotropy_ratio_{ax}"],
                                   got[f"L11_{ax}"] / (2 * got[f"L22_{ax}"]))


def test_validation_errors():
    with pytest.raises(ValueError, match="2D or 3D"):
        ttp.two_point_correlation(torch.zeros(8))
    with pytest.raises(ValueError, match="lengths"):
        ttp.two_point_correlation(torch.zeros((8, 8)), lengths=(1.0,))
    v = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="components"):
        ttp.velocity_correlations(v, v)
    with pytest.raises(ValueError, match="component 1"):
        ttp.velocity_correlations(v, torch.zeros((8, 8, 1)), v)


# ---------------------------------------------------------------------------
# Meshes and registration


def test_mesh_methods_and_registration_match_fava_tpu(uniform_file):
    jm, tm = fava_tpu.FLASH(uniform_file.parent), fava_tpu_torch.FLASH(uniform_file.parent,
                                                                          device="cpu")
    jm.load(file_type="uni")
    tm.load(file_type="uni")
    for name, kw in (("two_point_correlation", {"field": "dens"}),
                     ("two_point_correlation", {"field": "velx", "nbins": 4}),
                     ("velocity_correlations", {})):
        _close_dict(getattr(tm, name)(**kw), getattr(jm, name)(**kw), f"{name} {kw}")
        _close_dict(getattr(tm.mesh, name)(**kw), getattr(jm.mesh, name)(**kw), f"mesh {name}")
    dens = tm.mesh.data("dens").numpy()
    got = tm.mesh.two_point_correlation(field="dens")
    np.testing.assert_allclose(got["R_x"] * got["variance"],
                               _brute_line(dens, 0)[: dens.shape[0] // 2 + 1], rtol=1e-9,
                               atol=1e-12)


def test_2d_mesh_correlations_match_fava_tpu():
    rng = np.random.default_rng(61)
    arrays = {k: rng.standard_normal((16, 12)) for k in ("velx", "vely", "dens")}
    bounds = [[0.0, 2.0], [0.0, 1.5]]
    jm = fava_tpu.from_arrays(arrays, domain_bounds=bounds)
    tm = fava_tpu_torch.from_arrays(arrays, domain_bounds=bounds, device="cpu")
    _close_dict(tm.two_point_correlation("dens"), jm.two_point_correlation("dens"), "2d two_point")
    _close_dict(tm.velocity_correlations(), jm.velocity_correlations(), "2d velocity")


def test_amr_model_gets_clear_error(amr_file):
    m = fava_tpu_torch.FLASH(amr_file.parent, device="cpu")
    m.load(file_type="plt")
    with pytest.raises(AttributeError, match="from_amr"):
        m.two_point_correlation(field="dens")
    with pytest.raises(AttributeError, match="from_amr"):
        m.velocity_correlations()


def test_registered_correlations_unloaded_model_message():
    m = fava_tpu_torch.FLASH(".", device="cpu")
    with pytest.raises(AttributeError, match="load"):
        m.two_point_correlation()


def _registered(package: str):
    """Names of the functions a package's analysis modules register."""
    pattern = re.compile(r"@Model\.register_analysis\([^)]*\)\s*\ndef (\w+)")
    return {name for path in (REPO / package / "analysis").glob("*.py")
            for name in pattern.findall(path.read_text())}


def test_the_port_registers_39_analyses():
    got, ref = _registered("fava_tpu_torch"), _registered("fava_tpu")
    assert {"two_point_correlation", "velocity_correlations", "filtered_kinetic_energy_flux"} <= got
    # Every registered analysis of fava_tpu is ported (the six particle ones last).
    assert {"particle_series", "particle_structure_functions", "dispersion_statistics",
            "cross_correlation", "eulerian_autocorrelation", "lagrangian_autocorrelation"} <= got
    assert len(got) == 45 and got == ref, sorted(ref ^ got)
    for name in got:
        assert callable(getattr(fava_tpu_torch.Model, name)), name
