"""fava_tpu_torch's structure functions, increment PDFs and scaling
exponents held to fava_tpu on the CPU, in float64.

The same numpy fields and seeds go to both packages; their Threefry draws
are bit-exact (tests/test_torch_prng.py), so both sample the same point
pairs and gather the same cells. Tolerances:
* structure functions, both modes, isotropic and anisotropic, 3D and 2D:
  rtol 1e-10 (float64 on both sides; ``x ** p`` and the sums may round
  differently in the last place);
* increment PDFs: counts exact; mean, std, skewness and flatness rtol
  1e-10 of fava_tpu's, and rtol 1e-12 of float64 moments taken here on
  the same gathers (the port's own draw), so a skewness slip cannot hide
  behind a matching reference;
* scaling exponents and She-Leveque: rtol 1e-12 (the same host fits);
* order 1 of the shared-sample mode equals the resample mode exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import structure as jstruct
from fava_tpu_torch.ops import structure as tstruct
from fava_tpu_torch.utils import prng

COMPS = ("longitudinal", "transverse")


def _fields(shape, seed, ndim=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(ndim)]


def _domain(ndim=3):
    return np.array([[0.0, 1.0], [-0.5, 0.7], [0.2, 1.1]])[:ndim]


def _both(fn_name, vels, **kw):
    ref = getattr(jstruct, fn_name)([jnp.asarray(v) for v in vels], **kw)
    got = getattr(tstruct, fn_name)([torch.from_numpy(v) for v in vels], **kw)
    return got, ref


def _close_sf(got, ref, rtol=1e-10):
    np.testing.assert_array_equal(got["separations"], ref["separations"])
    for comp in COMPS:
        assert sorted(got[comp]) == sorted(ref[comp]) == sorted(f"{o}" for o in range(1, 11))
        for o in range(1, 11):
            np.testing.assert_allclose(got[comp][f"{o}"], ref[comp][f"{o}"], rtol=rtol, atol=0,
                                       err_msg=f"{comp} {o}")


@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("anisotropic", [False, True])
@pytest.mark.parametrize("shape", [(12, 10, 14), (16, 12)])
def test_structure_functions_equal_fava_tpu(resample, anisotropic, shape):
    vels = _fields(shape, sum(shape), ndim=len(shape))
    got, ref = _both("structure_functions", vels, domain_bounds=_domain(len(shape)), num_seps=5,
                     num_points=300, sep_bounds=(0.05, 0.45), seed=11, anisotropic=anisotropic,
                     resample_per_order=resample)
    _close_sf(got, ref)
    assert np.isfinite(got["longitudinal"]["10"]).all()


@pytest.mark.parametrize("log_scale,sep_bounds", [(True, None), (False, (0.0, 0.3))])
def test_structure_function_separations_equal_fava_tpu(log_scale, sep_bounds):
    vels = _fields((8, 10, 6), 3)
    got, ref = _both("structure_functions", vels, domain_bounds=_domain(), num_seps=4,
                     num_points=64, sep_bounds=sep_bounds, log_scale=log_scale)
    _close_sf(got, ref)


def test_seed_keeps_all_64_bits():
    vels = _fields((8, 8, 8), 5)
    kw = dict(domain_bounds=_domain(), num_seps=4, num_points=64, sep_bounds=(0.1, 0.4))
    big = (1 << 32) + 7
    got, ref = _both("structure_functions", vels, seed=big, **kw)
    _close_sf(got, ref)
    low = tstruct.structure_functions([torch.from_numpy(v) for v in vels], seed=7, **kw)
    assert not np.allclose(got["longitudinal"]["2"], low["longitudinal"]["2"])


def test_shared_mode_order1_equals_the_resample_mode():
    vels = [torch.from_numpy(v) for v in _fields((8, 8, 8), 2)]
    kw = dict(domain_bounds=_domain(), num_seps=4, num_points=256, sep_bounds=(0.1, 0.4), seed=9)
    a = tstruct.structure_functions(vels, resample_per_order=True, **kw)
    b = tstruct.structure_functions(vels, resample_per_order=False, **kw)
    for comp in COMPS:
        np.testing.assert_array_equal(a[comp]["1"], b[comp]["1"])
        assert not np.array_equal(a[comp]["2"], b[comp]["2"])  # fresh pairs for order 2


def test_constant_field_gives_zero_and_validation():
    vels = [torch.ones((8, 8, 8), dtype=torch.float64) for _ in range(3)]
    for resample in (True, False):
        out = tstruct.structure_functions(vels, domain_bounds=_domain(), num_seps=3, num_points=32,
                                          sep_bounds=(0.1, 0.4), resample_per_order=resample)
        for comp in COMPS:
            for o in range(1, 11):
                np.testing.assert_array_equal(out[comp][f"{o}"], 0.0)
    with pytest.raises(ValueError, match="must be positive"):
        tstruct.structure_functions(vels, domain_bounds=_domain(), num_seps=4, num_points=8,
                                    sep_bounds=(0.0, 1.0))


def _same_draw_moments(vels, separations, num_points, nbins, nsigma, seed, anisotropic=False):
    """float64 moments and np.histogram counts of the port's own draw
    (``_draw_increments`` on the same gathers), taken here in numpy."""
    t = [torch.from_numpy(v) for v in vels]
    ndim, _, lo, width, cell = tstruct._geometry(t, _domain(len(vels)))
    dv, _, rhat = tstruct._draw_increments(t, separations, lo, width, cell, seed,
                                           tstruct._INC_STREAM, num_points=num_points,
                                           anisotropic=anisotropic)
    dv, rhat = dv.numpy(), rhat.numpy()
    if ndim == 2:
        that = np.stack([-rhat[..., 1], rhat[..., 0]], axis=-1)
    else:
        a = np.where(np.abs(rhat[..., 2:3]) > 0.9, [1.0, 0.0, 0.0], [0.0, 0.0, 1.0])
        that = np.cross(a, rhat)
        that /= np.sqrt((that**2).sum(-1, keepdims=True))
    edges = np.linspace(-nsigma, nsigma, nbins + 1)
    out = {}
    for comp, x in (("longitudinal", (dv * rhat).sum(-1)), ("transverse", (dv * that).sum(-1))):
        mean = x.mean(axis=1)
        c = x - mean[:, None]
        m2 = (c * c).mean(axis=1)
        out[comp] = {"mean": mean, "std": np.sqrt(m2), "skewness": (c**3).mean(axis=1) / m2**1.5,
                     "flatness": (c**4).mean(axis=1) / m2**2,
                     "counts": np.stack([np.histogram(row / np.sqrt(v), bins=edges)[0]
                                         for row, v in zip(c, m2)])}
    return out


@pytest.mark.parametrize("anisotropic", [False, True])
@pytest.mark.parametrize("shape", [(12, 12, 12), (10, 14, 8), (16, 12)])
def test_increment_pdfs_equal_fava_tpu_and_same_draw_moments(anisotropic, shape):
    vels = _fields(shape, 7 + sum(shape), ndim=len(shape))
    kw = dict(domain_bounds=_domain(len(shape)), num_seps=4, num_points=400,
              sep_bounds=(0.08, 0.35), nbins=15, nsigma=6.0, seed=11, anisotropic=anisotropic)
    got, ref = _both("velocity_increment_pdfs", vels, **kw)
    np.testing.assert_array_equal(got["separations"], ref["separations"])
    np.testing.assert_array_equal(got["edges"], ref["edges"])
    own = _same_draw_moments(vels, got["separations"], 400, 15, 6.0, 11, anisotropic)
    for comp in COMPS:
        assert got[comp]["counts"].shape == (4, 15)
        np.testing.assert_array_equal(got[comp]["counts"], ref[comp]["counts"])
        np.testing.assert_array_equal(got[comp]["counts"], own[comp]["counts"])
        for k in ("mean", "std", "skewness", "flatness"):
            np.testing.assert_allclose(got[comp][k], ref[comp][k], rtol=1e-10, atol=1e-13, err_msg=k)
            np.testing.assert_allclose(got[comp][k], own[comp][k], rtol=1e-12, atol=1e-14, err_msg=k)


def test_increment_pdfs_of_a_constant_field():
    vels = [torch.full((8, 8, 8), 2.5, dtype=torch.float64) for _ in range(3)]
    out = tstruct.velocity_increment_pdfs(vels, domain_bounds=_domain(), num_seps=3,
                                          num_points=64, sep_bounds=(0.1, 0.3), nbins=5)
    for comp in COMPS:
        np.testing.assert_array_equal(out[comp]["counts"][:, 2], 64)
        assert np.isnan(out[comp]["skewness"]).all() and np.isnan(out[comp]["flatness"]).all()
        np.testing.assert_array_equal(out[comp]["std"], 0.0)


def test_draws_equal_fava_tpu_and_the_prewrap_direction_is_minimal_image():
    """The shared draw: dv, the wrapped rhat and the pre-wrap dirhat equal
    fava_tpu's; sep * dirhat is the minimal-image separation, and the
    wrapped rhat differs exactly where an endpoint wrapped."""
    vols = _fields((8, 8, 8), 3)
    width = np.ones(3)
    seps = np.array([0.35, 0.49])
    t = [torch.from_numpy(v) for v in vols]
    got = tstruct._draw_increments(t, seps, np.zeros(3), width, width / 8, 0, tstruct._INC_STREAM,
                                   num_points=512, anisotropic=False)
    ref = jstruct._draw_increments(tuple(jnp.asarray(v) for v in vols), jnp.asarray(seps),
                                   jnp.zeros(3), jnp.asarray(width), jnp.asarray(width / 8),
                                   (0, 0), jstruct._INC_STREAM, num_seps=2, num_points=512,
                                   ndim=3, vol_shape=(8, 8, 8), anisotropic=False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14, atol=1e-15)
    dirhat = got[2].numpy()
    u_pos = prng.uniform(0, tstruct._INC_STREAM, (2, 512, 3), torch.float64).numpy()
    disp = seps[:, None, None] * dirhat
    p2 = np.mod(u_pos + disp, width)
    np.testing.assert_allclose(np.mod(p2 - u_pos + width / 2, width) - width / 2, disp, atol=1e-12)
    wrapped = np.any(np.abs(p2 - u_pos - disp) > 1e-9, axis=-1)
    assert wrapped.any()
    np.testing.assert_array_equal(np.abs(got[1].numpy() - dirhat).max(axis=-1) > 1e-6, wrapped)


def test_argument_validation():
    vels = [torch.ones((4, 4, 4), dtype=torch.float64) for _ in range(3)]
    run = tstruct.velocity_increment_pdfs
    with pytest.raises(ValueError, match="num_points"):
        run(vels, domain_bounds=_domain(), num_points=2**24)
    with pytest.raises(ValueError, match="num_points"):
        run(vels, domain_bounds=_domain(), num_points=0)
    with pytest.raises(ValueError, match="nbins"):
        run(vels, domain_bounds=_domain(), nbins=0)
    with pytest.raises(ValueError, match="nsigma"):
        run(vels, domain_bounds=_domain(), nsigma=0.0)
    with pytest.raises(ValueError, match="must be positive"):
        run(vels, domain_bounds=_domain(), sep_bounds=(0.0, 0.5), log_scale=True)


@pytest.mark.parametrize("ess,fit_range,reference_order", [(True, None, 3), (False, None, 3),
                                                            (True, (0.1, 0.3), 2),
                                                            (False, (0.08, 0.4), 3)])
def test_scaling_exponents_equal_fava_tpu(ess, fit_range, reference_order):
    vels = _fields((12, 12, 12), 13)
    vsfs = jstruct.structure_functions([jnp.asarray(v) for v in vels], domain_bounds=_domain(),
                                       num_seps=8, num_points=500, sep_bounds=(0.08, 0.4))
    kw = dict(reference_order=reference_order, fit_range=fit_range, ess=ess)
    got, ref = tstruct.scaling_exponents(vsfs, **kw), jstruct.scaling_exponents(vsfs, **kw)
    assert got["ess"] == ref["ess"] and got["reference_order"] == ref["reference_order"]
    np.testing.assert_array_equal(got["orders"], ref["orders"])
    for comp in COMPS:
        for k in ("zeta", "zeta_err"):
            np.testing.assert_allclose(got[comp][k], ref[comp][k], rtol=1e-12, atol=0)


def test_scaling_exponents_edge_cases():
    seps = np.geomspace(0.1, 0.4, 6)
    vsfs = {"separations": seps,
            "longitudinal": {f"{o}": seps ** (o / 3.0) for o in range(1, 4)},
            "transverse": {f"{o}": np.where(seps > 0.2, seps ** (o / 3.0), 0.0) for o in range(1, 4)}}
    got = tstruct.scaling_exponents(vsfs, ess=False)
    ref = jstruct.scaling_exponents(vsfs, ess=False)
    np.testing.assert_allclose(got["longitudinal"]["zeta"], [1 / 3, 2 / 3, 1.0], rtol=1e-12)
    for comp in COMPS:  # non-positive samples leave the fit; fewer than 3 give NaN
        np.testing.assert_allclose(got[comp]["zeta"], ref[comp]["zeta"], rtol=1e-12)
    with pytest.raises(ValueError, match="fit_range"):
        tstruct.scaling_exponents(vsfs, fit_range=(0.1, 0.12))
    with pytest.raises(ValueError, match="reference_order"):
        tstruct.scaling_exponents(vsfs, reference_order=5)


def test_she_leveque_equals_fava_tpu():
    p = np.arange(1, 11)
    np.testing.assert_allclose(tstruct.she_leveque(p), jstruct.she_leveque(p), rtol=1e-12, atol=0)
    assert tstruct.she_leveque([3])[0] == pytest.approx(1.0, abs=1e-12)


@pytest.fixture()
def models(uniform_file):
    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    return jm, tm


def test_mesh_methods_and_registered_analyses(models):
    jm, tm = models
    kw = dict(num_seps=3, num_points=64, sep_bounds=(0.1, 0.3))
    _close_sf(tm.structure_functions(**kw), jm.structure_functions(**kw))
    _close_sf(tm.structure_functions(anistropic=True, **kw), jm.structure_functions(anistropic=True, **kw))
    _close_sf(tm.mesh.structure_functions(resample_per_order=False, seed=4, **kw),
              jm.mesh.structure_functions(resample_per_order=False, seed=4, **kw))
    got = tm.structure_function_exponents(num_seps=6, num_points=128, sep_bounds=(0.1, 0.4))
    ref = jm.structure_function_exponents(num_seps=6, num_points=128, sep_bounds=(0.1, 0.4))
    for comp in COMPS:
        np.testing.assert_allclose(got[comp]["zeta"], ref[comp]["zeta"], rtol=1e-10)
    vsfs = tm.structure_functions(**kw)
    reuse = tm.structure_function_exponents(vsfs=vsfs, ess=False)
    np.testing.assert_array_equal(reuse["longitudinal"]["zeta"],
                                  tstruct.scaling_exponents(vsfs, ess=False)["longitudinal"]["zeta"])
    pkw = dict(num_seps=3, num_points=64, sep_bounds=(0.1, 0.3), nbins=9)
    gp, rp = tm.velocity_increment_pdfs(**pkw), jm.velocity_increment_pdfs(**pkw)
    for comp in COMPS:
        np.testing.assert_array_equal(gp[comp]["counts"], rp[comp]["counts"])
        np.testing.assert_allclose(gp[comp]["flatness"], rp[comp]["flatness"], rtol=1e-10)
    for name in ("fractal_dimension", "structure_functions", "structure_function_exponents",
                 "velocity_increment_pdfs"):
        assert hasattr(fava_tpu_torch.Model, name), name


def test_mesh_rejects_unknown_keywords(models):
    _, tm = models
    with pytest.raises(TypeError, match="unexpected keyword"):
        tm.mesh.structure_functions(num_seps=3, num_points=16, sep_bounds=(0.1, 0.3), nonsense=1)


def test_2d_mesh_samples_its_planes(tmp_path):
    """A 2D uniform file: the port's mesh takes the (nx, ny) planes, so
    its structure functions and PDFs equal fava_tpu's on the 2D arrays
    (fava_tpu's mesh passes (nx, ny, 1) volumes, which its 2D gather
    does not take)."""
    from fava_tpu.io import synthetic

    rng = np.random.default_rng(4)
    n = 16
    fields = {"dens": np.abs(1.0 + 0.2 * rng.standard_normal((n, n, 1))),
              "velx": rng.standard_normal((n, n, 1)), "vely": rng.standard_normal((n, n, 1))}
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(n, n, 1),
                                field_data=fields, ndim=2)
    tm = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    tm.load(file_type="uni")
    vels = [tm.mesh.data(f"vel{a}").numpy()[:, :, 0] for a in "xy"]  # the file's values
    kw = dict(num_seps=3, num_points=100, sep_bounds=(0.1, 0.3), seed=2)
    ref = jstruct.structure_functions([jnp.asarray(v) for v in vels],
                                      domain_bounds=[[0.0, 1.0], [0.0, 1.0]], **kw)
    _close_sf(tm.structure_functions(**kw), ref)
    refp = jstruct.velocity_increment_pdfs([jnp.asarray(v) for v in vels],
                                           domain_bounds=[[0.0, 1.0], [0.0, 1.0]], nbins=7, **kw)
    gotp = tm.velocity_increment_pdfs(nbins=7, **kw)
    for comp in COMPS:
        np.testing.assert_array_equal(gotp[comp]["counts"], refp[comp]["counts"])
