"""fava_tpu_torch's filtered (coarse-grained) kinetic-energy flux held to
fava_tpu on the CPU, in float64, to the NumPy oracle of
tests/oracles/coarse_grain.py and to the exact identities of
tests/test_coarse_grain.py.

The same seeded numpy fields go through fava_tpu/ops/coarse_grain.py (JAX
on the CPU, x64; its lax.scan over the cutoffs) and
fava_tpu_torch/ops/coarse_grain.py (CPU tensors; a Python loop). Cases:
both filter kernels, 2D and 3D, even and odd extents, domain lengths,
the constant-density limit, ``with_pressure``, ``sgs_flux_fields``, a
strong mean flow, every ``_prep`` error, the meshes and the registered
analysis.

Tolerances: rtol 1e-10 with atol 1e-12 of each output's scale (its
largest magnitude; the pointwise fields likewise): float64 on both sides,
FFTs and the symmetric (i, j) terms of Pi summed in another order. The
sharp-filter identity <Pi_l> = flux(k_c) of the transfer spectrum: rtol
1e-9 (fava_tpu's test). Oracles: fava_tpu's own test tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import coarse_grain as jcg
from fava_tpu_torch.ops import coarse_grain as tcg
from fava_tpu_torch.ops import velocity as tvel
from tests.oracles import coarse_grain as oracle
from tests.test_velocity import _band_limited_solenoidal

SHAPES = [(16, 16, 16), (16, 12, 8), (15, 9, 10), (16, 12), (9, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, seed=0, mean=0.0):
    rng = np.random.default_rng(seed)
    vels = [mean + rng.standard_normal(shape) for _ in shape]
    dens = 1.5 + 0.4 * rng.random(shape)
    pres = 2.0 + 0.3 * rng.random(shape)
    return vels, dens, pres


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, ref, what, rtol=1e-10, atol_rel=1e-12):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * float(np.abs(ref).max()),
                               err_msg=what)


def _close_dict(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k in ref:
        _close(got[k], ref[k], f"{what}/{k}")


def _both(vels, dens=None, pres=None, **kw):
    got = tcg.filtered_ke_flux(*map(_t, vels), dens=_t(dens), pres=_t(pres), **kw)
    ref = jcg.filtered_ke_flux(*map(_j, vels), dens=_j(dens), pres=_j(pres), **kw)
    return got, ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["gaussian", "sharp"])
@pytest.mark.parametrize("case", ["favre", "pressure", "incompressible"])
def test_flux_matches_fava_tpu(shape, kernel, case):
    vels, dens, pres = _fields(shape, sum(shape))
    lengths = tuple(0.5 * (i + 2) for i in range(len(shape))) if shape[0] == 16 else None
    got, ref = _both(vels, None if case == "incompressible" else dens,
                     pres if case == "pressure" else None, cutoffs=(2.0, 3.5, 6.0), kernel=kernel,
                     lengths=lengths)
    _close_dict(got, ref, f"{case} {kernel} {shape}")
    assert ("baropycnal_mean" in got) == (case == "pressure")


@pytest.mark.parametrize("kernel", ["gaussian", "sharp"])
def test_flux_with_strong_mean_flow_matches_fava_tpu(kernel):
    vels, dens, pres = _fields((16, 12, 10), 8, mean=10.0)
    got, ref = _both(vels, dens, pres, cutoffs=(2.0, 4.0), kernel=kernel)
    _close_dict(got, ref, f"mean flow {kernel}")


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8)])
@pytest.mark.parametrize("kernel", ["gaussian", "sharp"])
def test_favre_flux_matches_oracle(shape, kernel):
    vels, dens, pres = _fields(shape, 1)
    lengths = (1.0, 2.0, 0.5) if shape == (16, 12, 8) else None
    got = tcg.filtered_ke_flux(*map(_t, vels), dens=_t(dens), pres=_t(pres), cutoffs=(2.0, 4.0),
                               kernel=kernel, lengths=lengths)
    ref = oracle.filtered_ke_flux_oracle(vels, dens, (2.0, 4.0), kernel=kernel, lengths=lengths,
                                         pres=pres)
    for key in ("pi_mean", "pi_rms", "baropycnal_mean", "baropycnal_rms"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got["scale"], np.pi / np.asarray((2.0, 4.0)))
    np.testing.assert_array_equal(got["kc"], [2.0, 4.0])


@pytest.mark.parametrize("nd", [2, 3])
def test_incompressible_flux_matches_oracle(nd):
    vels, _, _ = _fields((16, 16, 16)[:nd], 2)
    got = tcg.filtered_ke_flux(*map(_t, vels), cutoffs=(3.0,), kernel="gaussian")
    ref = oracle.filtered_ke_flux_oracle(vels, None, (3.0,), kernel="gaussian")
    np.testing.assert_allclose(got["pi_mean"], ref["pi_mean"], rtol=1e-8)
    np.testing.assert_allclose(got["pi_rms"], ref["pi_rms"], rtol=1e-8)


@pytest.mark.parametrize("shape,pres", [((12, 16, 8), True), ((15, 9, 10), False), ((16, 12), True)])
@pytest.mark.parametrize("kernel", ["gaussian", "sharp"])
def test_pointwise_fields_match_fava_tpu_and_oracle(shape, pres, kernel):
    vels, dens, p = _fields(shape, 3)
    p = p if pres else None
    got = tcg.sgs_flux_fields(*map(_t, vels), cutoff=3.0, dens=_t(dens), pres=_t(p), kernel=kernel)
    ref = jcg.sgs_flux_fields(*map(_j, vels), cutoff=3.0, dens=_j(dens), pres=_j(p), kernel=kernel)
    assert sorted(got) == sorted(ref) == (["baropycnal", "pi"] if pres else ["pi"])
    for k in ref:
        assert tuple(got[k].shape) == shape
        _close(got[k].numpy(), np.asarray(ref[k]), f"sgs {k}")
    orc = oracle.sgs_flux_oracle(vels, dens, 3.0, kernel=kernel, pres=p)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), orc[k], rtol=1e-8, atol=1e-12)


def test_all_pass_sharp_filter_gives_zero_flux():
    """k_c beyond every grid mode: bar() is the identity and tau cancels
    exactly, so Pi is roundoff-zero (the round-trip check)."""
    vels, dens, _ = _fields((16, 16, 16), 4)
    out = tcg.sgs_flux_fields(*map(_t, vels), cutoff=np.sqrt(3.0) * 16.0, dens=_t(dens),
                              kernel="sharp")
    scale = float(np.max(np.abs(dens)) * max(np.max(np.abs(v)) for v in vels) ** 2)
    assert float(out["pi"].abs().max()) < 1e-10 * scale


@pytest.mark.parametrize("kc,shell", [(5.5, 5), (3.5, 3)])
def test_sharp_filter_mean_flux_equals_spectral_flux(kc, shell):
    """Galerkin identity: for a divergence-free u and the sharp projector at
    k_c, <Pi_l> = Pi_spectral(k_c) = -sum_{k<=k_c} T(k); the band limit
    (kmax 6 at n 16) keeps every product triad alias-free."""
    vels = [torch.tensor(v) for v in _band_limited_solenoidal(n=16, kmax=6.0, seed=7)]
    tr = tvel.transfer_spectrum(*vels)
    got = tcg.filtered_ke_flux(*vels, cutoffs=(kc,), kernel="sharp")
    np.testing.assert_allclose(got["pi_mean"][0], tr["flux"][shell], rtol=1e-9, atol=1e-14)
    assert abs(tr["flux"][shell]) > 1e-6


def test_constant_density_reduces_to_incompressible():
    vels, _, _ = _fields((12, 12, 12), 5)
    c = 2.75
    comp = tcg.filtered_ke_flux(*map(_t, vels), dens=_t(np.full((12, 12, 12), c)),
                                cutoffs=(3.0, 5.0))
    inc = tcg.filtered_ke_flux(*map(_t, vels), cutoffs=(3.0, 5.0))
    np.testing.assert_allclose(comp["pi_mean"], c * inc["pi_mean"], rtol=1e-9)
    np.testing.assert_allclose(comp["pi_rms"], c * inc["pi_rms"], rtol=1e-9)


V, V2, V1 = (8, 8, 8), (8, 8), (8, 8, 1)


@pytest.mark.parametrize("call,match", [
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), cutoffs=(2.0,), kernel="boxcar"),
     "kernel"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), cutoffs=()), "cutoffs"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), cutoffs=(-1.0,)), "cutoffs"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), cutoffs=[[2.0]]), "cutoffs"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), pres=z(V), cutoffs=(2.0,)), "density"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), cutoffs=(2.0,)), "components"),
    (lambda cg, z: cg.filtered_ke_flux(z(V2), z(V2), dens=z(V1), cutoffs=(2.0,)), "dens shape"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), dens=z(V), pres=z(V1), cutoffs=(2.0,)),
     "pres shape"),
    (lambda cg, z: cg.filtered_ke_flux(z(V), z(V), z(V), cutoffs=(2.0,), lengths=(1.0, 1.0)),
     "lengths"),
    (lambda cg, z: cg.sgs_flux_fields(z(V), z(V), z(V), cutoff=0.0), "cutoffs"),
    (lambda cg, z: cg.sgs_flux_fields(z(V), z(V), z(V), cutoff=2.0, kernel="tophat"), "kernel"),
    (lambda cg, z: cg.sgs_flux_fields(z(V), z(V), z(V), cutoff=2.0, pres=z(V)), "density"),
])
def test_prep_errors_are_fava_tpus(call, match):
    """Every check of fava_tpu's ``_prep`` (and the velocity checks before
    it) raises in both packages with the same message."""
    with pytest.raises(ValueError, match=match) as got:
        call(tcg, torch.zeros)
    with pytest.raises(ValueError) as ref:
        call(jcg, jnp.zeros)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# Meshes and registration


def test_mesh_method_and_registration_match_fava_tpu(uniform_file):
    jm, tm = fava_tpu.FLASH(uniform_file.parent), fava_tpu_torch.FLASH(uniform_file.parent,
                                                                          device="cpu")
    jm.load(file_type="uni")
    tm.load(file_type="uni")
    for kw in ({"cutoffs": (2.0, 4.0)}, {"cutoffs": [3.0], "kernel": "sharp"}, {}):
        _close_dict(tm.filtered_kinetic_energy_flux(**kw), jm.filtered_kinetic_energy_flux(**kw),
                    f"model {kw}")
        _close_dict(tm.mesh.filtered_kinetic_energy_flux(**kw),
                    jm.mesh.filtered_kinetic_energy_flux(**kw), f"mesh {kw}")
    vols = {n: tm.mesh.data(n).numpy() for n in ("dens", "velx", "vely", "velz")}
    ref = oracle.filtered_ke_flux_oracle([vols["velx"], vols["vely"], vols["velz"]], vols["dens"],
                                         (2.0, 4.0), lengths=tm.mesh._domain_lengths())
    got = tm.filtered_kinetic_energy_flux(cutoffs=(2.0, 4.0))
    np.testing.assert_allclose(got["pi_mean"], ref["pi_mean"], rtol=1e-8)
    with pytest.raises(KeyError, match="pres"):  # no pres on the synthetic file
        tm.mesh.filtered_kinetic_energy_flux(with_pressure=True)


def test_mesh_with_pressure_matches_fava_tpu(tmp_path):
    from fava_tpu.io import synthetic

    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0003", ncells=(12, 12, 10), seed=9,
                                fields=("dens", "velx", "vely", "velz", "pres"))
    jm, tm = fava_tpu.FLASH(tmp_path), fava_tpu_torch.FLASH(tmp_path, device="cpu")
    jm.load(file_type="uni")
    tm.load(file_type="uni")
    for kernel in ("gaussian", "sharp"):
        kw = {"cutoffs": (3.0, 5.0), "with_pressure": True, "kernel": kernel}
        got = tm.filtered_kinetic_energy_flux(**kw)
        _close_dict(got, jm.filtered_kinetic_energy_flux(**kw), f"pressure {kernel}")
        assert np.isfinite(got["baropycnal_mean"]).all()


def test_2d_mesh_flux_matches_squeezed_op(tmp_path):
    """tests/test_2d.py's case on the port: a (16, 16, 1) file, whose
    dens must be squeezed like the velocities."""
    from fava_tpu_torch.io import synthetic

    rng = np.random.default_rng(4)
    fields = {"dens": np.abs(1.0 + 0.2 * rng.standard_normal((16, 16, 1))),
              "velx": rng.standard_normal((16, 16, 1)), "vely": rng.standard_normal((16, 16, 1))}
    path = synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(16, 16, 1),
                                       field_data=fields, ndim=2)
    tm = fava_tpu_torch.FLASH(path.parent, device="cpu")
    tm.load(file_type="uni")
    got = tm.filtered_kinetic_energy_flux(cutoffs=(3.0, 5.0))
    vols = {k: tm.mesh.data(k).numpy()[:, :, 0] for k in fields}  # the file's values
    ref = jcg.filtered_ke_flux(jnp.asarray(vols["velx"]), jnp.asarray(vols["vely"]),
                               dens=jnp.asarray(vols["dens"]), cutoffs=(3.0, 5.0),
                               lengths=tm.mesh._domain_lengths())
    _close_dict(got, ref, "2d mesh")
