"""fava_tpu_torch's line-of-sight projections held to fava_tpu's, on the
CPU in float64.

The same seeded numpy inputs (and the same synthetic AMR file) go
through ``fava_tpu.ops.projection`` and ``fava_tpu_torch.ops.projection``.
Tolerances: rtol 1e-12 against fava_tpu and against the regrid-then-sum
oracle (tests/oracles/regrid.py; line integrals of piecewise-constant
AMR data commute with the piecewise-constant regrid): float64 sums of
the same products in another order. Mass conservation: rtol 1e-9, as
tests/test_projection.py. fava_tpu's sharded case is ROADMAP A11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.io import synthetic
from fava_tpu.ops import projection as jax_proj
from fava_tpu.ops import regrid as jax_regrid
from fava_tpu_torch.ops import projection as torch_proj
from fava_tpu_torch.ops import regrid as torch_regrid
from tests.oracles.regrid import from_amr_oracle

RTOL = 1e-12


def _plans(mesh, **kw):
    args = dict(
        block_bounds=np.asarray(mesh.block_bounds),
        node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level),
        ncells_vec=mesh.nCellsVec,
        nblks_vec=mesh.nBlksVec,
        ndim=3,
        **kw,
    )
    return jax_regrid.RegridPlan(**args), torch_regrid.RegridPlan(**args)


@pytest.fixture(scope="module")
def amr_meshes(tmp_path_factory):
    path = tmp_path_factory.mktemp("tproj") / "rt_hdf5_plt_cnt_0001"
    synthetic.make_amr_file(path, ncells=(8, 8, 8), nblks=(2, 2, 2), refine={0: 2, 3: 3})
    jm = fava_tpu.FLASH(path.parent)
    jm.load(file_type="plt")
    tm = fava_tpu_torch.FLASH(path.parent, device="cpu")
    tm.load(file_type="plt")
    return jm.mesh, tm.mesh


def _oracle(mesh, fields):
    data = {k: mesh.host_data(k) for k in fields}
    expected, _ = from_amr_oracle(
        data,
        block_bounds=np.asarray(mesh.block_bounds),
        node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level).astype(int),
        ncells=mesh.nCellsVec,
        nblks=mesh.nBlksVec,
        ndim=3,
        fields=fields,
    )
    return expected


@pytest.mark.parametrize("shape", [(8, 12, 16), (12, 10)])
def test_uniform_projection_matches_fava_tpu_and_numpy(shape):
    rng = np.random.default_rng(21)
    f = rng.random(shape)
    w = rng.random(shape)
    deltas = (0.5, 0.25, 0.125)[: len(shape)]
    for axis in range(len(shape)):
        got = torch_proj.project_uniform(torch.as_tensor(f), deltas, axis=axis)
        ref = jax_proj.project_uniform(jnp.asarray(f), deltas, axis=axis)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
        np.testing.assert_allclose(got, f.sum(axis=axis) * deltas[axis], rtol=RTOL)
        got = torch_proj.project_uniform(torch.as_tensor(f), deltas, axis=axis,
                                         weight=torch.as_tensor(w))
        ref = jax_proj.project_uniform(jnp.asarray(f), deltas, axis=axis, weight=jnp.asarray(w))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
        np.testing.assert_allclose(got, (f * w).sum(axis=axis) / w.sum(axis=axis), rtol=RTOL)


def test_uniform_weighted_projection_zero_denominator():
    """A line of zero weight gives 0, fava_tpu's rule (num / 1)."""
    f = np.arange(24.0).reshape(2, 3, 4)
    w = np.ones_like(f)
    w[:, 1, :] = 0.0
    got = torch_proj.project_uniform(torch.as_tensor(f), (1.0, 1.0, 1.0), axis=0,
                                     weight=torch.as_tensor(w))
    ref = jax_proj.project_uniform(jnp.asarray(f), (1.0, 1.0, 1.0), axis=0, weight=jnp.asarray(w))
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[1] == 0.0)


def test_uniform_projection_validation():
    with pytest.raises(ValueError, match="requires a 2D or 3D volume, got 1D"):
        torch_proj.project_uniform(torch.zeros(4), (1.0,))
    with pytest.raises(ValueError, match=r"axis must be in \[0, 3\), got 3"):
        torch_proj.project_uniform(torch.zeros((4, 4, 4)), (1.0, 1.0, 1.0), axis=3)


def test_amr_projection_matches_fava_tpu_and_regrid_then_sum(amr_meshes):
    jmesh, tmesh = amr_meshes
    expected = _oracle(tmesh, ["dens"])["dens"]
    jplan, tplan = _plans(tmesh)
    for axis in range(3):
        got, gc = torch_proj.project_amr(tplan, {"dens": tmesh._field_stack("dens")}, axis=axis)
        ref, rc = jax_proj.project_amr(jplan, {"dens": jmesh._field_stack("dens")}, axis=axis)
        np.testing.assert_allclose(got["dens"], ref["dens"], rtol=RTOL, atol=0)
        dx = float(tplan.grid_delta[axis])
        np.testing.assert_allclose(got["dens"], expected.sum(axis=axis) * dx, rtol=RTOL)
        for a, b in zip(gc, rc):
            np.testing.assert_array_equal(a, b)


def test_amr_weighted_projection(amr_meshes):
    jmesh, tmesh = amr_meshes
    exp = _oracle(tmesh, ["dens", "velx"])
    jplan, tplan = _plans(tmesh)
    got, _ = torch_proj.project_amr(tplan, {"velx": tmesh._field_stack("velx")}, axis=0,
                                    weight=tmesh._field_stack("dens"))
    ref, _ = jax_proj.project_amr(jplan, {"velx": jmesh._field_stack("velx")}, axis=0,
                                  weight=jmesh._field_stack("dens"))
    np.testing.assert_allclose(got["velx"], ref["velx"], rtol=RTOL, atol=0)
    oracle = (exp["velx"] * exp["dens"]).sum(axis=0) / exp["dens"].sum(axis=0)
    np.testing.assert_allclose(got["velx"], oracle, rtol=RTOL)
    # weight == field: density-weighted density, the clumping map
    got = tmesh.projection(field="dens", axis=0, weight="dens")
    ref_sq = (exp["dens"] ** 2).sum(axis=0) / exp["dens"].sum(axis=0)
    np.testing.assert_allclose(got["map"], ref_sq, rtol=RTOL)


def test_projection_conserves_mass(amr_meshes):
    _, tmesh = amr_meshes
    out = tmesh.projection(field="dens", axis=0)
    d1 = out["coord1"][1] - out["coord1"][0]
    d2 = out["coord2"][1] - out["coord2"][0]
    np.testing.assert_allclose(out["map"].sum() * d1 * d2, tmesh.mass_sum()["total"], rtol=1e-9)


def test_amr_projection_validation(amr_meshes):
    _, tmesh = amr_meshes
    _, plan = _plans(tmesh)
    stacks = {"dens": tmesh._field_stack("dens")}
    with pytest.raises(ValueError, match=r"axis must be in \[0, 3\), got 3"):
        torch_proj.project_amr(plan, stacks, axis=3)
    _, cropped = _plans(tmesh, subdomain_coords=np.asarray([[0.1, 0.9]] * 3))
    with pytest.raises(ValueError, match="subdomain"):
        torch_proj.project_amr(cropped, stacks)


def test_mesh_wrappers_and_registration(uniform_file, amr_meshes):
    jmesh, tmesh = amr_meshes
    for kw in ({"field": "dens", "axis": 1}, {"field": "dens", "axis": 1, "weight": "velx"},
               {"field": "velz", "axis": 2}):
        got, ref = tmesh.projection(**kw), jmesh.projection(**kw)
        assert sorted(got) == sorted(ref) == ["coord1", "coord2", "map"]
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=0, err_msg=key)

    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    assert callable(fava_tpu_torch.Model.projection)
    for kw in ({"field": "dens"}, {"field": "dens", "axis": 2},
               {"field": "velx", "axis": 1, "weight": "dens"}):
        got, ref = tm.projection(**kw), jm.projection(**kw)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=0, err_msg=key)
    dens = tm.mesh.data("dens").numpy()
    dx = tm.mesh._domain_lengths()[2] / dens.shape[2]
    np.testing.assert_allclose(tm.projection(field="dens", axis=2)["map"],
                               dens.sum(axis=2) * dx, rtol=RTOL)
