"""fava_tpu_torch's particle table held to fava_tpu on the CPU, in float64.

The port's part-file reader and writer (h5lite), ``make_particle_file``,
``FlashParticles`` and the FLASH model's ``prt``, ``chk_prt`` and
``plt_prt`` load types run on the same files as fava_tpu's (h5py); the
tables are compared exactly and ``statistics()`` at rtol 1e-12 (float64
means and RMS summed in another order; min and max exact). Mirrors the
particle tests of tests/test_mesh.py, test_io.py, test_model.py,
test_edge_cases.py and test_ingest.py.
"""

import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.io import flash_file as jff
from fava_tpu.io import synthetic as jsyn
from fava_tpu.mesh import FlashParticles as JParticles
from fava_tpu_torch import FileType, FlashParticles
from fava_tpu_torch.io import flash_file, h5lite, synthetic
from fava_tpu_torch.mesh import flash_particles

RTOL = 1e-12


@pytest.fixture()
def part_file(tmp_path):
    return synthetic.make_particle_file(tmp_path / "rt_hdf5_part_0001", nparticles=128, seed=3)


@pytest.fixture()
def model_dir(tmp_path):
    synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0001", ncells=(4, 4, 4), nblks=(1, 1, 1))
    synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0003", ncells=(4, 4, 4), nblks=(1, 1, 1))
    synthetic.make_amr_file(tmp_path / "rt_hdf5_chk_0002", ncells=(4, 4, 4), nblks=(1, 1, 1))
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(8, 8, 8))
    synthetic.make_particle_file(tmp_path / "rt_hdf5_part_0001", nparticles=16)
    return tmp_path


def _loaded(path, **kw):
    p, j = FlashParticles(path, device="cpu"), JParticles(path)
    p._load_particles(**kw)
    j._load_particles(**kw)
    return p, j


# ---------------------------------------------------------------------------
# Files


@pytest.mark.parametrize("nparticles,seed", [(1, 0), (32, 1), (257, 9)])
def test_make_particle_file_writes_fava_tpus_file(tmp_path, nparticles, seed):
    ours = synthetic.make_particle_file(tmp_path / "a_hdf5_part_0001", nparticles=nparticles, seed=seed,
                                        time=0.25)
    ref = jsyn.make_particle_file(tmp_path / "b_hdf5_part_0001", nparticles=nparticles, seed=seed,
                                  time=0.25)
    with h5py.File(ours, "r") as a, h5py.File(ref, "r") as b:
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key][()], b[key][()], err_msg=key)


@pytest.mark.parametrize("names", [("tag",), ("tag", "posx", "velx"), ("dens", "tag", "posx", "posy",
                                                                      "posz", "velx", "vely", "velz")])
def test_particle_table_both_ways_through_h5lite(tmp_path, names):
    """A part file written by h5py (fava_tpu) reads exactly through
    h5lite, and one written by h5lite reads exactly through h5py: the
    (N, ncolumns) float64 table, the (ncolumns, 1) S24 names, localnp and
    the scalar tables."""
    rng = np.random.default_rng(len(names))
    cols = {n: rng.standard_normal(40) for n in names}
    kw = dict(int_scalars={"dimensionality": 3, "globalnumparticles": 40},
              real_scalars={"time": 0.5, "dt": 1e-3, "dtold": 1e-3}, particles=cols)
    jff.write_particle_file(tmp_path / "j_hdf5_part_0001", **kw)
    flash_file.write_particle_file(tmp_path / "t_hdf5_part_0001", **kw)
    table = np.stack([cols[n] for n in names], axis=-1)
    with h5lite.File(tmp_path / "j_hdf5_part_0001", "r") as f:
        meta = flash_file.read_particle_metadata(f)
        got = flash_file.read_particles(f, meta["particle names"])
        assert f["particle names"][()].dtype == np.dtype("S24")
        assert f["particle names"][()].shape == (len(names), 1)
        np.testing.assert_array_equal(f["tracer particles"][()], table)
    assert meta["particle names"] == list(names)
    np.testing.assert_array_equal(meta["localnp"], [40])
    assert meta["integer scalars"]["globalnumparticles"] == 40
    assert meta["real scalars"]["time"] == 0.5
    for n in names:
        np.testing.assert_array_equal(got[n], cols[n])
    with h5py.File(tmp_path / "t_hdf5_part_0001", "r") as f:
        ref = jff.read_particle_metadata(f)
        assert ref["particle names"] == list(names)
        np.testing.assert_array_equal(f["tracer particles"][()], table)
        assert f["tracer particles"].dtype == np.float64
        assert f["particle names"].dtype == np.dtype("S24")
        np.testing.assert_array_equal(f["localnp"][()], [40])
        assert ref["integer scalars"] == meta["integer scalars"]
        assert ref["real scalars"] == meta["real scalars"]


def test_particle_file_roundtrip(tmp_path):
    path = tmp_path / "rt_hdf5_part_0002"
    synthetic.make_particle_file(path, nparticles=32)
    with h5lite.File(path, "r") as f:
        meta = flash_file.read_particle_metadata(f)
        parts = flash_file.read_particles(f, meta["particle names"], select=["tag", "velx"])
    assert meta["integer scalars"]["globalnumparticles"] == 32
    assert set(parts.keys()) == {"tag", "velx"}
    assert parts["tag"].shape == (32,)


# ---------------------------------------------------------------------------
# The particle mesh


def test_file_sniffing():
    assert FlashParticles.is_this_your_mesh("run_hdf5_part_0001")
    assert FlashParticles.is_this_your_mesh("run_hdf5_chk_0001")
    assert not FlashParticles.is_this_your_mesh("run_hdf5_uniform_0001")
    with pytest.raises(ValueError, match="hdf5_part_"):
        FlashParticles("run_hdf5_uniform_0001", device="cpu")


def test_particles_load(part_file):
    p, j = _loaded(part_file)
    assert p.nParticles == j.nParticles == 128
    assert (p.ndim, p.time, p.dt, p.dtold) == (j.ndim, j.time, j.dt, j.dtold)
    assert p.fields == j.fields
    tags = p.data["tag"]
    assert np.all(np.diff(tags) > 0)  # sorted by tag
    assert sorted(p.data) == sorted(j.data)
    for name in j.data:
        np.testing.assert_array_equal(p.data[name], j.data[name], err_msg=name)
    coords = p.get_coords()
    assert coords.shape == (128, 3)
    np.testing.assert_array_equal(coords, j.get_coords())
    stats = p.statistics(["velx"])
    assert set(stats["velx"].keys()) == {"mean", "rms", "min", "max"}
    sel = p.select_by_tags(tags[[3, 7]])
    np.testing.assert_allclose(sel["tag"], tags[[3, 7]])
    ref = j.select_by_tags(tags[[3, 7]])
    for name in ref:
        np.testing.assert_array_equal(sel[name], ref[name])


@pytest.mark.parametrize("fields", [None, ["velx"], ["velx", "dens", "posz"], ["bogus", "vely"], ["bogus"]])
def test_statistics_match_fava_tpu(part_file, fields):
    p, j = _loaded(part_file)
    got, ref = p.statistics(fields), j.statistics(fields)
    assert sorted(got) == sorted(ref)
    for f in ref:
        for key in ("mean", "rms"):
            np.testing.assert_allclose(got[f][key], ref[f][key], rtol=RTOL, err_msg=f"{f} {key}")
        assert got[f]["min"] == ref[f]["min"] and got[f]["max"] == ref[f]["max"]
        col = p.data[f]
        np.testing.assert_allclose(got[f]["mean"], col.mean(), rtol=RTOL)
        np.testing.assert_allclose(got[f]["rms"], col.std(), rtol=RTOL)


def test_device_column_is_float64_on_the_mesh_device(part_file):
    p, _ = _loaded(part_file)
    col = p.device_column("velx")
    assert col.dtype == torch.float64 and col.device.type == "cpu"
    np.testing.assert_array_equal(col.numpy(), p.data["velx"])


def test_select_by_tags_missing_tag_errors(part_file):
    p, _ = _loaded(part_file)
    bogus = np.array([int(p.data["tag"].max()) + 7])
    with pytest.raises(ValueError, match="not found"):
        p.select_by_tags(bogus)


def test_rows_for_tags_matches_fava_tpu_and_refuses_duplicates():
    from fava_tpu.mesh.flash_particles import rows_for_tags as jrows

    rng = np.random.default_rng(4)
    tags = rng.permutation(50).astype(np.float64) + 1.0
    want = rng.choice(tags, size=20, replace=False)
    np.testing.assert_array_equal(flash_particles.rows_for_tags(tags, want), jrows(tags, want))
    dup = tags.copy()
    dup[3] = dup[4]
    with pytest.raises(ValueError, match="duplicate"):
        flash_particles.rows_for_tags(dup, want[:2])
    with pytest.raises(ValueError, match="not found"):
        flash_particles.rows_for_tags(np.zeros(0), want[:1])


@pytest.mark.parametrize("fields", [["density", "velocity-x", "tag"], ["id", "posx"], ["velx", "nope"]])
def test_particle_long_field_names(part_file, fields):
    p, j = _loaded(part_file, fields=fields)
    assert sorted(p.data) == sorted(j.data)
    if "density" in fields:
        assert "dens" in p.data and "velx" in p.data
    for name in j.data:
        np.testing.assert_array_equal(p.data[name], j.data[name])


def test_unordered_load_keeps_the_file_order(part_file):
    p, j = _loaded(part_file, ordered=False)
    with h5lite.File(part_file, "r") as f:
        np.testing.assert_array_equal(p.data["tag"], f["tracer particles"][()][:, 0])
    np.testing.assert_array_equal(p.data["tag"], j.data["tag"])


def test_particles_filename_setter_retries_after_failure(tmp_path, part_file):
    bad = tmp_path / "x_hdf5_part_0009"
    bad.write_bytes(b"not an hdf5 file")
    p = FlashParticles(part_file, device="cpu")
    with pytest.raises(Exception):
        p.filename = bad
    assert p.filename == Path(part_file)

    shutil.copyfile(part_file, bad)
    p.filename = bad
    assert p.filename == bad
    p.load()
    assert p.data["tag"].shape == (128,)


def test_structure_functions_through_the_mesh_match_fava_tpu(part_file):
    p, j = _loaded(part_file)
    kw = dict(num_pairs=2048, nbins=6, orders=3, seed=5)
    got, ref = p.structure_functions(**kw), j.structure_functions(**kw)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["separations"], ref["separations"], rtol=RTOL)
    for o in ("1", "2", "3"):
        np.testing.assert_allclose(got["longitudinal"][o], ref["longitudinal"][o], rtol=RTOL)


# ---------------------------------------------------------------------------
# The model


def test_registries_hold_the_particle_mesh():
    names = fava_tpu_torch.Model.mesh_names()
    for expected in ("FLASH", "FlashUniform", "FlashParticles", "Structured", "Unstructured"):
        assert expected in names
    assert fava_tpu_torch.Model.get_mesh_class("FlashParticles") is FlashParticles
    from fava_tpu_torch.mesh import FlashParticles as exported

    assert exported is FlashParticles


def test_catalogs_and_nfiles(model_dir):
    m = fava_tpu_torch.FLASH(model_dir, device="cpu")
    assert m.nfiles(file_type="plt") == 2
    assert m.nfiles(file_type="chk") == 1
    assert m.nfiles(file_type="uni") == 1
    assert m.nfiles(file_type="prt") == 1
    assert m.nfiles(file_type=FileType.ANL) == 0


def test_load_dispatch(model_dir):
    m = fava_tpu_torch.FLASH(model_dir, device="cpu")
    assert m.particles is None
    m.load(file_type="plt")
    assert m.mesh is not None and m.particles is None
    assert m.mesh.mesh_type == "FLASH"

    m.load(file_type="uni")
    assert m.mesh.mesh_type == "FlashUniform"

    m.load(file_type="prt")
    assert m.particles is not None and m.mesh is None
    assert m.particles.device.type == "cpu"
    assert m.particles.data["tag"].shape == (16,)

    m.load(file_number=3, file_type="plt")
    assert "0003" in m.mesh.filename.name and m.particles is None

    m.load(file_type="plt_prt")
    assert m.mesh is not None and m.particles is not None
    assert "plt_cnt_0001" in m.mesh.filename.name and "part_0001" in m.particles.filename.name

    with pytest.raises(ValueError, match="not found"):
        m.load(file_index=5, file_type="prt")
    assert m.mesh is None and m.particles is None
    with pytest.raises(ValueError, match="Cannot load"):
        m.load(file_type="anl")


def test_load_prt_fields_and_kwargs_match_fava_tpu(model_dir):
    t = fava_tpu_torch.FLASH(model_dir, device="cpu")
    j = fava_tpu.FLASH(model_dir)
    for kw in ({"fields": ["velx", "tag"]}, {"fields": ["velx"], "ordered": False}, {}):
        t.load(file_type="prt", **kw)
        j.load(file_type="prt", **kw)
        assert sorted(t.particles.data) == sorted(j.particles.data)
        for name in j.particles.data:
            np.testing.assert_array_equal(t.particles.data[name], j.particles.data[name])


def test_generic_model_load_sniffing(model_dir):
    m = fava_tpu_torch.Model(model_dir, device="cpu")
    m.load(0)  # the sorted listing starts with the chk file
    assert m.mesh.mesh_type in ("FLASH", "FlashParticles")
    part = m.files.index(model_dir / "rt_hdf5_part_0001")
    m.load(part)
    assert m.mesh.mesh_type == "FlashParticles"
    assert m.mesh.data["tag"].shape == (16,)


def test_convert_filename_type_of_combined_types(tmp_path):
    synthetic.make_uniform_file(tmp_path / "chkboard_hdf5_uniform_0040", ncells=(8, 8, 8))
    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    m.load(file_type="uni")
    assert m.convert_filename_type("uni", "chk_prt").name == "chkboard_hdf5_chk_0040"
    assert m.convert_filename_type("uni", "plt_prt").name == "chkboard_hdf5_plt_cnt_0040"


def test_chk_prt_combined_load(tmp_path):
    """A chk file that also carries particles (appended with h5lite's
    append mode): both the mesh and the particles load, as fava_tpu's."""
    chk = synthetic.make_amr_file(tmp_path / "rt_hdf5_chk_0001", ncells=(4, 4, 4), nblks=(1, 1, 1))
    prt = synthetic.make_particle_file(tmp_path / "tmp_hdf5_part_0001", nparticles=8)
    with h5lite.File(prt, "r") as src, h5lite.File(chk, "a") as dst:
        for key in ("localnp", "particle names", "tracer particles"):
            dst.create_dataset(key, data=src[key][()])
    (tmp_path / "tmp_hdf5_part_0001").unlink()

    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    m.load(file_type="chk_prt")
    assert m.mesh is not None and m.particles is not None
    assert m.particles.data["tag"].shape == (8,)
    j = fava_tpu.FLASH(tmp_path)
    j.load(file_type="chk_prt")
    for name in j.particles.data:
        np.testing.assert_array_equal(m.particles.data[name], j.particles.data[name])
    np.testing.assert_array_equal(m.mesh.data("dens").numpy(), np.asarray(j.mesh.data("dens")))
    assert m.particles.time == j.particles.time


def test_particle_series(tmp_path):
    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_particle_file(tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=32, time=t,
                                     seed=200 + i)
    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    out = m.particle_series(fields=["velx", "dens"])
    np.testing.assert_allclose(out["times"], [0.0, 0.1, 0.2])
    assert out["velx_mean"].shape == (3,)
    assert (out["velx_rms"] > 0).all()
    assert (out["dens_max"] >= out["dens_min"]).all()
    ref = fava_tpu.FLASH(tmp_path).particle_series(fields=["velx", "dens"])
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(out[key], ref[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("fields,file_indices", [(None, None), (["vely"], [2, 0])])
def test_particle_series_matches_fava_tpu(tmp_path, fields, file_indices):
    for i, t in enumerate([0.0, 0.5, 1.0], start=1):
        synthetic.make_particle_file(tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=100, time=t,
                                     seed=7 * i)
    got = fava_tpu_torch.FLASH(tmp_path, device="cpu").particle_series(fields, file_indices)
    ref = fava_tpu.FLASH(tmp_path).particle_series(fields, file_indices)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=key)


def test_cuda_default_raises_without_cuda(monkeypatch, part_file):
    """No silent CPU: the particle table asks for CUDA by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlashParticles(part_file)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fava_tpu_torch.FLASH(part_file.parent)
    from fava_tpu_torch.ops.structure import pair_structure_functions

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pair_structure_functions(np.ones((4, 3)), np.ones((4, 3)))
