"""The fava_tpu_torch AMR path held to fava_tpu on the CPU, in float64.

Both packages read the same synthetic FLASH files (ncells (8, 16, 16),
nblks (2, 2, 2), refine {0: 2, 5: 3}: levels 1-3, leaf scales 1-4).
Those blocks meet fava_tpu's Pallas gates (``_rows_ok``,
``regrid_tiles_supported``), so fava_tpu runs its block-moment and
regrid kernels in interpret mode, as its own tests do; the port runs the
plain twins of K5-K7 (CPU tensors). The numpy oracles of tests/oracles/
are the second reference.

Tolerances:
* profiles (Reynolds stress, means, Favre mean/RMS, slice profiles):
  rtol 1e-10 with atol 1e-12 of the output's scale (its largest
  magnitude), as tests/test_torch_flagship.py: float64 on both sides,
  summed in different orders;
* regrid and file contents: exact (values are copied, not computed).
"""

import logging

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.io import synthetic as jsynthetic
from fava_tpu.mesh import FlashUniform as JFlashUniform
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu_torch.io import synthetic as tsynthetic
from fava_tpu_torch.ops import cuda_kernels as ck
from tests.oracles.profiles import reynolds_stress_oracle, slice_integral_oracle
from tests.oracles.regrid import from_amr_oracle

NCELLS = (8, 16, 16)
NBLKS = (2, 2, 2)
REFINE = {0: 2, 5: 3}
NAMES = ("dens", "velx", "vely", "velz")


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


@pytest.fixture(scope="module")
def amr_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_amr")
    tsynthetic.make_amr_file(d / "rt_hdf5_plt_cnt_0001", ncells=NCELLS, nblks=NBLKS, refine=REFINE)
    tsynthetic.make_amr_file(d / "rt_hdf5_chk_0001", ncells=NCELLS, nblks=NBLKS, refine=REFINE)
    return d


def _models(directory, file_type="plt"):
    jm = fava_tpu.FLASH(directory)
    jm.load(file_type=file_type)
    tm = fava_tpu_torch.FLASH(directory, device="cpu")
    tm.load(file_type=file_type)
    return jm, tm


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * scale, err_msg=what)


def _close_tree(got, ref, what=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            _close_tree(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, tuple):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _close_tree(g, r, f"{what}[{i}]")
    else:
        _close(got, ref, what)


def _oracle_kwargs(mesh):
    return dict(
        block_bounds=np.asarray(mesh.block_bounds),
        refine_level=np.asarray(mesh.refine_level).astype(int),
        node_type=np.asarray(mesh.node_type),
        ncells=mesh.nCellsVec,
        nblks=mesh.nBlksVec,
    )


# ---------------------------------------------------------------------------
# Synthetic files


@pytest.mark.parametrize("stem", ["rt_hdf5_plt_cnt_0001", "rt_hdf5_chk_0001"])
def test_make_amr_file_writes_what_fava_tpu_writes(tmp_path, stem):
    refine_fn = lambda b, lev: 3 if b[0, 0] < 0.25 else 1  # noqa: E731
    for gen, sub in ((jsynthetic, "j"), (tsynthetic, "t")):
        (tmp_path / sub).mkdir()
        gen.make_amr_file(
            tmp_path / sub / stem, ncells=NCELLS, nblks=NBLKS, refine=REFINE, refine_fn=refine_fn,
            time=0.25,
        )
    with h5py.File(tmp_path / "j" / stem) as a, h5py.File(tmp_path / "t" / stem) as b:
        assert sorted(a) == sorted(b)
        for key in a:
            x, y = a[key][()], b[key][()]
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert np.array_equal(x, y), key
        assert a["dens"].dtype == (np.float64 if "chk" in stem else np.float32)


def test_make_uniform_file_writes_what_fava_tpu_writes(tmp_path):
    for gen, sub in ((jsynthetic, "j"), (tsynthetic, "t")):
        (tmp_path / sub).mkdir()
        gen.make_uniform_file(tmp_path / sub / "u_hdf5_uniform_0001", ncells=(8, 12, 16), seed=3)
    with h5py.File(tmp_path / "j/u_hdf5_uniform_0001") as a, h5py.File(
        tmp_path / "t/u_hdf5_uniform_0001"
    ) as b:
        assert sorted(a) == sorted(b)
        for key in a:
            assert np.array_equal(a[key][()], b[key][()]), key


# ---------------------------------------------------------------------------
# Loading


@pytest.mark.parametrize("file_type", ["plt", "chk"])
def test_amr_load_matches_fava_tpu(amr_dir, file_type):
    jm, tm = _models(amr_dir, file_type)
    j, t = jm.mesh, tm.mesh
    assert type(t).__name__ == "FLASH" and t._chk_file == (file_type == "chk")
    for attr in ("nxb", "nyb", "nzb", "ndim", "nblocks", "nblockx", "time", "fields", "_chk_file",
                 "refine_level_max", "domain_volume", "cell_volume_min", "cell_volume_max"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("coordinates", "block_size", "block_bounds", "node_type", "refine_level", "gid",
                 "which_child", "processors", "bflags", "domain_bounds"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr), err_msg=attr)
    assert t.scalars == j.scalars and t.runtime_parameters == j.runtime_parameters
    np.testing.assert_array_equal(t.get_blocklist("LEAF"), j.get_blocklist("LEAF"))
    np.testing.assert_array_equal(t.get_cell_volumes(), j.get_cell_volumes())
    for name in (*NAMES, "flam"):
        got = t.data(name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(j.data(name)), err_msg=name)
    assert t.data("density") is t.data("dens")


def test_block_and_point_queries_match_fava_tpu(amr_dir):
    jm, tm = _models(amr_dir)
    j, t = jm.mesh, tm.mesh
    for a in range(3):
        assert t.get_minimum_deltas(a) == j.get_minimum_deltas(a)
        assert t.get_maximum_deltas(a) == j.get_maximum_deltas(a)
        assert t.get_block_deltas(9) == j.get_block_deltas(9)
        for edge in ("LEFT", "CENTER", "RIGHT"):
            np.testing.assert_array_equal(
                t.get_cell_coords(a, 9, edge, guardcell=True), j.get_cell_coords(a, 9, edge, True)
            )
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.random((64, 3)), [[1.0, 1.0, 1.0], [0.0, 0.5, 0.25]]])
    for g, r in zip(t.locate_points(pts), j.locate_points(pts)):
        np.testing.assert_array_equal(g, r)
    assert t.get_coord_index(pts[3], None) == j.get_coord_index(pts[3], None)
    with pytest.raises(ValueError, match="not inside"):
        t.get_coord_index(np.array([2.0, 0.5, 0.5]), None)
    got, gfrac, gfound = t.sample_fields(pts, ["dens", "velz"])
    ref, rfrac, rfound = j.sample_fields(pts, ["dens", "velz"])
    np.testing.assert_array_equal(gfrac, rfrac)
    np.testing.assert_array_equal(gfound, rfound)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# Profiles


@pytest.mark.parametrize("raxis", [0, 1])
def test_profiles_match_fava_tpu(amr_dir, force_interpret, raxis):
    jm, tm = _models(amr_dir)
    ck.reset_launch_counts()
    _close_tree(tm.reynolds_stress(raxis=raxis), jm.reynolds_stress(raxis=raxis), "reynolds")
    _close_tree(tm.favre_profiles(raxis=raxis), jm.favre_profiles(raxis=raxis), "favre")
    assert ck.launch_counts() == dict.fromkeys(ck.KERNELS, 0)


@pytest.mark.parametrize("raxis", [0, 1])
def test_reynolds_stress_matches_the_oracle(amr_dir, raxis):
    _jm, tm = _models(amr_dir)
    m = tm.mesh
    data = {k: m.host_data(k) for k in NAMES}
    span_r, stress_r, means_r = reynolds_stress_oracle(
        data, domain_bounds=m.domain_bounds, raxis=raxis, **_oracle_kwargs(m)
    )
    span, stress, means = m.reynolds_stress(raxis=raxis)
    np.testing.assert_array_equal(span, span_r)
    _close_tree(stress, stress_r, "stress")
    _close_tree(means, means_r, "means")


@pytest.mark.parametrize("raxis", [0, 1, 2])
def test_slice_profiles_match_fava_tpu_and_the_oracle(amr_dir, raxis):
    jm, tm = _models(amr_dir)
    for field in ("flam", "velx"):
        got = tm.slice_integration(field, axis=raxis)
        _close_tree(got, jm.slice_integration(field, axis=raxis), f"integral {field}")
        _close_tree(tm.slice_average(field, axis=raxis), jm.slice_average(field, axis=raxis), field)
        m = tm.mesh
        span_r, alp_r = slice_integral_oracle(
            m.host_data(field), domain_bounds=m.domain_bounds, raxis=raxis, **_oracle_kwargs(m)
        )
        _close_tree(got, (span_r, alp_r), f"oracle {field}")


def test_uniform_mesh_profiles_run_k1_k2_twins(tmp_path, monkeypatch):
    """FlashUniform inherits the AMR profiles; one block along x takes the
    uniform fast case through K1/K2 (their twins on the CPU)."""
    jsynthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(16, 12, 8), seed=5)
    jm, tm = _models(tmp_path, "uni")
    calls = []
    for name in ("row_moments_volume", "centered_row_moments", "block_row_moments"):
        real = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    _close_tree(tm.reynolds_stress(), jm.reynolds_stress(), "reynolds")
    _close_tree(tm.favre_profiles(), jm.favre_profiles(), "favre")
    assert calls == ["row_moments_volume", "centered_row_moments"] * 2
    _close_tree(tm.reynolds_stress(raxis=2), jm.reynolds_stress(raxis=2), "reynolds z")


# ---------------------------------------------------------------------------
# Regrid

SUBDOMAINS = {
    "full": dict(),
    "subdomain": dict(subdomain_coords=np.array([[0.25, 0.75], [0.25, 0.75], [0.25, 0.75]])),
    "zero_touching_rows": dict(subdomain_coords=np.array([[0.25, 0.75], [0.0, 1.0], [0.0, 1.0]])),
    "all_zero_sentinel": dict(subdomain_coords=np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]])),
    "refine_level_2": dict(refine_level=2),
}


@pytest.mark.parametrize("case", sorted(SUBDOMAINS))
def test_from_amr_matches_fava_tpu_and_the_oracle(amr_dir, force_interpret, case):
    kwargs = SUBDOMAINS[case]
    jm, tm = _models(amr_dir)
    data = {k: tm.mesh.host_data(k) for k in ("dens", "velx")}
    oracle_kw = {"refine_to": kwargs.get("refine_level", -1)}
    sub = kwargs.get("subdomain_coords")
    if sub is not None and case != "all_zero_sentinel":
        oracle_kw["subdomain_coords"] = sub
    expected, total = from_amr_oracle(
        data, fields=["dens", "velx"], **oracle_kw, **_oracle_kwargs(tm.mesh)
    )
    for m in (jm.mesh, tm.mesh):
        m.from_amr(fields=["dens", "velx"], save_file=False, **kwargs)
    t, j = tm.mesh, jm.mesh
    assert tuple(t.nCellsVec) == tuple(j.nCellsVec) == tuple(total)
    if case == "zero_touching_rows":
        assert t.nCellsVec[0] < t.nCellsVec[1]
    for attr in ("nblocks", "nblockx", "xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.scalars == j.scalars and t.runtime_parameters == j.runtime_parameters
    for attr in ("block_bounds", "block_size", "coordinates", "gid", "refine_level", "node_type"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr), err_msg=attr)
    for k in ("dens", "velx"):
        got = t._data[k].numpy()
        np.testing.assert_array_equal(got, np.asarray(j._data[k]), err_msg=k)
        np.testing.assert_array_equal(got, expected[k], err_msg=k)


def test_from_amr_outside_the_domain_is_a_noop(amr_dir, caplog):
    _jm, tm = _models(amr_dir)
    before = tm.mesh.nblocks
    sub = np.array([[-0.5, 0.5], [0.25, 0.75], [0.25, 0.75]])
    with caplog.at_level(logging.WARNING):
        tm.mesh.from_amr(subdomain_coords=sub, fields=["dens"], save_file=False)
    assert tm.mesh.nblocks == before and "nothing regridded" in caplog.text


def test_from_amr_file_loads_in_fava_tpu(amr_dir, tmp_path):
    _jm, tm = _models(amr_dir)
    sub = np.array([[0.25, 0.75], [0.0, 1.0], [0.0, 1.0]])
    tm.mesh.from_amr(subdomain_coords=sub, fields=["dens", "velx"])
    out = amr_dir / "rt_hdf5_uniform_0001"
    assert out.is_file()
    uni = JFlashUniform(out)
    uni.load()
    try:
        assert tuple(uni.nCellsVec) == tuple(tm.mesh.nCellsVec) and uni.nblocks == 1
        assert uni.fields == ["dens", "velx"]
        np.testing.assert_array_equal(uni.domain_bounds, tm.mesh.domain_bounds.astype(np.float32))
        for k in ("dens", "velx"):
            # A plt-derived file is float32 on disk.
            np.testing.assert_array_equal(
                np.asarray(uni.data(k)), tm.mesh._data[k].numpy().astype(np.float32)
            )
    finally:
        out.unlink()


def test_filename_setter_tracks_the_chk_marker(amr_dir, tmp_path):
    """Repaired fault: the setter set no ``_chk_file`` and did not return
    early for an unchanged name, so a chk mesh saved float32 data."""
    _jm, tm = _models(amr_dir, "chk")
    chk = tm.mesh
    assert chk._chk_file
    chk.data("dens")
    chk.filename = chk.filename  # unchanged: nothing reset
    assert chk._chk_file
    chk.save(tmp_path / "a_hdf5_chk_0002", names=["dens"])
    _jm, tm = _models(amr_dir, "plt")
    plt = tm.mesh
    assert not plt._chk_file
    plt.data("dens")
    plt.save(tmp_path / "a_hdf5_plt_cnt_0002", names=["dens"])
    with h5py.File(tmp_path / "a_hdf5_chk_0002") as c, h5py.File(tmp_path / "a_hdf5_plt_cnt_0002") as p:
        assert c["dens"].dtype == np.float64 and c["bounding box"].dtype == np.float64
        assert p["dens"].dtype == np.float32 and p["bounding box"].dtype == np.float32
    chk.filename = amr_dir / "rt_hdf5_plt_cnt_0001"
    assert not chk._chk_file
    chk.filename = amr_dir / "checkerboard_hdf5_plt_cnt_0001"
    assert not chk._chk_file


@pytest.mark.parametrize(
    "name", ["run_hdf5_plt_cnt_0001", "run_hdf5_chk_0001", "run_hdf5_uniform_0001", "run_hdf5_part_0001"]
)
def test_file_sniffing_matches_fava_tpu(name):
    """Repaired fault: FlashUniform inherited FLASH's AMR sniff, so it
    claimed plt/chk files and refused uniform ones (tests/test_mesh.py)."""
    from fava_tpu.mesh import FLASH as JFLASH
    from fava_tpu_torch.mesh import FLASH, FlashUniform

    assert FLASH.is_this_your_mesh(name) == JFLASH.is_this_your_mesh(name)
    assert FlashUniform.is_this_your_mesh(name) == JFlashUniform.is_this_your_mesh(name)
    assert FlashUniform.is_this_your_mesh(name) == ("uniform" in name)


def test_convert_filename_type_matches_fava_tpu(amr_dir):
    jm, tm = _models(amr_dir)
    for new in ("uni", "chk", "anl", "PLT_PRT"):
        assert tm.convert_filename_type("plt", new) == jm.convert_filename_type("plt", new)
    assert fava_tpu_torch.FLASH(amr_dir, device="cpu").convert_filename_type("plt", "uni") is None


def test_write_unknown_names_refuses_long_names(tmp_path):
    from fava_tpu_torch.io import flash_file

    with h5py.File(tmp_path / "f.h5", "w") as f:
        with pytest.raises(ValueError, match="4 characters"):
            flash_file.write_unknown_names(f, ["dens", "myfield"])


# ---------------------------------------------------------------------------
# The slice end to end


def test_amr_slice_end_to_end_matches_fava_tpu(tmp_path, force_interpret):
    """plt -> profiles -> from_amr window -> uni -> flagship_analysis,
    the same sequence in both packages, each in its own directory."""
    window = np.array([[0.25, 0.75], [0.0, 1.0], [0.0, 1.0]])
    outs = []
    for pkg in (fava_tpu, fava_tpu_torch):
        d = tmp_path / pkg.__name__
        d.mkdir()
        tsynthetic.make_amr_file(d / "rt_hdf5_plt_cnt_0001", ncells=NCELLS, nblks=NBLKS, refine=REFINE)
        kw = {} if pkg is fava_tpu else {"device": "cpu"}
        m = pkg.FLASH(d, **kw)
        m.load(file_type="plt")
        r = m.reynolds_stress()
        fav = m.favre_profiles()
        m.mesh.from_amr(
            subdomain_coords=window, fields=list(NAMES), filename=d / "rt_hdf5_uniform_0001"
        )
        m = pkg.FLASH(d, **kw)
        m.load(file_type="uni")
        flag = m.flagship_analysis()
        outs.append((r, fav, flag))
    (jr, jfav, jflag), (tr, tfav, tflag) = outs
    _close_tree(tr, jr, "reynolds")
    _close_tree(tfav, jfav, "favre")
    assert tflag["reynolds_stress"].shape == (6, 32)
    for key, ref in jflag.items():
        ref = np.asarray(ref)
        if key == "spectra_counts":
            np.testing.assert_array_equal(tflag[key], ref)
        else:
            _close(tflag[key], ref, key)
