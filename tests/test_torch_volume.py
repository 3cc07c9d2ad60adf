"""fava_tpu_torch's PDFs, conditional statistics, mass and volume sums and
the analysis-file writer, held to fava_tpu and to numpy/scipy on the CPU.

Inputs are made from a seed with numpy, or are the synthetic FLASH files
of tests/conftest.py, read by both packages. fava_tpu runs its
pdf2d Pallas kernel in interpret mode (pk.FORCE_INTERPRET) for <= 128
bins per axis and its XLA one-hot path above; the port runs the plain
twin of its pdf2d kernel (CPU tensors). The file data are float32 values,
so fava_tpu's float32 rounding of the pdf2d edges moves no sample here.

Tolerances:
* counts: exact, against np.histogram/np.histogram2d and fava_tpu;
* weighted sums: rtol 1e-12 against numpy (float64 sums in another
  order); against fava_tpu rtol 1e-10, its double-word sums being
  float64-class, except its pdf2d kernel (rtol 2e-6: it sums each
  65,536-sample step in float32 on the MXU);
* density_pdf moments rtol 1e-12, atol 1e-12 (skewness and kurtosis are
  O(1) and may be near 0);
* binned_statistic mean/std rtol 1e-10, atol 1e-12 of scale; NaN in the
  same (empty) bins;
* mass and volume sums rtol 1e-12;
* files: exact.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu.ops import volume as jvol
from fava_tpu_torch.ops import volume as tvol

WEIGHTS = [None, "volume", "mass"]
KINDS = ["uni", "plt"]


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


@pytest.fixture()
def models(request, uniform_file, amr_file):
    path = uniform_file if request.param == "uni" else amr_file
    jm = fava_tpu.FLASH(path.parent)
    jm.load(file_type=request.param)
    tm = fava_tpu_torch.FLASH(path.parent, device="cpu")
    tm.load(file_type=request.param)
    return jm, tm


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, what, rtol=1e-10):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    finite = ~np.isnan(ref)
    scale = float(np.abs(ref[finite]).max()) if finite.any() else 0.0
    np.testing.assert_allclose(got[finite], ref[finite], rtol=rtol, atol=1e-12 * scale, err_msg=what)


def _samples(n, seed):
    """x, y with out-of-range samples, NaN and samples on the range ends."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.6, n).astype(np.float32).astype(np.float64)
    y = rng.normal(-0.2, 1.1, n).astype(np.float32).astype(np.float64)
    x[:5] = [np.nan, -7.0, 9.0, -1.5, 2.5]  # NaN, out of range, both range ends
    y[5:10] = [np.nan, -9.0, 9.0, -3.0, 3.0]
    x[10], y[10] = 2.5, 3.0  # the last bin's closed corner
    return x, y


XR, YR = (-1.5, 2.5), (-3.0, 3.0)


# ---------------------------------------------------------------------------
# pdf2d (kernel B8) and pdf1d


@pytest.mark.parametrize("nbins", [(10, 7), (100, 100), (150, 130)])
def test_pdf2d_counts_equal_numpy_and_fava_tpu(force_interpret, nbins):
    """<= 128 bins: fava_tpu's Pallas kernel (interpret); 150 x 130: its
    XLA path. Out-of-range, NaN and last-edge samples included."""
    x, y = _samples(20011, seed=nbins[0])
    got = tvol.pdf2d(_t(x), _t(y), nbins=nbins, xrange=XR, yrange=YR, density=False)
    ref, xe, ye = np.histogram2d(x, y, bins=nbins, range=(XR, YR))
    np.testing.assert_array_equal(got["counts"], ref)
    np.testing.assert_array_equal(got["xedges"], xe)
    np.testing.assert_array_equal(got["yedges"], ye)
    jref = jvol.pdf2d(jnp.asarray(x), jnp.asarray(y), nbins=nbins, xrange=XR, yrange=YR,
                      density=False)
    np.testing.assert_array_equal(got["counts"], jref["counts"])


@pytest.mark.parametrize("nbins", [(12, 9), (100, 100)])
def test_pdf2d_weighted_matches_numpy(nbins):
    x, y = _samples(20011, seed=7)
    w = np.random.default_rng(8).random(x.size)
    got = tvol.pdf2d(_t(x), _t(y), nbins=nbins, xrange=XR, yrange=YR, weights=_t(w))
    ref, xe, ye = np.histogram2d(x, y, bins=nbins, range=(XR, YR), weights=w)
    np.testing.assert_allclose(got["counts"], ref, rtol=1e-12, atol=0)
    area = np.outer(np.diff(xe), np.diff(ye))
    np.testing.assert_allclose(got["pdf"], ref / (ref.sum() * area), rtol=1e-12, atol=0)


def test_pdf2d_auto_range_and_empty_input():
    x, y = _samples(4001, seed=3)
    x, y = x[~np.isnan(x) & ~np.isnan(y)], y[~np.isnan(x) & ~np.isnan(y)]
    got = tvol.pdf2d(_t(x), _t(y), nbins=(20, 30))
    ref, xe, ye = np.histogram2d(x, y, bins=(20, 30))
    np.testing.assert_array_equal(got["counts"], ref)
    np.testing.assert_array_equal(got["xedges"], xe)
    assert got["counts"].sum() == x.size
    empty = tvol.pdf2d(torch.zeros(0, dtype=torch.float64), torch.zeros(0, dtype=torch.float64),
                       nbins=4, xrange=(0, 1), yrange=(0, 1))
    assert empty["counts"].shape == (4, 4) and not empty["counts"].any()
    with pytest.raises(ValueError, match="auto-range"):
        tvol.pdf2d(torch.zeros(0), torch.zeros(0))
    with pytest.raises(ValueError, match="does not match"):
        tvol.pdf2d(torch.zeros(4), torch.zeros(5))


def test_pdf1d_matches_numpy_and_fava_tpu():
    x, _ = _samples(20011, seed=11)
    w = np.random.default_rng(12).random(x.size)
    got = tvol.pdf1d(_t(x), nbins=37, vrange=XR)
    ref, edges = np.histogram(x, bins=37, range=XR)
    np.testing.assert_array_equal(got["counts"], ref)
    np.testing.assert_array_equal(got["edges"], edges)
    np.testing.assert_array_equal(got["counts"], jvol.pdf1d(jnp.asarray(x), nbins=37, vrange=XR)["counts"])
    gw = tvol.pdf1d(_t(x), nbins=37, vrange=XR, weights=_t(w))
    rw, _ = np.histogram(x, bins=37, range=XR, weights=w)
    np.testing.assert_allclose(gw["counts"], rw, rtol=1e-12, atol=0)
    finite = x[~np.isnan(x)]
    auto = tvol.pdf1d(_t(finite), nbins=50)
    ref_auto, _ = np.histogram(finite, bins=50)
    np.testing.assert_array_equal(auto["counts"], ref_auto)
    np.testing.assert_allclose(auto["pdf"], np.histogram(finite, bins=50, density=True)[0],
                               rtol=1e-12)
    with pytest.raises(ValueError, match="auto-range"):
        tvol.pdf1d(torch.zeros(0))


# ---------------------------------------------------------------------------
# The mesh analyses, uniform and AMR, against fava_tpu


def _compare_dicts(got, ref, exact=("counts",), rtol=1e-10):
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        if key in exact:
            np.testing.assert_array_equal(got[key], r, err_msg=key)
        else:
            _close(got[key], r, key, rtol=rtol)


@pytest.mark.parametrize("models", KINDS, indirect=True)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_pdf1d_of_a_mesh_matches_fava_tpu(models, weight):
    jm, tm = models
    exact = ("counts", "edges") if weight is None or (weight == "volume" and jm.mesh.nblocks == 1) else ("edges",)
    _compare_dicts(tm.pdf1d("velx", weight=weight, nbins=40), jm.pdf1d("velx", weight=weight, nbins=40), exact)


@pytest.mark.parametrize("models", KINDS, indirect=True)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_pdf2d_of_a_mesh_matches_fava_tpu(force_interpret, models, weight):
    """Weighted: fava_tpu's kernel sums each 65,536-sample step in float32
    on the MXU, so it is held at rtol 2e-6; the port is held to
    np.histogram2d(weights=) at rtol 1e-12."""
    jm, tm = models
    got, ref = tm.pdf2d("dens", "velx", weight=weight), jm.pdf2d("dens", "velx", weight=weight)
    unweighted = weight is None or (weight == "volume" and jm.mesh.nblocks == 1)
    exact = ("counts", "xedges", "yedges") if unweighted else ("xedges", "yedges")
    _compare_dicts(got, ref, exact, rtol=1e-10 if unweighted else 2e-6)
    x = tm.mesh._leaf_stack("dens").numpy().ravel()
    y = tm.mesh._leaf_stack("velx").numpy().ravel()
    if unweighted:
        np.testing.assert_array_equal(got["counts"], np.histogram2d(x, y, bins=100)[0])
    else:
        if jm.mesh.nblocks == 1:
            w = tm.mesh._uniform_pdf_weights(weight).numpy().ravel()
        else:
            w = tm.mesh._pdf_weights(weight, tm.mesh._leaf_stack("dens").shape).numpy().ravel()
        ref_w = np.histogram2d(x, y, bins=100, weights=w)[0]
        np.testing.assert_allclose(got["counts"], ref_w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("models", KINDS, indirect=True)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_density_pdf_of_a_mesh_matches_fava_tpu(models, weight):
    jm, tm = models
    got, ref = tm.density_pdf(weight=weight, mach=2.0), jm.density_pdf(weight=weight, mach=2.0)
    assert sorted(got) == sorted(ref)
    for key in ("rho_mean", "mean_s", "sigma_s", "skewness", "excess_kurtosis",
                "lognormal_residual", "b_parameter"):
        assert isinstance(got[key], float), key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(got["edges"], ref["edges"], rtol=1e-12, atol=1e-12)
    if weight is None or (weight == "volume" and jm.mesh.nblocks == 1):
        np.testing.assert_array_equal(got["counts"], ref["counts"])
    else:
        _close(got["counts"], ref["counts"], "counts")
    _close(got["pdf"], ref["pdf"], "pdf")


@pytest.mark.parametrize("models", KINDS, indirect=True)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_binned_statistic_of_a_mesh_matches_fava_tpu(models, weight):
    jm, tm = models
    kw = dict(weight=weight, nbins=24)
    _compare_dicts(tm.binned_statistic("dens", "velx", **kw),
                   jm.binned_statistic("dens", "velx", **kw), ("counts", "edges"))


@pytest.mark.parametrize("models", KINDS, indirect=True)
def test_mass_and_volume_sums_match_fava_tpu(models):
    jm, tm = models
    dens = jm.mesh._leaf_stack("dens")
    masks = {"dense": np.asarray(dens) > float(np.median(np.asarray(dens)))}
    got, ref = tm.mass_sum(masks=masks), jm.mass_sum(masks=masks)
    assert sorted(got) == sorted(ref) == ["dense", "total"]
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, err_msg=key)
    for name in ("volume_average", "volume_integration"):
        np.testing.assert_allclose(getattr(tm, name)("dens"), getattr(jm, name)("dens"),
                                   rtol=1e-12, err_msg=name)
    if jm.mesh.nblocks == 1:
        g, r = tm.mesh.mass_fraction(masks=masks), jm.mesh.mass_fraction(masks=masks)
        for key in r:
            np.testing.assert_allclose(g[key], r[key], rtol=1e-12, err_msg=key)


def test_amr_volume_weights_are_the_leaf_cell_volumes(amr_file):
    tm = fava_tpu_torch.FLASH(amr_file.parent, device="cpu")
    tm.load(file_type="plt")
    shape = tuple(tm.mesh._leaf_stack("dens").shape)
    w = tm.mesh._pdf_weights("volume", shape)
    assert w.is_contiguous() and tuple(w.shape) == shape
    np.testing.assert_array_equal(w[:, 0, 0, 0].numpy(), tm.mesh.get_cell_volumes("LEAF"))
    with pytest.raises(ValueError, match="Unknown pdf weight"):
        tm.pdf1d("dens", weight="bogus")


# ---------------------------------------------------------------------------
# binned_statistic and density_pdf against scipy/closed forms


def test_binned_statistic_matches_scipy_and_empty_bins_are_nan():
    rng = np.random.default_rng(41)
    x = rng.normal(0.0, 1.5, 20001)
    y = 1.0e6 + 3.0 * x + rng.normal(0.0, 0.3, x.size)
    got = tvol.binned_statistic(_t(x), _t(y), nbins=12)
    for stat, key in (("count", "counts"), ("mean", "mean"), ("std", "std")):
        ref = scipy.stats.binned_statistic(x, y, statistic=stat, bins=12)
        _close(got[key], ref.statistic, stat)
    out = tvol.binned_statistic(_t([0.1, 0.1, 0.9, 2.5]), _t([1.0, 3.0, 5.0, 100.0]), nbins=4,
                                vrange=(0.0, 1.0))
    np.testing.assert_array_equal(out["counts"], [2, 0, 0, 1])
    np.testing.assert_allclose(out["mean"][[0, 3]], [2.0, 5.0])
    np.testing.assert_allclose(out["std"][[0, 3]], [1.0, 0.0])
    assert np.isnan(out["mean"][1]) and np.isnan(out["std"][2])
    with pytest.raises(ValueError, match="vrange"):
        tvol.binned_statistic(_t(x), _t(y), vrange=(1.0, 1.0))


def test_density_pdf_of_a_lognormal_field():
    rng = np.random.default_rng(14)
    rho = np.exp(rng.standard_normal(40001) * 0.5)
    got = tvol.density_pdf(_t(rho), nbins=8, nsigma=10.0)
    ref = jvol.density_pdf(jnp.asarray(rho), nbins=8, nsigma=10.0)
    assert got["counts"].sum() == 40001
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    s = np.log(rho / rho.mean())
    np.testing.assert_allclose(got["sigma_s"], s.std(), rtol=1e-12)
    with pytest.raises(ValueError, match="srange"):
        tvol.density_pdf(_t(rho), srange=(1.0, 1.0))
    with pytest.raises(ValueError, match="mach"):
        tvol.density_pdf(_t(rho), mach=0.0)
    const = tvol.density_pdf(torch.full((64,), 2.0, dtype=torch.float64), nbins=4)
    assert const["sigma_s"] == 0.0 and const["counts"].sum() == 64


# ---------------------------------------------------------------------------
# The analysis file


def _tree(f):
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(name, obj[()] if isinstance(obj, h5py.Dataset) else None))
    return out


def _stage4_results(model):
    return {
        "kinetic energy spectra": model.kinetic_energy_spectra(),
        "scalar spectra": model.scalar_spectra("dens"),
        "pdf2d": model.pdf2d("dens", "velx", nbins=(8, 6)),
        "density pdf": model.density_pdf(nbins=16),
        "binned statistic": model.binned_statistic("dens", "velx", nbins=5),
        "mass": model.mesh.mass_fraction(),
        "label": "uniform",
    }


def test_save_to_hdf5_writes_what_fava_tpu_writes(tmp_path, uniform_file):
    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    for name, results in (("j.h5", _stage4_results(jm)), ("t.h5", _stage4_results(tm))):
        model = jm if name == "j.h5" else tm
        for key, value in results.items():  # one call per analysis, as pipeline stage 4 does
            model.save_to_hdf5({key: value}, tmp_path / name)
    with h5py.File(tmp_path / "j.h5") as fj, h5py.File(tmp_path / "t.h5") as ft:
        ref, got = _tree(fj), _tree(ft)
        assert sorted(got) == sorted(ref)
        for key, r in ref.items():
            if r is None:
                assert got[key] is None, key
                continue
            g = got[key]
            assert g.dtype == r.dtype and g.shape == r.shape, key
            if g.dtype.kind == "f":
                _close(g, r, key)
            else:
                np.testing.assert_array_equal(g, r, err_msg=key)
    assert tm.hdf5_key_exists("scalar spectra/dens/power", tmp_path / "t.h5")
    assert not tm.hdf5_key_exists("scalar spectra/velx", tmp_path / "t.h5")
    assert not tm.hdf5_key_exists("pdf2d", tmp_path / "missing.h5")


def test_save_to_hdf5_appends_and_replaces(tmp_path, uniform_file):
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    path = tmp_path / "a.h5"
    tm.save_to_hdf5({"a": {"x": np.arange(3), "y": 1.5}, "b": np.ones(2)}, path)
    tm.save_to_hdf5({"a": {"x": np.arange(5.0)}, "b": {"z": "text"}}, path)
    with h5py.File(path) as f:
        assert sorted(_tree(f)) == ["a", "a/x", "a/y", "b", "b/z"]
        np.testing.assert_array_equal(f["a/x"][()], np.arange(5.0))
        assert f["a/y"][()] == 1.5 and f["a/y"].shape == ()
        assert f["b/z"][()] == b"text"
    with h5py.File(path, "a") as f:  # and h5lite appends to what h5py wrote
        f["a"].create_group("c").create_dataset("w", data=[7, 8])
    tm.save_to_hdf5({"d": [1.0]}, path)
    with h5py.File(path) as f:
        np.testing.assert_array_equal(f["a/c/w"][()], [7, 8])
        np.testing.assert_array_equal(f["d"][()], [1.0])


def test_stage4_analyses_are_registered():
    for name in ("pdf1d", "pdf2d", "density_pdf", "binned_statistic", "mass_sum",
                 "volume_average", "volume_integration"):
        assert callable(getattr(fava_tpu_torch.Model, name)), name
