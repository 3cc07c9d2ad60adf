"""fava_tpu_torch's fractal dimension held to fava_tpu and to the NumPy
oracle of tests/oracles/fractal.py, on the CPU, in float64.

The same numpy volumes go to both packages. Tolerances: the edge mask and
the box counts exact (comparisons and integer counts); the four
statistics ("average fractal dimension", "slope", "R2", "curve") within
rtol 1e-12 (the same float64 formulas on the same counts); an empty
contour gives NaN in every statistic, as the reference does.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import fractal as jfractal
from fava_tpu_torch.ops import fractal as tfractal
from tests.oracles.fractal import edge_detect_oracle, fractal_dimension_oracle

STATS = ("average fractal dimension", "slope", "R2", "curve")
SHAPES = [(16, 16, 16), (12, 20, 9), (17, 8, 33), (16, 16, 1), (13, 21, 1)]


def _smooth(shape, seed):
    """A smooth field with a wrinkled 0.5 level set (plus noise)."""
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*(np.linspace(0, 1, n) for n in shape), indexing="ij")
    f = 0.5 + 0.3 * np.sin(5 * axes[0] + 3 * axes[1]) * np.cos(4 * axes[2] + 2 * axes[1])
    return f + 0.05 * rng.standard_normal(shape)


def _close(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert sorted(got[key]) == sorted(STATS)
        for s in STATS:
            np.testing.assert_allclose(got[key][s], ref[key][s], rtol=1e-12, atol=0, err_msg=s)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("contour", [0.5, 0.3])
def test_edge_mask_equals_fava_tpu_and_the_oracle(shape, contour):
    data = _smooth(shape, sum(shape))
    data.flat[::97] = contour  # cells on the contour itself are surface cells
    got = tfractal.edge_detect(torch.from_numpy(data), contour).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, np.asarray(jfractal.edge_detect(jnp.asarray(data), contour)))
    np.testing.assert_array_equal(got, edge_detect_oracle(data, contour))


@pytest.mark.parametrize("shape", SHAPES)
def test_box_counts_equal_fava_tpu(shape):
    data = _smooth(shape, 3 * sum(shape))
    largest = min(shape[:2]) if shape[2] == 1 else min(shape)
    flength = int(np.log2(largest)) + 1
    ref = np.asarray(jfractal._fractal_counts_fn(shape, flength, False)(jnp.asarray(data),
                                                                           jnp.asarray(0.5)))
    got = tfractal.box_counts(tfractal.edge_detect(torch.from_numpy(data), 0.5), flength)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_statistics_equal_fava_tpu_and_the_oracle(shape):
    data = _smooth(shape, 5 * sum(shape))
    got = tfractal.fractal_dimension(torch.from_numpy(data), [0.4, 0.5])
    _close(got, jfractal.fractal_dimension(jnp.asarray(data), [0.4, 0.5]))
    for c in (0.4, 0.5):
        _close({"c": got[f"{c}"]}, {"c": fractal_dimension_oracle(data, c)})


def test_empty_contour_is_nan_like_the_oracle_and_warns_nothing():
    """A contour above every cell fills no box: the statistics are NaN
    (the reference's log2(0) pipeline), and the warnings numpy raises
    on that path are silenced there alone."""
    data = _smooth((8, 8, 8), 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tfractal.fractal_dimension(torch.from_numpy(data), 99.0)["99.0"]
    with np.errstate(invalid="ignore", divide="ignore"):
        ref = fractal_dimension_oracle(data, 99.0)
    for s in STATS:
        assert np.isnan(ref[s]) and np.isnan(got[s]), s


def test_statistics_keep_numpy_warnings_where_no_level_is_empty():
    """The errstate is scoped: a non-empty contour runs under the
    caller's numpy error settings (a raise setting sees no error)."""
    data = _smooth((8, 8, 8), 2)
    with np.errstate(all="raise"):
        out = tfractal.fractal_dimension(torch.from_numpy(data), 0.5)["0.5"]
    assert all(np.isfinite(out[s]) for s in STATS)


def test_contours_none_list_and_validation():
    data = _smooth((12, 12, 12), 9)
    t = torch.from_numpy(data)
    mean = float(t.mean())
    none = tfractal.fractal_dimension(t, None)
    assert list(none) == ["None"]
    _close({"c": none["None"]}, {"c": tfractal.fractal_dimension(t, mean)[f"{mean}"]})
    _close(none, jfractal.fractal_dimension(jnp.asarray(data), None))
    assert set(tfractal.fractal_dimension(t, [0.4, 0.6])) == {"0.4", "0.6"}
    assert set(tfractal.fractal_dimension(t, (0.4,))) == {"0.4"}
    assert set(tfractal.fractal_dimension(t, np.float64(0.5))) == {"0.5"}
    assert set(tfractal.fractal_dimension(t, np.int64(1))) == {"1"}
    for bad in ("bad", True, {0.5}):
        with pytest.raises(ValueError, match="Contours"):
            tfractal.fractal_dimension(t, bad)


def test_contour_none_mean_is_taken_in_the_accumulation_dtype():
    data = torch.from_numpy(_smooth((8, 8, 8), 4)).float()
    c = data.double().mean().float()
    got = tfractal.fractal_dimension(data, None)["None"]
    _close({"c": got}, {"c": tfractal.fractal_dimension(data, float(c))[f"{float(c)}"]})


def test_2d_dataset_through_both_meshes(tmp_path):
    """The (n, n, 1) case of tests/test_2d.py: a 2D uniform file read by
    both packages."""
    from fava_tpu.io import synthetic

    rng = np.random.default_rng(4)
    n = 16
    fields = {"dens": np.abs(1.0 + 0.2 * rng.standard_normal((n, n, 1))),
              "velx": rng.standard_normal((n, n, 1)), "vely": rng.standard_normal((n, n, 1)),
              "flam": rng.random((n, n, 1))}
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(n, n, 1),
                                field_data=fields, ndim=2)
    jm = fava_tpu.FLASH(tmp_path)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    tm.load(file_type="uni")
    assert tm.mesh.ndim == 2
    got = tm.fractal_dimension(field="flam", contours=0.5)
    _close(got["flam"], jm.fractal_dimension(field="flam", contours=0.5)["flam"])
    assert np.isfinite(got["flam"]["0.5"]["average fractal dimension"])


def test_mesh_method_and_registered_analysis(uniform_file):
    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    for kw in ({"field": "flam", "contours": 0.5}, {"field": "dens", "contours": None},
               {"field": "velx", "contours": [-0.2, 0.0, 0.2]}):
        got = tm.fractal_dimension(**kw)
        assert list(got) == [kw["field"]]
        _close(got[kw["field"]], jm.fractal_dimension(**kw)[kw["field"]])
        _close(tm.mesh.fractal_dimension(**kw)[kw["field"]], got[kw["field"]])
