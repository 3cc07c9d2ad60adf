"""fava_tpu_torch's velocity-gradient statistics and Q-R invariant PDF held
to fava_tpu on the CPU, in float64, and to tests/oracles/gradients.py.

The same seeded numpy fields go through fava_tpu/ops/gradients.py (JAX on
the CPU, x64) and fava_tpu_torch/ops/gradients.py (CPU tensors: the Q-R
histogram runs B8's plain twin); the cases mirror tests/test_gradients.py
(the sharded one aside, ROADMAP A11) and add odd extents, the packed
vector itself, the registered analyses on a uniform file and
``gradient_series``. One Q-R case runs fava_tpu's joint-histogram Pallas
kernel in interpret mode.

Tolerances: the reports rtol 1e-10 with atol 1e-12 (as tests/test_gradients.py:
float64 differences and means in another order); Q_w rtol 1e-12; the
histogram counts exactly (float64 Q and R against float64 edges that are
np.linspace on both sides, so a sample changes bin only if its Q or R
differs at an edge by a last-place rounding: none do on these inputs but
the solid-body rotation, whose test says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import gradients as jgrad
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu_torch.ops import gradients as tgrad
from tests.oracles.gradients import gradient_stats_oracle


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, seed=0, nd=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(nd)]


def _t(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _compare(out, ref, rtol=1e-10):
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, rtol=rtol, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8), (15, 9, 10)])
@pytest.mark.parametrize("boundary", ["periodic", "interior"])
@pytest.mark.parametrize("lengths", [None, (2.5, 0.75, 1.25)])
def test_matches_fava_tpu_and_oracle_3d(shape, boundary, lengths):
    vels = _fields(shape, 3)
    got = tgrad.velocity_gradient_statistics(*_t(vels), lengths=lengths, boundary=boundary)
    _compare(got, jgrad.velocity_gradient_statistics(*_j(vels), lengths=lengths,
                                                     boundary=boundary))
    _compare(got, gradient_stats_oracle(vels, lengths=lengths, boundary=boundary))


@pytest.mark.parametrize("shape", [(16, 12), (9, 15)])
@pytest.mark.parametrize("boundary", ["periodic", "interior"])
def test_matches_fava_tpu_with_lengths_2d(shape, boundary):
    vels = _fields(shape, 4, nd=2)
    lengths = (2.5, 0.75)
    got = tgrad.velocity_gradient_statistics(*_t(vels), lengths=lengths, boundary=boundary)
    _compare(got, jgrad.velocity_gradient_statistics(*_j(vels), lengths=lengths,
                                                     boundary=boundary))
    _compare(got, gradient_stats_oracle(vels, lengths=lengths, boundary=boundary))


@pytest.mark.parametrize("nd", [2, 3])
def test_packed_vector_and_names_match_fava_tpu(nd):
    shape = (12, 10, 8)[:nd]
    vels = _fields(shape, 5, nd=nd)
    got, names = tgrad.gradient_stats_device(_t(vels), lengths=None, boundary="periodic")
    ref, ref_names = jgrad.gradient_stats_device(_j(vels), lengths=None, boundary="periodic")
    assert names == ref_names == tgrad.packed_names(nd)
    assert got.dtype == torch.float64 and got.shape == (len(names),)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_single_mode_closed_form():
    n, m, L = 32, 3, 2.0
    y = np.arange(n) * (L / n)
    k = 2.0 * np.pi * m / L
    ux = np.broadcast_to(np.sin(k * y)[None, :, None], (n, n, n)).copy()
    zeros = np.zeros((n, n, n))
    out = tgrad.velocity_gradient_statistics(*_t([ux, zeros, zeros]), lengths=(L, L, L))
    dy = L / n
    amp = np.sin(k * dy) / dy
    assert abs(out["gradient_moment2"][0, 1] - 0.5 * amp**2) < 1e-10
    assert abs(out["enstrophy"] - 0.5 * amp**2) < 1e-10
    assert abs(out["dilatation_msq"]) < 1e-12
    assert abs(out["pseudo_dissipation"] - 0.5 * amp**2) < 1e-10
    assert abs(out["transverse_flatness"] - 1.5 / 6.0) < 1e-10
    assert out["taylor_microscale"][0] == 0.0


def test_mean_shear_lands_in_gradient_mean():
    n, L, s = 16, 1.0, 50.0
    rng = np.random.default_rng(7)
    y = (np.arange(n) + 0.5) * (L / n)
    ux = np.broadcast_to(y[None, :, None], (n, n, n)) * s + 1e-2 * rng.standard_normal((n, n, n))
    vels = [ux, rng.standard_normal((n, n, n)), rng.standard_normal((n, n, n))]
    out = tgrad.velocity_gradient_statistics(*_t(vels), lengths=(L, L, L), boundary="interior")
    _compare(out, jgrad.velocity_gradient_statistics(*_j(vels), lengths=(L, L, L),
                                                     boundary="interior"))
    np.testing.assert_allclose(out["gradient_mean"][0, 1], s, rtol=1e-3)
    assert out["gradient_moment2"][0, 1] < 1.0


def test_mean_shear_in_float32_stays_out_of_the_moments():
    """float32 fields (the card's dtype), here on the CPU: the two-pass
    float64 centring keeps a large mean gradient out of the fluctuation
    moments, which match fava_tpu's float64 run on the same float32
    values to the float32 rounding of the differences."""
    n, L, s = 16, 1.0, 50.0
    rng = np.random.default_rng(8)
    y = (np.arange(n) + 0.5) * (L / n)
    ux = np.broadcast_to(y[None, :, None], (n, n, n)) * s + 1e-2 * rng.standard_normal((n, n, n))
    vels = [a.astype(np.float32) for a in (ux, rng.standard_normal((n, n, n)),
                                           rng.standard_normal((n, n, n)))]
    got = tgrad.velocity_gradient_statistics(*[torch.from_numpy(v) for v in vels],
                                             lengths=(L, L, L), boundary="interior")
    ref = jgrad.velocity_gradient_statistics(*[jnp.asarray(v, dtype=jnp.float64) for v in vels],
                                             lengths=(L, L, L), boundary="interior")
    # float32 differences of values ~50: an absolute error ~ 50 * 2^-24 / dx
    np.testing.assert_allclose(got["gradient_moment2"], ref["gradient_moment2"], rtol=1e-4)
    np.testing.assert_allclose(got["velocity_variance"], ref["velocity_variance"], rtol=1e-10)


def test_validation_errors():
    v = torch.zeros((8, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="boundary"):
        tgrad.velocity_gradient_statistics(v, v, v, boundary="wrap")
    with pytest.raises(ValueError, match="velocity components"):
        tgrad.velocity_gradient_statistics(v, v)
    tiny = torch.zeros((2, 2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="at least 3 cells"):
        tgrad.velocity_gradient_statistics(tiny, tiny, tiny, boundary="interior")
    with pytest.raises(ValueError, match="at least 3 cells"):
        tgrad.gradient_invariant_pdfs(tiny, tiny, tiny, boundary="interior")
    with pytest.raises(ValueError, match="nbins >= 2"):
        tgrad.gradient_invariant_pdfs(v, v, v, nbins=(1, 4))


def test_registered_analysis_from_arrays():
    rng = np.random.default_rng(11)
    n = 12
    arrays = {"dens": 1.0 + 0.4 * rng.random((n, n, n))}
    arrays.update({f"vel{a}": rng.standard_normal((n, n, n)) for a in "xyz"})
    bounds = [[0.0, 2.0], [0.0, 1.0], [0.0, 1.0]]
    m = fava_tpu_torch.from_arrays(arrays, domain_bounds=bounds, device="cpu")
    for boundary in ("periodic", "interior"):
        out = m.velocity_gradient_statistics(boundary=boundary)
        ref = gradient_stats_oracle([arrays[f"vel{a}"] for a in "xyz"], lengths=(2.0, 1.0, 1.0),
                                    boundary=boundary)
        _compare(out, ref)
        _compare(out, fava_tpu.from_arrays(arrays, domain_bounds=bounds)
                 .velocity_gradient_statistics(boundary=boundary))


def test_amr_model_gets_routed_error(tmp_path):
    from fava_tpu.io import synthetic

    synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0000")
    model = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    model.load(file_type="plt")
    for name in ("velocity_gradient_statistics", "gradient_invariant_pdfs"):
        with pytest.raises(AttributeError, match="uniform-grid"):
            getattr(model, name)()


def _qr_oracle(vels, lengths=None, boundary="periodic"):
    shape = vels[0].shape
    dx = ([2.0 * np.pi / n for n in shape] if lengths is None
          else [float(L) / n for L, n in zip(lengths, shape)])
    inner = tuple(slice(1, -1) for _ in range(3))

    def grad(i, j):
        d = (np.roll(vels[i], -1, axis=j) - np.roll(vels[i], 1, axis=j)) / (2.0 * dx[j])
        return d[inner] if boundary == "interior" else d

    g = [[grad(i, j) for j in range(3)] for i in range(3)]
    P = -(g[0][0] + g[1][1] + g[2][2])
    Q = 0.5 * (P * P - sum(g[i][j] * g[j][i] for i in range(3) for j in range(3)))
    R = -(g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[2][1])
          - g[0][1] * (g[1][0] * g[2][2] - g[1][2] * g[2][0])
          + g[0][2] * (g[1][0] * g[2][1] - g[1][1] * g[2][0]))
    w2 = (g[2][1] - g[1][2]) ** 2 + (g[0][2] - g[2][0]) ** 2 + (g[1][0] - g[0][1]) ** 2
    return Q, R, w2.mean() / 4.0


def _compare_pdfs(got, ref):
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_array_equal(got["q_edges"], ref["q_edges"])
    np.testing.assert_array_equal(got["r_edges"], ref["r_edges"])
    np.testing.assert_allclose(got["q_w"], ref["q_w"], rtol=1e-12)
    np.testing.assert_allclose(got["pdf"], ref["pdf"], rtol=1e-12)
    assert got["inside_fraction"] == ref["inside_fraction"]


@pytest.mark.parametrize("shape", [(12, 12, 12), (11, 10, 9)])
@pytest.mark.parametrize("boundary", ["periodic", "interior"])
@pytest.mark.parametrize("lengths", [None, (1.0, 2.0, 0.5)])
def test_invariant_pdfs_match_fava_tpu_and_histogram2d(shape, boundary, lengths):
    vels = _fields(shape, 21)
    kw = dict(lengths=lengths, nbins=(24, 20), qr_range=6.0, boundary=boundary)
    got = tgrad.gradient_invariant_pdfs(*_t(vels), **kw)
    _compare_pdfs(got, jgrad.gradient_invariant_pdfs(*_j(vels), **kw))
    Q, R, qw = _qr_oracle(vels, lengths, boundary)
    np.testing.assert_allclose(got["q_w"], qw, rtol=1e-12)
    counts, _, _ = np.histogram2d(Q.ravel(), R.ravel(), bins=(24, 20),
                                  range=[(-6.0 * qw, 6.0 * qw), (-6.0 * qw**1.5, 6.0 * qw**1.5)])
    np.testing.assert_array_equal(got["counts"], counts)
    areas = np.diff(got["q_edges"])[:, None] * np.diff(got["r_edges"])[None, :]
    np.testing.assert_allclose((got["pdf"] * areas).sum(), got["inside_fraction"], rtol=1e-12)


def test_invariant_pdfs_match_fava_tpu_kernel_in_interpret_mode():
    vels = _fields((12, 12, 12), 22)
    pk.FORCE_INTERPRET = True
    try:
        ref = jgrad.gradient_invariant_pdfs(*_j(vels), nbins=16)
    finally:
        pk.FORCE_INTERPRET = False
    _compare_pdfs(tgrad.gradient_invariant_pdfs(*_t(vels), nbins=16), ref)


def test_invariant_pdfs_solid_body_rotation():
    """Every cell at (Q, R) = (Omega^2, 0), Q_w = Omega^2. The normalised
    point (1, 0) lies on the q edge 12 and the r edge 8 of these bins, so
    which side a cell's Q takes depends on the last-place rounding of
    Q_w's mean (fava_tpu's reduction gives 0.49000000000000166, the
    port's 0.49): the counts sit in the two q bins that share that edge
    and in the r bin that starts at 0 (tests/test_gradients.py holds
    fava_tpu to its single bin)."""
    n, L, Om = 12, 1.0, 0.7
    x = (np.arange(n) + 0.5) * (L / n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    ux = np.broadcast_to((-Om * Y)[:, :, None], (n, n, n)).copy()
    uy = np.broadcast_to((Om * X)[:, :, None], (n, n, n)).copy()
    out = tgrad.gradient_invariant_pdfs(*_t([ux, uy, np.zeros((n, n, n))]), lengths=(L, L, L),
                                        nbins=(16, 16), qr_range=2.0, boundary="interior")
    assert out["inside_fraction"] == 1.0
    np.testing.assert_allclose(out["q_w"], Om**2, rtol=1e-12)
    qi = int(np.searchsorted(out["q_edges"], 1.0))
    assert out["q_edges"][qi] == 1.0 and out["r_edges"][8] == 0.0
    rows, cols = np.nonzero(out["counts"])
    assert set(rows.tolist()) <= {qi - 1, qi} and set(cols.tolist()) == {8}
    assert out["counts"].sum() == (n - 2) ** 3


def test_invariant_pdfs_of_a_quiescent_field_take_the_floor():
    """Q_w = 0 (a uniform flow): the edges scale by the 1e-20 clamp, and
    every cell, at (Q, R) = (0, 0), lands in the middle bins."""
    n = 8
    ones = np.ones((n, n, n))
    got = tgrad.gradient_invariant_pdfs(*_t([ones, 2 * ones, 3 * ones]), nbins=(4, 4))
    _compare_pdfs(got, jgrad.gradient_invariant_pdfs(*_j([ones, 2 * ones, 3 * ones]), nbins=(4, 4)))
    assert got["q_w"] == 0.0 and got["counts"].sum() == n**3


def test_invariant_pdfs_validation():
    v = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        tgrad.gradient_invariant_pdfs(v, v, v)


@pytest.mark.parametrize("name,kw", [("velocity_gradient_statistics", {"boundary": "interior"}),
                                     ("gradient_invariant_pdfs", {"nbins": 12, "qr_range": 4.0})])
def test_registered_analyses_match_fava_tpu_on_a_uniform_file(tmp_path, name, kw):
    from fava_tpu.io import synthetic

    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(16, 12, 8), seed=9)
    jm, tm = fava_tpu.FLASH(tmp_path), fava_tpu_torch.FLASH(tmp_path, device="cpu")
    jm.load(file_type="uni")
    tm.load(file_type="uni")
    got, ref = getattr(tm, name)(**kw), getattr(jm, name)(**kw)
    if name == "gradient_invariant_pdfs":
        _compare_pdfs(got, ref)
    else:
        _compare(got, ref)


@pytest.mark.parametrize("boundary", ["periodic", "interior"])
def test_gradient_series_matches_fava_tpu(tmp_path, boundary):
    from fava_tpu.io import synthetic

    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_uniform_file(tmp_path / f"rt_hdf5_uniform_{i:04d}", ncells=(8, 10, 8),
                                    seed=10 + i, time=t)
    ref = fava_tpu.FLASH(tmp_path).gradient_series(file_type="uni", boundary=boundary)
    tm = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    got = tm.gradient_series(file_type="uni", boundary=boundary)
    assert got["gradient_moment2"].shape == (3, 3, 3)
    _compare(got, ref)
    for row in range(3):
        tm.load(file_type="uni", file_index=row)
        for k, v in tm.velocity_gradient_statistics(boundary=boundary).items():
            np.testing.assert_array_equal(got[k][row], v, err_msg=k)


def test_series_unknown_file_type_named_error(tmp_path):
    from fava_tpu.io import synthetic

    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(8, 8, 8))
    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    for name in ("summary_series", "gradient_series"):
        with pytest.raises(ValueError, match="mesh-series.*'plt'"):
            getattr(m, name)(file_type="prt")
