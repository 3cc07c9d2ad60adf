"""fava_tpu_torch's particle analyses held to fava_tpu on the CPU, in float64.

The six particle analyses (the pair structure functions, dispersion,
the Lagrangian and Eulerian autocorrelations, the cross correlation and
the particle series, the last in tests/test_torch_particles.py) run
through both packages' ``FLASH`` models on the same directories, written
from a seed with numpy. Pair draws, bin counts and nearest-neighbour
partners are compared exactly; every other output at rtol 1e-12 (float64
on both sides, sums in another order). Mirrors tests/test_pair_structure.py,
tests/test_dispersion.py (its first five tests and the clustered
nearest-neighbour case) and tests/test_correlations.py.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import structure as jstruct
from fava_tpu_torch.analysis import dispersion as disp
from fava_tpu_torch.io import flash_file, synthetic
from fava_tpu_torch.ops.structure import pair_bin_edges, pair_indices, pair_structure_functions

RTOL = 1e-12


def _models(directory):
    return fava_tpu_torch.FLASH(directory, device="cpu"), fava_tpu.FLASH(directory)


def _assert_same(got, ref, what, exact=()):
    """Nested dicts / tuples / arrays equal: ``exact`` keys bit for bit,
    the rest at RTOL (NaN where the reference is NaN)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            _assert_same(got[k], ref[k], f"{what}/{k}", exact)
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{what}[{i}]", exact)
    elif what.split("/")[-1] in exact:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=what)
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64),
                                   rtol=RTOL, atol=0, err_msg=what)


# ---------------------------------------------------------------------------
# Pair structure functions (tests/test_pair_structure.py)


def _oracle(pos, vel, lo, hi, nbins, orders, num_pairs, seed, lengths=None):
    """float64 numpy on the same pair draws (the port's ``pair_indices``
    on the CPU), binning r^2 against the squared float64 edges."""
    n = pos.shape[0]
    idx = pair_indices(seed, num_pairs, n, device="cpu").numpy()
    dr = pos[idx[1]].astype(np.float64) - pos[idx[0]].astype(np.float64)
    if lengths is not None:
        L = np.asarray(lengths, dtype=np.float64)
        dr = dr - L * np.round(dr / L)
    r2 = (dr**2).sum(axis=-1)
    r = np.sqrt(r2)
    dv = vel[idx[1]] - vel[idx[0]]
    dl = np.abs((dv * dr).sum(axis=-1) / np.maximum(r, 1e-30))
    dt = np.sqrt(np.maximum((dv**2).sum(axis=-1) - dl**2, 0.0))
    e2 = pair_bin_edges(lo, hi, nbins, log_bins=True) ** 2
    bidx = (r2[:, None] >= e2[None, 1:nbins]).sum(axis=1)
    mask = (r2 >= e2[0]) & (r2 <= e2[nbins])
    out = {"longitudinal": {}, "transverse": {}}
    counts = np.bincount(bidx[mask], minlength=nbins)[:nbins].astype(np.float64)
    out["counts"] = counts
    safe = np.maximum(counts, 1)
    out["separations"] = np.where(
        counts > 0, np.bincount(bidx[mask], weights=r[mask], minlength=nbins)[:nbins] / safe, np.nan
    )
    for o in range(1, orders + 1):
        sl = np.bincount(bidx[mask], weights=dl[mask] ** o, minlength=nbins)[:nbins]
        st = np.bincount(bidx[mask], weights=dt[mask] ** o, minlength=nbins)[:nbins]
        out["longitudinal"][f"{o}"] = np.where(counts > 0, sl / safe, np.nan)
        out["transverse"][f"{o}"] = np.where(counts > 0, st / safe, np.nan)
    return out


@pytest.mark.parametrize("seed", [0, 3, 2**40 + 7, (5, 9)])
@pytest.mark.parametrize("num_pairs,n", [(1, 2), (4096, 512), (65536, 1_000_003)])
def test_pair_indices_are_fava_tpus(seed, num_pairs, n):
    got = pair_indices(seed, num_pairs, n, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, num_pairs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jstruct.pair_indices(seed, num_pairs, n)))


@pytest.mark.parametrize("periodic", [False, True])
def test_matches_same_draw_oracle(periodic):
    rng = np.random.default_rng(51)
    n = 512
    pos = rng.random((n, 3))
    vel = rng.standard_normal((n, 3))
    lengths = (1.0, 1.0, 1.0) if periodic else None
    kw = dict(num_pairs=4096, nbins=8, sep_bounds=(0.05, 0.5), orders=4, lengths=lengths, seed=3)
    got = pair_structure_functions(pos, vel, device="cpu", **kw)
    ref = _oracle(pos, vel, 0.05, 0.5, 8, 4, 4096, 3, lengths)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["separations"], ref["separations"], rtol=1e-9)
    for o in ("1", "2", "3", "4"):
        np.testing.assert_allclose(got["longitudinal"][o], ref["longitudinal"][o], rtol=1e-9, err_msg=o)
        np.testing.assert_allclose(got["transverse"][o], ref["transverse"][o], rtol=1e-8, atol=1e-12,
                                   err_msg=o)
    _assert_same(got, jstruct.pair_structure_functions(pos, vel, **kw), "fava_tpu", exact=("counts",))


@pytest.mark.parametrize("periodic", [False, True])
def test_f32_counts_exactly_match_f64_oracle(periodic):
    """float32 inputs: bin membership still matches the float64 oracle
    exactly (the port widens the inputs and decides in float64), and
    equals fava_tpu's two-float decisions."""
    rng = np.random.default_rng(61)
    n = 4096
    pos32 = rng.random((n, 3), dtype=np.float32)
    vel32 = rng.standard_normal((n, 3)).astype(np.float32)
    lengths = (1.0, 1.0, 1.0) if periodic else None
    kw = dict(num_pairs=65536, nbins=8, sep_bounds=(0.05, 0.5), orders=2, lengths=lengths, seed=7)
    got = pair_structure_functions(torch.from_numpy(pos32), torch.from_numpy(vel32), device="cpu", **kw)
    ref = _oracle(pos32.astype(np.float64), vel32.astype(np.float64), 0.05, 0.5, 8, 2, 65536, 7, lengths)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["longitudinal"]["2"], ref["longitudinal"]["2"], rtol=2e-5)
    jref = jstruct.pair_structure_functions(jnp.asarray(pos32), jnp.asarray(vel32), **kw)
    np.testing.assert_array_equal(got["counts"], jref["counts"])


def test_uniform_expansion_closed_form():
    # v = H x: du_L = H r exactly and the transverse increment vanishes.
    rng = np.random.default_rng(52)
    n, H = 1024, 2.5
    pos = rng.random((n, 3))
    vel = H * pos
    got = pair_structure_functions(pos, vel, num_pairs=8192, nbins=6, sep_bounds=(0.1, 0.8), orders=2,
                                   seed=1, device="cpu")
    fin = got["counts"] > 0
    np.testing.assert_allclose(got["longitudinal"]["1"][fin], H * np.asarray(got["separations"])[fin],
                               rtol=1e-6)
    np.testing.assert_allclose(got["transverse"]["2"][fin], 0.0, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_pairs=5000, nbins=5, orders=3, log_bins=False, seed=11),
    dict(num_pairs=3000, nbins=1, orders=2, lengths=(1.0, 1.0, 1.0), sep_bounds=(1e-3, 0.9)),
])
@pytest.mark.parametrize("ndim", [2, 3])
def test_pair_structure_matches_fava_tpu(kw, ndim):
    """Defaults (the data's sep_bounds, 24 bins, orders 1-10, 200,000
    pairs), linear bins, a single bin, 2D tables."""
    rng = np.random.default_rng(ndim)
    pos = rng.random((777, ndim))
    vel = rng.standard_normal((777, ndim))
    if "lengths" in kw:
        kw = dict(kw, lengths=kw["lengths"][:ndim])
    got = pair_structure_functions(pos, vel, device="cpu", **kw)
    ref = jstruct.pair_structure_functions(pos, vel, **kw)
    _assert_same(got, ref, "pairs", exact=("counts",))


def test_validation_and_mesh(tmp_path):
    with pytest.raises(ValueError, match="matching"):
        pair_structure_functions(np.ones((8, 3)), np.ones((8, 2)), device="cpu")
    with pytest.raises(ValueError, match="sep_bounds"):
        pair_structure_functions(np.ones((8, 3)), np.ones((8, 3)), sep_bounds=(0.5, 0.1), device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        pair_structure_functions(np.ones((1, 3)), np.ones((1, 3)), device="cpu")

    synthetic.make_particle_file(tmp_path / "rt_hdf5_part_0001", nparticles=128, seed=3)
    m, j = _models(tmp_path)
    m.load(file_type="prt")
    j.load(file_type="prt")
    out = m.particle_structure_functions(num_pairs=2048, nbins=6, orders=3)
    assert set(out["longitudinal"]) == {"1", "2", "3"}
    assert np.isfinite(out["separations"][out["counts"] > 0]).all()
    _assert_same(out, j.particle_structure_functions(num_pairs=2048, nbins=6, orders=3), "model",
                 exact=("counts",))

    m2 = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    with pytest.raises(AttributeError, match="prt"):
        m2.particle_structure_functions()


# ---------------------------------------------------------------------------
# Dispersion (tests/test_dispersion.py)


def _write_series(tmp_path, times, positions_of_t, nglob):
    """positions_of_t(t) -> (nglob, 3) array in tag order (tag = 1..nglob),
    each file's rows in a fresh permutation."""
    rng = np.random.default_rng(7)
    tags = np.arange(1, nglob + 1, dtype=np.float64)
    for i, t in enumerate(times, start=1):
        perm = rng.permutation(nglob)
        pos = positions_of_t(t)
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": nglob},
            real_scalars={"time": float(t), "dt": 1e-3, "dtold": 1e-3},
            particles={"tag": tags[perm], "posx": pos[perm, 0], "posy": pos[perm, 1],
                       "posz": pos[perm, 2]},
        )


def _dispersion_both(directory, **kw):
    m, j = _models(directory)
    out = m.dispersion_statistics(**kw)
    _assert_same(out, j.dispersion_statistics(**kw), "dispersion", exact=("npairs",))
    return out


def test_uniform_translation(tmp_path):
    nglob = 40
    times = [0.0, 0.25, 0.5]
    rng = np.random.default_rng(3)
    x0 = rng.uniform(0.0, 1.0, (nglob, 3))
    v = np.array([0.3, -0.2, 0.1])
    _write_series(tmp_path, times, lambda t: x0 + v * t, nglob)

    out = _dispersion_both(tmp_path, npairs=16, seed=0)
    np.testing.assert_allclose(out["time"], times)
    np.testing.assert_allclose(out["single_msd"], (v**2).sum() * np.asarray(times) ** 2, rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(out["pair_msd"], out["initial_pair_separation_sq"], rtol=1e-12)
    assert out["npairs"] == 16
    assert out["pair_msd"][0] == pytest.approx(out["initial_pair_separation_sq"])


def test_ballistic_per_particle(tmp_path):
    nglob = 24
    times = [0.0, 0.5, 1.0]
    rng = np.random.default_rng(11)
    x0 = rng.uniform(0.0, 1.0, (nglob, 3))
    vel = rng.standard_normal((nglob, 3)) * 0.05
    _write_series(tmp_path, times, lambda t: x0 + vel * t, nglob)

    out = _dispersion_both(tmp_path, npairs=10_000, seed=1)  # clamps to nglob
    assert out["npairs"] == nglob
    np.testing.assert_allclose(out["single_msd"], (vel**2).sum(axis=1).mean() * np.asarray(times) ** 2,
                               rtol=1e-12, atol=1e-15)
    d2 = ((x0[:, None, :] - x0[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    partner = d2.argmin(axis=1)
    for j, t in enumerate(times):
        delta = (x0 + vel * t) - (x0[partner] + vel[partner] * t)
        np.testing.assert_allclose(out["pair_msd"][j], (delta**2).sum(axis=1).mean(), rtol=1e-12)
    np.testing.assert_allclose(out["initial_pair_separation_sq"], d2.min(axis=1).mean(), rtol=1e-12)


def test_requires_two_snapshots(tmp_path):
    _write_series(tmp_path, [0.0], lambda t: np.zeros((4, 3)), 4)
    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        m.dispersion_statistics()


def test_missing_tag_hard_errors(tmp_path):
    tags_a = np.array([1.0, 2.0, 3.0, 4.0])
    tags_b = np.array([1.0, 2.0, 3.0, 9.0])  # tag 4 vanished
    for i, (t, tags) in enumerate(zip([0.0, 0.1], [tags_a, tags_b]), start=1):
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": 4},
            real_scalars={"time": t, "dt": 1e-3, "dtold": 1e-3},
            particles={"tag": tags, "posx": tags * 0.1, "posy": tags * 0.2, "posz": tags * 0.3},
        )
    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="not found"):
        m.dispersion_statistics(npairs=4)


def _clustered(seed=3, n=5000, nanchors=300):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.0, 1.0, size=(n, 3))
    coords[100:200] = coords[0] + 1e-4 * rng.standard_normal((100, 3))
    return coords, rng.choice(n, size=nanchors, replace=False)


def test_device_nn_matches_host_brute_force():
    """The float64 difference-form sweep gives the partners of the float64
    brute force (``_nn_host``) and of fava_tpu's device search with its
    float64 re-decision, clustered tracers included."""
    from fava_tpu.analysis import dispersion as jdisp

    coords, anchors = _clustered()
    expected = disp._nn_host(coords, anchors)
    got = disp._nearest_neighbor_pairs(coords, anchors, "cpu")
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, jdisp._nearest_neighbor_pairs(coords, anchors))


@pytest.mark.parametrize("n,nanchors,block", [(2, 2, 1 << 25), (64, 8, 1 << 25), (5000, 300, 4096),
                                              (3000, 50, 1)])
def test_nn_sweep_chunks(monkeypatch, n, nanchors, block):
    """Every chunking of the sweep (down to one anchor a chunk) gives the
    brute force's partners."""
    monkeypatch.setattr(disp, "_NN_BLOCK_ELEMENTS", block)
    coords, anchors = _clustered(seed=n, n=n, nanchors=nanchors) if n > 200 else (
        np.random.default_rng(n).uniform(size=(n, 3)), np.arange(nanchors))
    c = torch.from_numpy(np.ascontiguousarray(coords.T))
    got = disp.nn_sweep(c, torch.from_numpy(np.asarray(anchors, dtype=np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), disp._nn_host(coords, anchors))


@pytest.mark.parametrize("file_indices", [None, [2, 0], [1, 2, 3]])
def test_dispersion_over_file_indices_matches_fava_tpu(tmp_path, file_indices):
    nglob = 60
    rng = np.random.default_rng(5)
    x0 = rng.uniform(0.0, 1.0, (nglob, 3))
    u = 0.1 * rng.standard_normal((nglob, 3))
    times = [0.0, 0.2, 0.4, 0.6]
    _write_series(tmp_path, times, lambda t: x0 + u * t, nglob)
    out = _dispersion_both(tmp_path, npairs=20, seed=4, file_indices=file_indices)
    np.testing.assert_allclose(out["time"], np.asarray(times)[file_indices or slice(None)])


# ---------------------------------------------------------------------------
# Auto and cross correlations (tests/test_correlations.py)


@pytest.fixture()
def series_dir(tmp_path):
    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_amr_file(tmp_path / f"rt_hdf5_plt_cnt_{i:04d}", ncells=(4, 4, 4), nblks=(2, 2, 2),
                                time=t)
    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_particle_file(tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=32, time=t,
                                     seed=100 + i)
    return tmp_path


def test_eulerian_autocorrelation_static_field(series_dir):
    m, j = _models(series_dir)
    times, results = m.eulerian_autocorrelation(nsamples=20, fields=["dens"], seed=1)
    np.testing.assert_allclose(times, [0.0, 0.1, 0.2])
    np.testing.assert_allclose(results["dens"], 1.0, rtol=1e-12)
    _assert_same((times, results), j.eulerian_autocorrelation(nsamples=20, fields=["dens"], seed=1),
                 "eulerian")


def test_lagrangian_autocorrelation(series_dir):
    m, j = _models(series_dir)
    times, results = m.lagrangian_autocorrelation(nsamples=8, fields=["velx"])
    np.testing.assert_allclose(results["velx"][0], 1.0, rtol=1e-12)
    assert (np.abs(results["velx"]) <= 1.0 + 1e-12).all()
    _assert_same((times, results), j.lagrangian_autocorrelation(nsamples=8, fields=["velx"]), "lagrangian")


def test_lagrangian_autocorrelation_tracks_permuted_tags(tmp_path):
    """Rows in a fresh order per file: the tag sort pairs each particle
    with itself (v_i(t) = cos(w t + phi_i), the closed form)."""
    nglob, times = 50, [0.0, 0.1, 0.2, 0.3]
    rng = np.random.default_rng(2)
    phases = rng.uniform(0.0, 2 * np.pi, (nglob, 2))
    tags = np.arange(1, nglob + 1, dtype=np.float64)
    for i, t in enumerate(times, start=1):
        perm = rng.permutation(nglob)
        vel = np.cos(2 * np.pi * t + phases)
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": nglob},
            real_scalars={"time": t, "dt": 1e-3, "dtold": 1e-3},
            particles={"tag": tags[perm], "velx": vel[perm, 0], "vely": vel[perm, 1]},
        )
    m, j = _models(tmp_path)
    got = m.lagrangian_autocorrelation(nsamples=nglob, fields=["velx", "vely"])
    _assert_same(got, j.lagrangian_autocorrelation(nsamples=nglob, fields=["velx", "vely"]), "lagrangian")
    v0 = np.cos(phases)
    for k, f in enumerate(("velx", "vely")):
        expected = [np.sum(v0[:, k] * np.cos(2 * np.pi * t + phases[:, k]))
                    / (np.linalg.norm(v0[:, k]) * np.linalg.norm(np.cos(2 * np.pi * t + phases[:, k])))
                    for t in times]
        np.testing.assert_allclose(got[1][f], expected, rtol=0, atol=1e-12)


def test_cross_correlation_formulas(series_dir):
    m, j = _models(series_dir)
    m.load(file_type="prt")
    tags = np.sort(m.particles.data["tag"])
    kw = dict(sample_points=tags[:4], poi_idx=int(tags[5]), lagrangian_tracking=True, tag_field="tag")
    rho = m.cross_correlation("velx", "vely", **kw)
    assert rho.shape == (4,)

    nfiles = 3
    samp = np.zeros((nfiles, 4))
    temp = np.zeros((nfiles, 1))
    for i in range(nfiles):
        m.load(file_index=i, file_type="prt")
        samp[i] = m.particles.select_by_tags(tags[:4])["velx"]
        temp[i] = m.particles.select_by_tags(tags[5:6])["vely"]
    smean = samp[:-1].mean(axis=0)
    tmean = temp[1:].mean()
    sstd = samp[:-1].std(axis=0)
    tstd = temp[1:].std()
    Rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(nfiles - 1)
    expected = (Rts - smean * tmean) / (sstd * tstd)
    np.testing.assert_allclose(rho, expected, rtol=1e-12)
    _assert_same(rho, j.cross_correlation("velx", "vely", **kw), "cross")


def test_cross_correlation_requires_tracking_mode(series_dir):
    m = fava_tpu_torch.FLASH(series_dir, device="cpu")
    assert m.cross_correlation("velx", "vely", np.array([1.0]), 2) is None
    with pytest.raises(ValueError, match="tag field"):
        m.cross_correlation("velx", "vely", np.array([1.0]), 2, lagrangian_tracking=True)


def test_cross_correlation_missing_tag_errors(series_dir):
    m = fava_tpu_torch.FLASH(series_dir, device="cpu")
    m.load(file_type="prt")
    tags = np.sort(m.particles.data["tag"])
    absent = int(tags.max()) + 1000
    with pytest.raises(ValueError, match="not found"):
        m.cross_correlation("velx", "vely", sample_points=tags[:2], poi_idx=absent,
                            lagrangian_tracking=True, tag_field="tag")


def test_cross_correlation_custom_tag_field(tmp_path):
    nglob = 16
    times = [0.0, 0.1, 0.2]
    rng = np.random.default_rng(0)
    base = np.arange(1, nglob + 1, dtype=np.float64)
    for i, t in enumerate(times, start=1):
        ptag = rng.permutation(base)
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": nglob},
            real_scalars={"time": float(t), "dt": 1e-3, "dtold": 1e-3},
            particles={"ptag": ptag, "velx": 2 * ptag + 10 * t, "vely": 3 * ptag - t},
        )
    m, j = _models(tmp_path)
    sample_tags = base[:4]
    kw = dict(sample_points=sample_tags, poi_idx=3.0, lagrangian_tracking=True, tag_field="ptag")
    rho = m.cross_correlation("velx", "vely", **kw)
    nfiles = len(times)
    samp = np.stack([2 * sample_tags + 10 * t for t in times])
    temp = np.array([[3 * 3.0 - t] for t in times])
    smean, tmean = samp[:-1].mean(axis=0), temp[1:].mean()
    sstd, tstd = samp[:-1].std(axis=0), temp[1:].std()
    Rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(nfiles - 1)
    expected = (Rts - smean * tmean) / (sstd * tstd)
    np.testing.assert_allclose(rho, expected, rtol=1e-12)
    _assert_same(rho, j.cross_correlation("velx", "vely", **kw), "cross")


def _translating_files(directory, make, n=16, U=0.3):
    k = 2.0 * np.pi
    times = [0.0, 0.5, 1.0, 1.5]
    xc = (np.arange(n) + 0.5) / n
    X = np.broadcast_to(xc[:, None, None], (n, n, n))
    for i, t in enumerate(times, start=1):
        make(directory / f"rt_hdf5_uniform_{i:04d}", ncells=(n, n, n),
             field_data={"dens": 2.0 + np.cos(k * (X - U * t))}, time=t)
    return times, xc, k, U


def test_eulerian_autocorrelation_translating_mode(tmp_path):
    """dens(x, t) = 2 + cos(2 pi (x - U t)): the decorrelation curve is
    the translation's, evaluated at the same sampled cells."""
    times, xc, k, U = _translating_files(tmp_path, synthetic.make_uniform_file)
    n = xc.size
    m, j = _models(tmp_path)
    got_times, results = m.eulerian_autocorrelation(nsamples=300, fields=["dens"], seed=3, file_type="uni")
    np.testing.assert_allclose(got_times, times)

    from fava_tpu_torch.analysis.auto_correlations import _sample_grid_points

    m2 = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    m2.load(file_index=0, fields=["dens"], file_type="uni")
    points = _sample_grid_points(m2.mesh, 300, np.random.default_rng(3))
    ix = np.clip(np.floor(points[:, 0] * n).astype(int), 0, n - 1)

    def f(t):
        return 2.0 + np.cos(k * (xc[ix] - U * t))

    f0 = f(0.0)
    expected = np.array([np.sum(f0 * f(t)) / (np.linalg.norm(f0) * np.linalg.norm(f(t))) for t in times])
    # The files store float32: the float64 analytic oracle holds to the
    # input rounding.
    np.testing.assert_allclose(results["dens"], expected, rtol=1e-6)
    assert expected[-1] < 0.85
    cont = (4.0 + 0.5 * np.cos(k * U * np.asarray(times))) / 4.5
    assert np.max(np.abs(results["dens"] - cont)) < 0.05
    _assert_same((got_times, results),
                 j.eulerian_autocorrelation(nsamples=300, fields=["dens"], seed=3, file_type="uni"),
                 "eulerian")


def test_eulerian_autocorrelation_on_a_refined_tree_matches_fava_tpu(tmp_path):
    """Mixed levels: points in coarse cells weigh by their volume fraction."""
    for i, t in enumerate([0.0, 0.3, 0.6], start=1):
        synthetic.make_amr_file(
            tmp_path / f"rt_hdf5_plt_cnt_{i:04d}", ncells=(4, 4, 4), nblks=(2, 2, 2), refine={0: 2, 5: 3},
            time=t, field_fns={"dens": lambda x, y, z, t=t: 2.0 + np.sin(2 * np.pi * (x - 0.4 * t)) * y},
        )
    m, j = _models(tmp_path)
    got = m.eulerian_autocorrelation(nsamples=500, fields=["dens", "velx"], seed=8)
    _assert_same(got, j.eulerian_autocorrelation(nsamples=500, fields=["dens", "velx"], seed=8), "eulerian")
    assert got[1]["dens"][-1] < 0.999


def test_cross_correlation_window_honored(tmp_path):
    nglob = 12
    times = [0.0, 0.1, 0.2, 0.3, 0.4]
    rng = np.random.default_rng(7)
    base = np.arange(1, nglob + 1, dtype=np.float64)
    vals = rng.normal(size=(len(times), nglob))
    for i, t in enumerate(times, start=1):
        perm = rng.permutation(nglob)
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": nglob},
            real_scalars={"time": float(t), "dt": 1e-3, "dtold": 1e-3},
            particles={"tag": base[perm], "velx": vals[i - 1][perm], "vely": (vals[i - 1] ** 2)[perm]},
        )
    m, j = _models(tmp_path)
    sample_tags = base[:3]
    kw = dict(lagrangian_tracking=True, tag_field="tag")
    rho = m.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=1, iend=4, **kw)

    samp = vals[1:4][:, :3]
    temp = (vals[1:4][:, 4] ** 2)[:, None]
    smean, tmean = samp[:-1].mean(axis=0), temp[1:].mean()
    sstd, tstd = samp[:-1].std(axis=0), temp[1:].std()
    Rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(3 - 1)
    expected = (Rts - smean * tmean) / (sstd * tstd)
    np.testing.assert_allclose(rho, expected, rtol=1e-12)
    _assert_same(rho, j.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=1, iend=4, **kw), "cross")

    with pytest.raises(ValueError, match="invalid series window"):
        m.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=3, iend=9, **kw)
    with pytest.raises(ValueError, match="at least 2"):
        m.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=2, iend=3, **kw)


def test_eulerian_autocorrelation_bad_file_is_nan_not_zero(tmp_path, caplog):
    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_uniform_file(tmp_path / f"rt_hdf5_uniform_{i:04d}", ncells=(8, 8, 8), seed=9, time=t)
    (tmp_path / "rt_hdf5_uniform_0002").write_bytes(b"garbage, not hdf5")

    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    with caplog.at_level(logging.WARNING, logger="fava_tpu_torch.analysis.auto_correlations"):
        times, results = m.eulerian_autocorrelation(nsamples=16, fields=["dens"], seed=0, file_type="uni")
    assert np.isnan(times[1]) and np.isnan(results["dens"][1])
    assert np.isfinite(times[[0, 2]]).all() and np.isfinite(results["dens"][[0, 2]]).all()
    np.testing.assert_allclose(results["dens"][[0, 2]], 1.0, rtol=1e-12)
    assert any("skipping bad file" in r.message for r in caplog.records)


def test_particle_series_indices_follow_file_type(tmp_path):
    from fava_tpu_torch.analysis._catalogs import particle_series_indices

    for i in (1, 2, 3):
        synthetic.make_particle_file(tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=8)
    synthetic.make_amr_file(tmp_path / "rt_hdf5_chk_0001", ncells=(4, 4, 4), nblks=(1, 1, 1))
    m = fava_tpu_torch.FLASH(tmp_path, device="cpu")
    assert particle_series_indices(m, "prt") == [0, 1, 2]
    assert particle_series_indices(m, "chk_prt") == [0]
    assert particle_series_indices(m, "plt_prt", [2]) == [2]
    with pytest.raises(ValueError, match="particle-series"):
        particle_series_indices(m, "uni")
