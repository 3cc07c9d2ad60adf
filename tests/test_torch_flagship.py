"""The fava_tpu_torch flagship slice held to fava_tpu on the CPU, in float64.

The port's ``uniform_analysis_step``/``series_analysis_step`` and its
entry points (``FLASH(...).load(file_type="uni")`` and ``from_arrays``)
run on the same inputs as fava_tpu's, made from a seed with numpy (or
the same HDF5 file). fava_tpu runs its single-device step as its own
CPU tests do (jnp.fft and its jnp reference binning/moments).

Tolerance, every output: rtol 1e-10 with atol 1e-12 of the output's
scale (its largest magnitude). Both sides are float64; they differ in
FFT implementation and summation order (~n*eps relative for n-term
sums). Counts are compared exactly.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu import flagship as jflag
from fava_tpu_torch import flagship as tflag

SHAPES = [(16, 16, 16), (32, 32, 32), (16, 32, 24)]
NAMES = ("dens", "velx", "vely", "velz")
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, seed, nsnap=None):
    rng = np.random.default_rng(seed)
    full = shape if nsnap is None else (nsnap, *shape)
    dens = 1.0 + 0.5 * rng.random(full)
    return [dens] + [rng.standard_normal(full) for _ in range(3)]


def _assert_outputs_match(got, ref):
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = np.asarray(got[key].numpy() if torch.is_tensor(got[key]) else got[key])
        r = np.asarray(r)
        assert g.shape == r.shape, key
        assert np.isfinite(g).all(), key
        if key == "spectra_counts":
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            scale = float(np.abs(r).max())
            np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12 * scale, err_msg=key)


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_analysis_step_matches_fava_tpu(shape):
    f = _fields(shape, seed=sum(shape))
    ref = jflag.jitted_analysis_step(None)(*map(jnp.asarray, f))
    got = tflag.uniform_analysis_step(*map(torch.from_numpy, f))
    assert all(v.dtype == torch.float64 for v in got.values())
    _assert_outputs_match(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_series_analysis_step_matches_fava_tpu(shape):
    f = _fields(shape, seed=2 * sum(shape), nsnap=2)
    ref = jax.jit(jflag.series_analysis_step)(*map(jnp.asarray, f))
    got = tflag.series_analysis_step(*map(torch.from_numpy, f))
    assert got["spectra_total"].shape[0] == 2
    _assert_outputs_match(got, ref)


@pytest.mark.parametrize("n,seed", [(16, 0), (12, 3)])
def test_make_example_fields_match_fava_tpu(n, seed):
    ref = jflag.make_example_fields(n, dtype=jnp.float64, seed=seed)
    got = tflag.make_example_fields(n, seed=seed, device="cpu")
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64 and tuple(g.shape) == (n, n, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-13)


def test_make_example_field_batch_stacks_the_single_snapshots():
    batch = tflag.make_example_field_batch(3, 8, device="cpu")
    ref = jflag.make_example_field_batch(3, 8, dtype=jnp.float64)
    for i in range(3):
        single = tflag.make_example_fields(8, seed=i, device="cpu")
        for b, s in zip(batch, single):
            assert torch.equal(b[i], s)
    for b, r in zip(batch, ref):
        np.testing.assert_allclose(b.numpy(), np.asarray(r), rtol=0, atol=1e-13)


def test_flash_uniform_file_flagship_matches_fava_tpu(uniform_file):
    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    for attr in ("nxb", "nyb", "nzb", "ndim", "nblocks", "time", "fields"):
        assert getattr(tm.mesh, attr) == getattr(jm.mesh, attr), attr
    np.testing.assert_array_equal(tm.mesh.domain_bounds, jm.mesh.domain_bounds)
    np.testing.assert_array_equal(tm.mesh.data("dens").numpy(), np.asarray(jm.mesh.data("dens")))
    _assert_outputs_match(tm.flagship_analysis(), jm.flagship_analysis())


def test_from_arrays_flagship_matches_fava_tpu():
    arrays = dict(zip(NAMES, _fields((16, 32, 24), seed=9)))
    ref = fava_tpu.from_arrays(arrays).flagship_analysis()
    got = fava_tpu_torch.from_arrays(arrays, device="cpu").flagship_analysis()
    assert all(isinstance(v, np.ndarray) for v in got.values())
    _assert_outputs_match(got, ref)


def test_cuda_request_raises_without_cuda(monkeypatch, uniform_file):
    """No silent CPU: asking for CUDA where there is none raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = dict(zip(NAMES, _fields((8, 8, 8), seed=1)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fava_tpu_torch.from_arrays(arrays, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fava_tpu_torch.from_arrays(arrays)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fava_tpu_torch.FLASH(uniform_file.parent)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflag.make_example_fields(8)


def test_import_leaves_jax_out():
    code = (
        "import sys, fava_tpu_torch, fava_tpu_torch.parallel; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'fava_tpu', 'h5py')]; "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_registries_are_the_ports_own():
    assert fava_tpu_torch.Model is not fava_tpu.Model
    assert {"FLASH", "FlashUniform", "FlashParticles"} <= set(fava_tpu_torch.Model.mesh_names())
    assert fava_tpu_torch.Model.get_mesh_class("FlashUniform") is fava_tpu_torch.FlashUniform
    assert fava_tpu_torch.Model.get_mesh_class("FlashParticles") is fava_tpu_torch.FlashParticles
    assert fava_tpu_torch.FlashParticles is not fava_tpu.FlashParticles
    for name in ("flagship_analysis", "reynolds_stress", "favre_profiles", "slice_average",
                 "slice_integration", "kinetic_energy_spectra", "scalar_spectra", "pdf1d", "pdf2d",
                 "density_pdf", "binned_statistic", "mass_sum", "volume_average",
                 "volume_integration", "flagship_series", "reynolds_series", "favre_series",
                 "flame_surface", "projection", "eulerian_autocorrelation",
                 "lagrangian_autocorrelation", "cross_correlation", "dispersion_statistics",
                 "particle_structure_functions", "particle_series"):
        assert callable(getattr(fava_tpu_torch.Model, name)), name
        assert getattr(fava_tpu_torch.Model, name) is not getattr(fava_tpu.Model, name), name
