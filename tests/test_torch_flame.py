"""fava_tpu_torch's flame window fit, flame surface density and interrupt
handler held to fava_tpu's, on the CPU in float64.

The same seeded numpy inputs go through ``fava_tpu.ops.flame`` and
``fava_tpu_torch.ops.flame``. The window fit is the same scipy LM on
the same host arrays: equal to fava_tpu's exactly. The surface measure:
rtol 1e-12 against fava_tpu and against the float64 ``np.gradient``
oracle (tests/test_flame.py's cases), the same central differences
summed in another order. The interrupt handler mirrors
tests/test_utils.py:51-69.
"""

import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import flame as jax_flame
from fava_tpu_torch.ops import flame as torch_flame
from fava_tpu_torch.utils import FAVAInterruptHandler, InterruptHandler

RTOL = 1e-12
KEYS = ("area", "wrinkling", "x", "sigma", "max_gradient", "thickness")


def _surface_both(c, deltas, axis=0):
    ref = jax_flame.flame_surface(jnp.asarray(c), deltas, axis=axis)
    got = torch_flame.flame_surface(torch.as_tensor(c), deltas, axis=axis)
    for key in KEYS:
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=0, err_msg=key)
    assert isinstance(got["sigma"], np.ndarray) and got["sigma"].dtype == np.float64
    return got


def test_flame_window_recovers_known_centroid():
    radius = np.linspace(0.0, 2.0e6, 257)
    ccx = 0.5 * (radius[1:] + radius[:-1])
    x0_km, amp, sigma = 7.3, 4.0e12, 3.0
    prof = torch_flame.super_gaussian(ccx / torch_flame.XFACT, amp, x0_km, sigma)
    stress = {"Ryy": 0.5 * prof, "Rzz": 0.5 * prof, "Rxx": prof}
    got = torch_flame.flame_window(ccx, stress)
    assert got == jax_flame.flame_window(ccx, stress)
    rmin_km = ccx[0] / torch_flame.XFACT
    np.testing.assert_allclose(got, (x0_km - rmin_km) * torch_flame.XFACT, rtol=1e-6)


def test_flame_window_mask_applies():
    radius = np.linspace(0.0, 2.0e6, 129)
    ccx = 0.5 * (radius[1:] + radius[:-1])
    prof = torch_flame.super_gaussian(ccx / torch_flame.XFACT, 1.0e10, 9.0, 2.5)
    stress = {"Ryy": prof, "Rzz": prof}
    mask = np.arange(16, 120)
    got = torch_flame.flame_window(ccx, stress, mask)
    assert np.isfinite(got)
    assert got == jax_flame.flame_window(ccx, stress, mask)


def test_flame_window_on_a_noisy_bump_matches_fava_tpu():
    rng = np.random.default_rng(5)
    ccx = np.linspace(0.0, 4.0, 2048)
    bump = np.exp(-(((ccx - 1.7) / 0.15) ** 2)) + 0.04
    stress = {"Ryy": bump * (1 + 0.05 * rng.standard_normal(ccx.size)),
              "Rzz": bump * (1 + 0.05 * rng.standard_normal(ccx.size))}
    mask = np.arange(200, 1800)
    assert torch_flame.flame_window(ccx, stress, mask) == jax_flame.flame_window(ccx, stress, mask)


def test_flame_surface_planar_ramp_exact():
    nx, ny, nz = 16, 12, 8
    dx, dy, dz = 0.5, 0.25, 0.125
    x = (np.arange(nx) + 0.5) * dx
    c = np.broadcast_to(x[:, None, None] / (nx * dx), (nx, ny, nz)).copy()
    out = _surface_both(c, (dx, dy, dz))
    np.testing.assert_allclose(out["area"], (ny * dy) * (nz * dz), rtol=RTOL)
    np.testing.assert_allclose(out["wrinkling"], 1.0, rtol=RTOL)
    np.testing.assert_allclose(out["sigma"], 1.0 / (nx * dx), rtol=RTOL)
    np.testing.assert_allclose(out["x"], x, rtol=RTOL)
    np.testing.assert_allclose(out["thickness"], nx * dx, rtol=RTOL)


def test_flame_surface_tilted_front_sec_factor():
    n = 16
    d = 1.0 / n
    ij = (np.arange(n) + 0.5) * d
    a, b = 1.0, 0.5
    c = a * ij[:, None, None] + b * ij[None, :, None] + np.zeros((n, n, n))
    out = _surface_both(c, (d, d, d))
    np.testing.assert_allclose(out["wrinkling"], np.hypot(a, b), rtol=RTOL)


@pytest.mark.parametrize("shape", [(16, 12, 8), (16, 12), (5, 7, 9)])
@pytest.mark.parametrize("axis", [0, 1])
def test_flame_surface_matches_np_gradient_oracle(shape, axis):
    rng = np.random.default_rng(45)
    c = rng.random(shape)
    deltas = tuple(0.1 * (i + 1) for i in range(len(shape)))
    out = _surface_both(c, deltas, axis=axis)
    grads = np.gradient(c, *deltas)
    mag = np.sqrt(sum(g * g for g in grads))
    plane_axes = tuple(a for a in range(len(shape)) if a != axis)
    np.testing.assert_allclose(out["area"], mag.sum() * np.prod(deltas), rtol=RTOL)
    np.testing.assert_allclose(out["sigma"], mag.mean(axis=plane_axes), rtol=RTOL)
    np.testing.assert_allclose(out["max_gradient"], mag.max(), rtol=RTOL)
    np.testing.assert_allclose(out["thickness"], 1.0 / mag.max(), rtol=RTOL)


def test_flame_surface_tanh_front_thickness():
    n, delta = 128, 0.05
    x = (np.arange(n) + 0.5) / n
    c = 0.5 * (1.0 + np.tanh((x - 0.5) / delta))
    vol = np.broadcast_to(c[:, None, None], (n, 8, 8)).copy()
    out = _surface_both(vol, (1.0 / n, 1.0 / 8, 1.0 / 8))
    np.testing.assert_allclose(out["thickness"], 2.0 * delta, rtol=2e-2)
    np.testing.assert_allclose(out["wrinkling"], 1.0, rtol=1e-3)


def test_flame_surface_constant_field_has_infinite_thickness():
    out = _surface_both(np.full((6, 5, 4), 0.3), (1.0, 1.0, 1.0))
    assert out["area"] == 0.0 and out["thickness"] == np.inf


def test_flame_surface_validation():
    for bad, deltas, kw, match in (
        (torch.zeros((4, 4, 4)), (1.0, 1.0), {}, "deltas must have 3 entries, got 2"),
        (torch.zeros((4, 4, 4)), (1.0, 1.0, 1.0), {"axis": 3}, r"axis must be in \[0, 3\), got 3"),
        (torch.zeros((4,)), (1.0,), {}, "requires a 2D or 3D volume, got 1D"),
    ):
        with pytest.raises(ValueError, match=match):
            torch_flame.flame_surface(bad, deltas, **kw)
        with pytest.raises(ValueError, match=match):
            jax_flame.flame_surface(jnp.asarray(bad.numpy()), deltas, **kw)


def test_flame_surface_mesh_wrapper_and_registration(uniform_file):
    jm = fava_tpu.FLASH(uniform_file.parent)
    jm.load(file_type="uni")
    tm = fava_tpu_torch.FLASH(uniform_file.parent, device="cpu")
    tm.load(file_type="uni")
    assert tm.mesh._domain_lengths() == jm.mesh._domain_lengths()
    for axis in (0, 2):
        ref = jm.flame_surface(field="flam", axis=axis)
        got = tm.flame_surface(field="flam", axis=axis)
        for key in KEYS:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=0, err_msg=key)
    got = tm.mesh.flame_surface()
    c = tm.mesh.data("flam").numpy()
    lengths = tm.mesh._domain_lengths()
    deltas = [lengths[a] / c.shape[a] for a in range(3)]
    mag = np.sqrt(sum(g * g for g in np.gradient(c, *deltas)))
    np.testing.assert_allclose(got["area"], mag.sum() * np.prod(deltas), rtol=RTOL)


def test_amr_mesh_flame_window_matches_fava_tpu(amr_file):
    jm = fava_tpu.FLASH(amr_file.parent)
    jm.load(file_type="plt")
    tm = fava_tpu_torch.FLASH(amr_file.parent, device="cpu")
    tm.load(file_type="plt")
    radius, stress, _ = tm.reynolds_stress()
    centers = 0.5 * (radius[1:] + radius[:-1])
    bump = np.exp(-(((centers - 0.6) / 0.2) ** 2))
    stress = dict(stress, Ryy=stress["Ryy"] + bump, Rzz=stress["Rzz"] + bump)
    got = tm.mesh.flame_window(centers, stress)
    assert got == jm.mesh.flame_window(centers, stress)
    assert np.isfinite(got)


def test_interrupt_handler_calls_external_on_signal():
    calls = []
    with InterruptHandler(external_handler=lambda: calls.append(1)) as h:
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.interrupted and h.signal == signal.SIGTERM
    assert calls == [1]
    assert FAVAInterruptHandler is InterruptHandler


def test_interrupt_handler_restores_handlers():
    before = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    with InterruptHandler():
        assert signal.getsignal(signal.SIGTERM) is not before[signal.SIGTERM]
        assert signal.getsignal(signal.SIGINT) is not before[signal.SIGINT]
    for sig, handler in before.items():
        assert signal.getsignal(sig) is handler
