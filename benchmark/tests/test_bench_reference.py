"""The plain reference agrees with the port's CPU path (float64)."""

import numpy as np
import pytest
import torch

from fava_tpu_torch import flagship
from harness import entries, spec

REF = spec.load_module("reference", "flagship")


def _fields(shape, seed, generator="turbulence"):
    config = spec.load_cell("turb1024.flagship").config if generator == "turbulence" else \
        spec.load_cell("rtflame512.series8").config
    traffic = {"fields": ["dens", "velx", "vely", "velz"], "batch": 1}
    inputs = entries.make_inputs(config, traffic, seed, "cpu", shape)
    return {n: t[0].to(torch.float64) for n, t in inputs.items()}


@pytest.mark.parametrize("shape,generator", [
    ((32, 32, 32), "turbulence"),
    ((64, 64, 64), "flame_sheet"),
    ((33, 32, 31), "turbulence"),
    ((32, 31, 34), "flame_sheet"),
    ((16, 40, 24), "turbulence"),
])
def test_reference_matches_port_cpu(shape, generator):
    f = _fields(shape, 7, generator)
    got = flagship.uniform_analysis_step(f["dens"], f["velx"], f["vely"], f["velz"])
    ref = REF.outputs(f)
    assert set(ref) == set(got)
    for key, r in ref.items():
        g = got[key].cpu().numpy()
        assert g.shape == r.shape, key
        if key in REF.EXACT:
            np.testing.assert_array_equal(g, r)
        else:
            scale = REF.scales(ref, f).get(key, np.abs(r).max())
            assert np.all(np.abs(g - r) <= 1e-12 * np.asarray(scale)), key


def test_control_departs_from_reference():
    f = _fields((32, 32, 32), 3)
    ref = REF.outputs(f)
    ctl = REF.outputs(f, dtype=torch.float32, store=torch.bfloat16)
    np.testing.assert_array_equal(ctl["spectra_counts"], ref["spectra_counts"])
    rel = np.abs(ctl["spectra_total"] - ref["spectra_total"]).max() / np.abs(ref["spectra_total"]).max()
    assert rel > 1e-5


def test_transverse_is_total_minus_longitudinal():
    ref = REF.outputs(_fields((16, 16, 16), 1))
    np.testing.assert_allclose(ref["spectra_transverse"],
                               ref["spectra_total"] - ref["spectra_longitudinal"], rtol=0, atol=0)
