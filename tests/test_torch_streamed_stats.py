"""fava_tpu_torch's streamed turbulence summary, velocity correlations,
two-point lines and gradient statistics held to its own in-core analyses
and to fava_tpu's streamed drivers on the CPU, in float64.

Inputs are seeded numpy fields behind a host slab loader, or a synthetic
uniform file read through the mesh's ``_streamed_loader``. fava_tpu's
drivers run on the CPU in x64 (their dense-DFT matmuls and jnp sums; they
reach no Pallas kernel). The port's run cuFFT's CPU twin (torch.fft) per
slab and along x, and the same float64 sums. The cases mirror
tests/test_outofcore.py:104-424: Mach statistics with gamc, the gamc
fallback and no Mach, a strong mean flow, a single slab and the halo
wrap, the bf16 wire, the meshes and their knob and error rules.

Tolerances: rtol 1e-10 with atol 1e-12 of each output's scale (its
largest magnitude), float64 on both sides, transforms split by slab and
kx chunk and sums in other orders; the gradient means, which telescope to
0 on a periodic box, within 1e-12 of the largest gradient rms. The bf16
wire: within 2e-2 of scale (bf16 keeps ~3 decimal digits) and not equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.ops import outofcore as joc
from fava_tpu_torch.io import synthetic
from fava_tpu_torch.ops import gradients as tgrad
from fava_tpu_torch.ops import outofcore as toc
from fava_tpu_torch.ops import twopoint as ttp
from fava_tpu_torch.ops import velocity as tvel

LENGTHS = (1.0, 0.75, 0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, seed, mean=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    out = {"dens": 1.0 + 0.4 * rng.random(shape), "pres": 2.0 + rng.random(shape),
           "gamc": 1.3 + 0.2 * rng.random(shape)}
    for a, m in zip("xyz", mean):
        out[f"vel{a}"] = m + rng.standard_normal(shape)
    return out


def _loader(fields):
    def loader(name, x0, x1):
        if name not in fields:
            raise KeyError(name)
        return fields[name][x0:x1]

    return loader


def _t(fields, *names):
    return [torch.tensor(fields[n]) for n in names]


def _close(got, ref, what, rtol=1e-10, atol_rel=1e-12):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, what
    scale = float(np.nanmax(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * scale, equal_nan=True,
                               err_msg=what)


def _close_dict(got, ref, what):
    assert list(got) == list(ref) or sorted(got) == sorted(ref), what
    ref = dict(ref)
    got = dict(got)
    if "gradient_mean" in ref:
        rms = float(np.sqrt(np.max(ref["gradient_moment2"])))
        np.testing.assert_allclose(got.pop("gradient_mean"), ref.pop("gradient_mean"), rtol=0,
                                   atol=1e-12 * rms, err_msg=f"{what}/gradient_mean")
    for k in ref:
        _close(got[k], ref[k], f"{what}/{k}")


SUMMARY_CASES = {
    "gamc": dict(with_mach=True),
    "gamma fallback": dict(with_mach=True, gamma=1.4),
    "no mach": dict(with_mach=False),
}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
@pytest.mark.parametrize("shape,slab_rows,chunk_rows", [((16, 16, 16), 4, 8), ((15, 12, 10), 5, 3),
                                                        ((8, 12, 9), 8, 8)])
def test_streamed_summary_matches_incore_and_fava_tpu(case, shape, slab_rows, chunk_rows):
    f = _fields(shape, sum(shape))
    if case == "gamma fallback":
        del f["gamc"]
    kw = SUMMARY_CASES[case]
    got = toc.streamed_turbulence_summary(_loader(f), shape, slab_rows=slab_rows,
                                          chunk_rows=chunk_rows, device="cpu", lengths=LENGTHS, **kw)
    mach = {}
    if kw["with_mach"]:
        mach = {"pres": torch.tensor(f["pres"]),
                "gamma": torch.tensor(f["gamc"]) if "gamc" in f else kw["gamma"]}
    incore = tvel.turbulence_summary(*_t(f, "velx", "vely", "velz"), dens=torch.tensor(f["dens"]),
                                     lengths=LENGTHS, **mach)
    assert list(got) == list(incore) and ("mach_rms" in got) == kw["with_mach"]
    _close_dict(got, incore, f"summary {case} vs in-core")
    ref = joc.streamed_turbulence_summary(_loader(f), shape, slab_rows=slab_rows,
                                          chunk_rows=chunk_rows, dtype=jnp.float64,
                                          lengths=LENGTHS, **kw)
    _close_dict(got, ref, f"summary {case} vs fava_tpu")


def test_gamc_is_probed_once_before_the_slab_workers():
    f = _fields((8, 8, 8), 3)
    calls = []

    def loader(name, x0, x1):
        calls.append((name, x0, x1))
        return _loader(f)(name, x0, x1)

    toc.streamed_turbulence_summary(loader, (8, 8, 8), slab_rows=4, chunk_rows=4, device="cpu",
                                    with_mach=True)
    assert calls[0] == ("gamc", 0, 1)
    assert sorted(c for c in calls[1:] if c[0] == "gamc") == [("gamc", 0, 4), ("gamc", 4, 8)]


@pytest.mark.parametrize("shape,slab_rows,chunk_rows,mean", [
    ((16, 16, 16), 4, 8, (0.0, 0.0, 0.0)),
    ((16, 12, 10), 8, 4, (10.0, -5.0, 0.0)),  # a strong mean flow
    ((15, 9, 10), 5, 3, (0.0, 0.0, 1.0)),
])
def test_streamed_velocity_correlations_match_incore_and_fava_tpu(shape, slab_rows, chunk_rows,
                                                                  mean):
    f = _fields(shape, 33, mean)
    reads = []

    def loader(name, x0, x1):
        reads.append(name)
        return f[name][x0:x1]

    got = toc.streamed_velocity_correlations(loader, shape, slab_rows=slab_rows,
                                             chunk_rows=chunk_rows, device="cpu", lengths=LENGTHS)
    assert "dens" not in reads  # unweighted: dens is never read
    incore = ttp.velocity_correlations(*_t(f, "velx", "vely", "velz"), lengths=LENGTHS)
    _close_dict(got, incore, "velocity correlations vs in-core")
    ref = joc.streamed_velocity_correlations(_loader(f), shape, slab_rows=slab_rows,
                                             chunk_rows=chunk_rows, dtype=jnp.float64,
                                             lengths=LENGTHS)
    _close_dict(got, ref, "velocity correlations vs fava_tpu")


@pytest.mark.parametrize("shape,slab_rows,chunk_rows", [((16, 16, 16), 4, 8), ((15, 9, 10), 3, 5)])
@pytest.mark.parametrize("field", ["dens", "velx"])
def test_streamed_two_point_lines_match_incore_and_fava_tpu(shape, slab_rows, chunk_rows, field):
    f = _fields(shape, 35)
    f["dens"] = 2.0 + f["dens"]  # a nonzero mean
    got = toc.streamed_two_point_lines(_loader(f), shape, field, slab_rows=slab_rows,
                                       chunk_rows=chunk_rows, device="cpu", lengths=LENGTHS)
    incore = ttp.two_point_correlation(torch.tensor(f[field]), lengths=LENGTHS)
    assert "R_shell" not in got  # it needs the full correlation volume
    _close_dict(got, {k: v for k, v in incore.items() if k in got}, "lines vs in-core")
    ref = joc.streamed_two_point_lines(_loader(f), shape, field, slab_rows=slab_rows,
                                       chunk_rows=chunk_rows, dtype=jnp.float64, lengths=LENGTHS)
    assert list(got) == list(ref)
    _close_dict(got, ref, "lines vs fava_tpu")


@pytest.mark.parametrize("shape,slab_rows", [((16, 16, 16), 4), ((16, 12, 10), 16), ((15, 9, 10), 3),
                                             ((8, 8, 8), 1)])
def test_streamed_gradient_stats_match_incore_and_fava_tpu(shape, slab_rows):
    """A mean flow and a shear stress the per-slab centring and the Chan
    combination; slab_rows == nx wraps the halo rows onto the slab itself,
    slab_rows 1 makes every slab's halo its neighbours."""
    f = _fields(shape, 34, (5.0, 0.0, -3.0))
    y = (np.arange(shape[1]) + 0.5) / shape[1]
    f["velx"] = f["velx"] + 2.0 * np.sin(2 * np.pi * y)[None, :, None]
    got = toc.streamed_gradient_stats(_loader(f), shape, slab_rows=slab_rows, device="cpu",
                                      lengths=(2.0, 1.0, 1.0))
    incore = tgrad.velocity_gradient_statistics(*_t(f, "velx", "vely", "velz"),
                                                lengths=(2.0, 1.0, 1.0))
    _close_dict(got, incore, "gradients vs in-core")
    ref = joc.streamed_gradient_stats(_loader(f), shape, slab_rows=slab_rows, dtype=jnp.float64,
                                      lengths=(2.0, 1.0, 1.0))
    _close_dict(got, ref, "gradients vs fava_tpu")


def test_chan_combination_is_fava_tpus():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((4, 7)), rng.standard_normal((4, 7))
    for got, ref in zip(toc._chan_combine(3.0, a, 5.0, b), joc._chan_combine(3.0, a, 5.0, b)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("driver", ["summary", "correlations", "lines", "gradients"])
def test_bf16_wire_approximates_the_full_precision_run(driver):
    shape = (16, 16, 16)
    f = _fields(shape, 31)
    runs = {
        "summary": lambda **kw: toc.streamed_turbulence_summary(
            _loader(f), shape, slab_rows=4, chunk_rows=8, device="cpu", with_mach=True, **kw),
        "correlations": lambda **kw: toc.streamed_velocity_correlations(
            _loader(f), shape, slab_rows=4, chunk_rows=8, device="cpu", **kw),
        "lines": lambda **kw: toc.streamed_two_point_lines(
            _loader(f), shape, "dens", slab_rows=4, chunk_rows=8, device="cpu", **kw),
        "gradients": lambda **kw: toc.streamed_gradient_stats(
            _loader(f), shape, slab_rows=4, device="cpu", **kw),
    }
    ref = runs[driver]()
    got = runs[driver](wire_dtype=torch.bfloat16)
    worst = 0.0
    for k, r in ref.items():
        r = np.asarray(r, dtype=np.float64)
        if k.startswith("r_") or not np.isfinite(r).all():
            continue
        scale = float(np.abs(r).max()) or 1.0
        if k == "gradient_mean":  # telescopes to 0: the gradient rms is its scale
            scale = float(np.sqrt(np.max(ref["gradient_moment2"])))
        err = float(np.abs(np.asarray(got[k]) - r).max()) / scale
        assert err < 2e-2, (k, err)
        worst = max(worst, err)
    assert worst > 0.0, "the bf16 wire should not be bit-identical"


def test_divisibility_is_checked():
    f = _fields((8, 8, 8), 1)
    with pytest.raises(ValueError, match="must divide"):
        toc.streamed_velocity_correlations(_loader(f), (8, 8, 8), slab_rows=3, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        toc.streamed_turbulence_summary(_loader(f), (8, 8, 8), chunk_rows=3, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        toc.streamed_gradient_stats(_loader(f), (8, 8, 8), slab_rows=3, device="cpu")


# ---------------------------------------------------------------------------
# The mesh: streamed=True through _streamed_loader against the in-core path


@pytest.fixture()
def uni(tmp_path):
    """A 16^3 file with pres and gamc, and one without gamc: the port's
    mesh and fava_tpu's on each."""
    out = {}
    for name, fields in (("gamc", ("dens", "velx", "vely", "velz", "pres", "gamc")),
                         ("pres", ("dens", "velx", "vely", "velz", "pres"))):
        d = tmp_path / name
        d.mkdir()
        synthetic.make_uniform_file(d / "rt_hdf5_uniform_0001", ncells=(16, 12, 10), fields=fields,
                                    seed=12)
        tm, jm = fava_tpu_torch.FLASH(d, device="cpu"), fava_tpu.FLASH(d)
        tm.load(file_type="uni")
        jm.load(file_type="uni")
        out[name] = (tm, jm)
    return out


MESH_RUNS = {
    "turbulence_summary": {"slab_rows": 4, "chunk_rows": 8},
    "velocity_gradient_statistics": {"slab_rows": 5},  # rounds down to 4
    "velocity_correlations": {"slab_rows": 4, "chunk_rows": 3},  # 3 rounds down to 2
    "two_point_correlation": {"field": "pres", "slab_rows": 8, "chunk_rows": 8},
}


@pytest.mark.parametrize("name", sorted(MESH_RUNS))
@pytest.mark.parametrize("file", ["gamc", "pres"])
def test_mesh_streamed_matches_incore_and_fava_tpu(uni, name, file):
    tm, jm = uni[file]
    kw = MESH_RUNS[name]
    got = getattr(tm, name)(streamed=True, **kw)
    incore = getattr(tm, name)(**{k: v for k, v in kw.items() if k == "field"})
    if name == "two_point_correlation":
        incore = {k: v for k, v in incore.items() if k in got}
    _close_dict(got, incore, f"{name} streamed vs in-core")
    _close_dict(got, getattr(jm, name)(streamed=True, **kw), f"{name} vs fava_tpu's stream")
    if name == "turbulence_summary":
        assert list(got) == list(incore) and "mach_rms" in got


def test_streamed_loader_checks_fields(uni):
    tm, _ = uni["pres"]
    loader = tm.mesh._streamed_loader(check_fields=True)
    assert loader("pres", 0, 2).shape == (2, 12, 10)
    with pytest.raises(KeyError, match="gamc"):
        loader("gamc", 0, 1)
    with pytest.raises(KeyError, match="gamc"):  # the file reader's own check
        tm.mesh._streamed_loader()("gamc", 0, 1)


def test_mesh_stream_knob_and_error_rules(uni, tmp_path):
    tm, _ = uni["gamc"]
    mesh = tm.mesh
    for call in (
        lambda: mesh.two_point_correlation(field="dens", wire_dtype=torch.bfloat16),
        lambda: mesh.velocity_correlations(prefetch_depth=4),
        lambda: mesh.turbulence_summary(slab_rows=4),
        lambda: mesh.turbulence_summary(chunk_rows=4),
        lambda: mesh.velocity_gradient_statistics(slab_rows=4),
        lambda: mesh.velocity_correlations(chunk_rows=4),
    ):
        with pytest.raises(TypeError, match="streamed"):
            call()
    with pytest.raises(TypeError, match="nbins"):
        mesh.two_point_correlation(field="dens", streamed=True, nbins=32)
    with pytest.raises(TypeError):  # the gradient path has no chunks
        mesh.velocity_gradient_statistics(streamed=True, chunk_rows=4)
    with pytest.raises(ValueError, match="periodic-only"):
        mesh.velocity_gradient_statistics(streamed=True, boundary="interior")

    flat = fava_tpu_torch.FlashUniform.from_arrays(
        {k: np.ones((8, 8)) for k in ("dens", "velx", "vely")}, device="cpu")
    for name in ("turbulence_summary", "velocity_gradient_statistics", "velocity_correlations",
                 "two_point_correlation"):
        with pytest.raises(ValueError, match="3D"):
            getattr(flat, name)(streamed=True)
    resident = fava_tpu_torch.FlashUniform.from_arrays(
        {k: np.ones((8, 8, 8)) for k in ("dens", "velx", "vely", "velz")}, device="cpu")
    with pytest.raises(ValueError, match="file-backed"):
        resident.velocity_correlations(streamed=True)
