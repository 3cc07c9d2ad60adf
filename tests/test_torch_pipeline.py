"""fava_tpu_torch's pipeline CLI held to fava_tpu's, on the CPU in float64.

One synthetic plt catalog (tests/test_pipeline.py's fixture) is copied
into two work directories; ``fava_tpu.pipeline.main`` runs in one and
``fava_tpu_torch.pipeline.main(..., device="cpu")`` in the other, with
the same settings (relative folders, so the two checkpoints can be
equal verbatim). Every dataset of every analysis file is then held to
fava_tpu's, read with h5py:

* Reynolds stress, Favre profiles, spectra, PDFs, projections and every
  other float dataset: rtol 1e-10 with atol 1e-12 of the dataset's
  scale (its largest |value|), as tests/test_torch_amr.py and
  tests/test_torch_spectra.py (float64 sums in another order);
* fractal dimension: rtol 1e-12 (the same float64 formulas on the same
  box counts), structure functions rtol 1e-10 (tests/test_torch_structure.py);
* the window scalars exactly, except the x entries of "window left" and
  "window right", which carry the fitted centroid: rtol 1e-9 (the same
  scipy LM fit on stress profiles that agree to ~1e-15);
* integer datasets (counts, window dimensions) exactly.

The extracted uniform files are equal field by field and the two
``fava.checkpoint`` JSONs are equal. The rest mirrors the control-flow
tests of tests/test_pipeline.py on the port and runs ``python -m
fava_tpu_torch --device cpu`` in a subprocess, which must import neither
jax nor fava_tpu (nor h5py), with the velocity, gradient, filtering and
two-point keys enabled.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

import fava_tpu.pipeline as jax_pipeline
from fava_tpu.io import synthetic
from fava_tpu_torch.pipeline import (
    PIPELINE_CHECKPOINT_NAME,
    Pipeline,
    PipelineSettingsError,
    main,
)
from fava_tpu_torch.pipeline import pipeline as tpl

REPO = Path(__file__).resolve().parent.parent
SETTINGS = {
    "data folder": "data",
    "output folder": "out",
    "basename": "rt_hdf5_plt_cnt",
    "dimension": 3,
    "model": "synthetic",
    "reynolds stress": {"skip": False},
    "extract windows": {"skip": False},
    "flame window": {"half width": 0.25, "transverse": [0.0, 1.0]},
    "fractal dimension": {"skip": False, "settings": {"field": "flam", "contours": 0.5}},
    "kinetic energy spectra": {"skip": False},
    "structure functions": {
        "skip": False,
        "settings": {"num_seps": 4, "num_points": 32, "sep_bounds": [0.05, 0.3]},
    },
}
# The optional stage-4 analyses the port runs, as the comparison enables them.
OPTIONAL = {
    "favre profiles": {"skip": False},
    "reynolds stresses uniform": {"skip": False},
    "pdf1d": {"skip": False, "settings": {"field": "dens", "nbins": 16}},
    "pdf2d": {"skip": False, "settings": {"field1": "dens", "field2": "flam", "nbins": 16}},
    "binned statistic": {"skip": False, "settings": {"xfield": "dens", "yfield": "velx"}},
    "density pdf": {"skip": False, "settings": {"nbins": 16, "mach": 1.5}},
    "projection": {"skip": False, "settings": {"field": "dens", "axis": 0}},
    "scalar spectra": {"skip": False, "settings": {"field": "flam"}},
    "flame surface": {"skip": False, "settings": {"field": "flam"}},
    "velocity increment pdfs": {
        "skip": False,
        "settings": {"num_seps": 2, "num_points": 64, "sep_bounds": [0.05, 0.3], "nbins": 9},
    },
    "structure function exponents": {
        "skip": False,
        "settings": {"num_seps": 4, "num_points": 32, "sep_bounds": [0.05, 0.3]},
    },
}
# The stage-4 keys of the velocity diagnostics and gradient statistics,
# with fava_tpu's settings (a non-default option where one exists).
VELOCITY_KEYS = {
    "enstrophy spectra": {"skip": False},
    "helicity spectra": {"skip": False},
    "transfer spectra": {"skip": False, "settings": {"dealias": True}},
    "decomposed spectra": {"skip": False, "settings": {"weighted": True}},
    "anisotropic spectra": {"skip": False, "settings": {"axis": 1}},
    "turbulence summary": {"skip": False},
    "velocity gradient statistics": {"skip": False, "settings": {"boundary": "interior"}},
    "gradient invariant pdfs": {
        "skip": False,
        "settings": {"nbins": 12, "qr_range": 4.0, "boundary": "interior"},
    },
}
# The filtering and two-point stage-4 keys, with fava_tpu's settings (the
# synthetic plt files carry no pres, so no baropycnal work).
A8C_KEYS = {
    "filtered ke flux": {"skip": False, "settings": {"cutoffs": [2.0, 3.0], "kernel": "sharp"}},
    "two point correlation": {"skip": False, "settings": {"field": "dens", "nbins": 4}},
    "velocity correlations": {"skip": False},
}
CENTROID_RTOL = 1e-9


def _catalog(data: Path) -> None:
    data.mkdir(parents=True)
    for i, t in enumerate([0.0, 0.1], start=1):
        synthetic.make_amr_file(
            data / f"rt_hdf5_plt_cnt_{i:04d}",
            ncells=(4, 4, 4),
            nblks=(2, 2, 2),
            refine={0: 2},
            time=t,
        )


def _workdir(root: Path, catalog: Path, settings: dict) -> Path:
    shutil.copytree(catalog, root / "data")
    (root / "out").mkdir()
    (root / "pipeline_settings.json").write_text(json.dumps(settings))
    return root


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """fava_tpu's and the port's pipeline over copies of one catalog."""
    base = tmp_path_factory.mktemp("pipes")
    _catalog(base / "catalog")
    settings = {**SETTINGS, **OPTIONAL}
    cwd = os.getcwd()
    dirs = {}
    try:
        for name, run in (("jax", jax_pipeline.main),
                          ("torch", lambda w: main(w, device="cpu"))):
            work = _workdir(base / name, base / "catalog", settings)
            os.chdir(work)  # the settings' folders are relative to the cwd
            assert run(work) == 0
            dirs[name] = work
    finally:
        os.chdir(cwd)
    return dirs["jax"], dirs["torch"]


@pytest.fixture(scope="module")
def velocity_runs(tmp_path_factory):
    """fava_tpu's pipeline and ``python -m fava_tpu_torch --device cpu``
    over copies of one catalog, with the velocity and A8c keys enabled."""
    base = tmp_path_factory.mktemp("pipes_velocity")
    _catalog(base / "catalog")
    settings = {**SETTINGS, **VELOCITY_KEYS, **A8C_KEYS}
    jax_dir = _workdir(base / "jax", base / "catalog", settings)
    cwd = os.getcwd()
    try:
        os.chdir(jax_dir)
        assert jax_pipeline.main(jax_dir) == 0
    finally:
        os.chdir(cwd)
    torch_dir = _workdir(base / "torch", base / "catalog", settings)
    proc = _run_module(torch_dir, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return jax_dir, torch_dir


@pytest.fixture()
def pipeline_dir(tmp_path, monkeypatch):
    _catalog(tmp_path / "data")
    (tmp_path / "out").mkdir()
    (tmp_path / "pipeline_settings.json").write_text(json.dumps(SETTINGS))
    monkeypatch.chdir(tmp_path)
    return tmp_path, tmp_path / "data", tmp_path / "out"


def _datasets(path: Path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_dataset(name: str, got, ref) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype.kind == ref.dtype.kind, name
    if ref.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    group = name.split("/")[0]
    if group == "scalars" and name.split("/")[-1] in ("window left", "window right"):
        np.testing.assert_array_equal(got[1:], ref[1:], err_msg=name)
        np.testing.assert_allclose(got[0], ref[0], rtol=CENTROID_RTOL, atol=0, err_msg=name)
    elif group == "scalars":
        np.testing.assert_array_equal(got, ref, err_msg=name)
    elif group == "fractal dimension":
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0, equal_nan=True, err_msg=name)
    elif group == "structure functions":
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0, err_msg=name)
    else:
        finite = ref[np.isfinite(ref)]
        scale = float(np.abs(finite).max()) if finite.size else 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * scale, equal_nan=True,
                                   err_msg=name)


def test_analysis_files_match_fava_tpu(both_runs):
    jax_dir, torch_dir = both_runs
    ref_files = sorted(p.name for p in (jax_dir / "out").glob("*hdf5_analysis_*"))
    got_files = sorted(p.name for p in (torch_dir / "out").glob("*hdf5_analysis_*"))
    assert got_files == ref_files and len(ref_files) == 2
    groups = set()
    for fname in ref_files:
        ref = _datasets(jax_dir / "out" / fname)
        got = _datasets(torch_dir / "out" / fname)
        assert sorted(got) == sorted(ref), fname
        for name in ref:
            _assert_dataset(name, got[name], ref[name])
        groups |= {name.split("/")[0] for name in ref}
    assert groups == {"reynolds stresses", "scalars", "fractal dimension", "structure functions",
                      "kinetic energy spectra", *OPTIONAL}


@pytest.mark.parametrize("key", sorted(VELOCITY_KEYS))
def test_velocity_keys_write_fava_tpus_datasets(velocity_runs, key):
    """``python -m fava_tpu_torch --device cpu`` writes the datasets of
    each velocity key that fava_tpu's pipeline writes, in both analysis
    files, within the tolerances above."""
    _key_matches_fava_tpu(velocity_runs, key)


@pytest.mark.parametrize("key", sorted(A8C_KEYS))
def test_a8c_keys_write_fava_tpus_datasets(velocity_runs, key):
    """The same for the filtered flux and the two-point and velocity
    correlations (their integral scales and isotropy ratios are scalar
    datasets, held like every other float)."""
    _key_matches_fava_tpu(velocity_runs, key)


def _key_matches_fava_tpu(velocity_runs, key):
    jax_dir, torch_dir = velocity_runs
    ref_files = sorted(p.name for p in (jax_dir / "out").glob("*hdf5_analysis_*"))
    assert len(ref_files) == 2
    for fname in ref_files:
        ref = {k: v for k, v in _datasets(jax_dir / "out" / fname).items()
               if k.split("/")[0] == key}
        got = {k: v for k, v in _datasets(torch_dir / "out" / fname).items()
               if k.split("/")[0] == key}
        assert ref and sorted(got) == sorted(ref), fname
        for name in ref:
            _assert_dataset(name, got[name], ref[name])


def test_uniform_files_equal_field_by_field(both_runs):
    jax_dir, torch_dir = both_runs
    ref_files = sorted(p.name for p in (jax_dir / "out").glob("*hdf5_uniform_*"))
    assert ref_files == sorted(p.name for p in (torch_dir / "out").glob("*hdf5_uniform_*"))
    assert len(ref_files) == 2
    for fname in ref_files:
        ref = _datasets(jax_dir / "out" / fname)
        got = _datasets(torch_dir / "out" / fname)
        assert sorted(got) == sorted(ref)
        for name in ref:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(ref[name]),
                                          err_msg=f"{fname}:{name}")
            assert np.asarray(got[name]).dtype == np.asarray(ref[name]).dtype, name


def test_checkpoints_equal(both_runs):
    jax_dir, torch_dir = both_runs
    ref = json.loads((jax_dir / PIPELINE_CHECKPOINT_NAME).read_text())
    got = json.loads((torch_dir / PIPELINE_CHECKPOINT_NAME).read_text())
    assert got == ref
    assert got["reynolds stress"] == {"index": 2}
    assert got["extract windows"] == {"index": 2}
    assert got["analyze uniform data"] == {"analysis": None, "index": 2}


def test_full_pipeline_run(pipeline_dir):
    workdir, data, out = pipeline_dir
    assert main(workdir, device="cpu") == 0
    anl = sorted(out.glob("*hdf5_analysis_*"))
    uni = sorted(out.glob("*hdf5_uniform_*"))
    assert len(anl) == 2 and len(uni) == 2
    # The window is the flame window, not the whole domain: x cropped to
    # 2*half_width (half the domain), the transverse axes kept whole.
    from fava_tpu_torch.mesh import FlashUniform

    um = FlashUniform(uni[0], device="cpu")
    um.load()
    assert um.nCellsVec[0] * 2 == um.nCellsVec[1] == um.nCellsVec[2]
    with h5py.File(anl[0], "r") as f:
        assert {"reynolds stresses", "scalars", "kinetic energy spectra"} <= set(f)
        assert "window right" in f["scalars"]
    state = json.loads((workdir / PIPELINE_CHECKPOINT_NAME).read_text())
    assert state["reynolds stress"]["index"] == 2


def test_pipeline_resume_skips_done_work(pipeline_dir, capsys):
    workdir, data, out = pipeline_dir
    assert main(workdir, device="cpu") == 0
    mtimes = {p.name: p.stat().st_mtime_ns for p in out.glob("*hdf5_*")}
    capsys.readouterr()
    assert main(workdir, device="cpu") == 0
    printed = capsys.readouterr().out
    assert "pipeline complete" in printed
    lines = [ln for ln in printed.splitlines() if ln.startswith("[stage")]
    assert all("window exists" in ln for ln in lines), lines
    for p in out.glob("*hdf5_*"):
        assert p.stat().st_mtime_ns == mtimes[p.name]


def test_pipeline_optional_analyses(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings.update(OPTIONAL)
    settings_path.write_text(json.dumps(settings))
    assert main(workdir, device="cpu") == 0
    found = set()
    for p in sorted(out.glob("*hdf5_analysis_*")):
        with h5py.File(p, "r") as f:
            found |= set(f)
            if "flame surface" in f:
                assert f["flame surface"]["sigma"].shape == (8,)
            if "projection" in f:
                assert f["projection"]["map"].shape == (16, 16)
    assert set(OPTIONAL) <= found


def test_shipped_settings_template_runs(pipeline_dir):
    """The shipped pipeline_settings.json is a working template: only
    folders/basename and physical scales need editing for a new dataset."""
    import fava_tpu_torch.pipeline as pipeline_pkg

    workdir, data, out = pipeline_dir
    shipped = Path(pipeline_pkg.__file__).parent / "pipeline_settings.json"
    settings = json.loads(shipped.read_text())
    reference = Path(jax_pipeline.__file__).parent / "pipeline_settings.json"
    assert settings == json.loads(reference.read_text())
    settings["data folder"] = str(data)
    settings["output folder"] = str(out)
    settings["basename"] = "rt_hdf5_plt_cnt"
    settings["model"] = "synthetic"
    settings["flame window"] = {"half width": 0.25, "transverse": [0.25, 0.75]}
    settings["structure functions"]["settings"].update(
        {"num_seps": 4, "num_points": 32, "sep_bounds": [0.05, 0.3]}
    )
    (workdir / "pipeline_settings.json").write_text(json.dumps(settings))
    assert main(workdir, device="cpu") == 0
    found_favre = False
    for p in sorted(out.glob("*hdf5_analysis_*")):
        with h5py.File(p, "r") as f:
            found_favre |= "favre profiles" in f
    assert found_favre  # the shipped template enables the favre extension


def test_pipeline_skip_flags(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["reynolds stress"]["skip"] = True
    settings["extract windows"]["skip"] = True
    settings_path.write_text(json.dumps(settings))
    pipe = Pipeline(workdir, device="cpu")
    pipe.restart()
    assert pipe.settings["reynolds stress"]["skip"] is True
    assert pipe.model.device.type == "cpu"


def test_settings_validation_missing_pdf_field(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["pdf1d"] = {"skip": False, "settings": {"nbins": 16}}
    settings_path.write_text(json.dumps(settings))
    with pytest.raises(PipelineSettingsError, match="'field'"):
        Pipeline(workdir, device="cpu").restart()


def test_settings_validation_pdf2d_and_shapes(pipeline_dir):
    base = dict(SETTINGS)
    bad = dict(base, pdf2d={"skip": False, "settings": {"field1": "dens"}})
    with pytest.raises(PipelineSettingsError, match="'field2'"):
        tpl.validate_settings(bad)
    tpl.validate_settings(dict(base, pdf2d={"skip": True}))
    with pytest.raises(PipelineSettingsError, match="fractal dimension"):
        tpl.validate_settings(dict(base, **{"fractal dimension": "yes"}))
    with pytest.raises(PipelineSettingsError, match="structure functions"):
        tpl.validate_settings(dict(base, **{"structure functions": {"settings": [1, 2]}}))


def test_settings_validation_skipped_stage4_allows_stub_entries():
    settings = dict(SETTINGS)
    settings["analyze uniform data"] = {"skip": True}
    settings["pdf1d"] = {"settings": {"nbins": 16}}  # missing 'field': fine, stage off
    del settings["fractal dimension"]
    tpl.validate_settings(settings)


def test_settings_validation_unknown_key_warns(caplog):
    settings = dict(SETTINGS, **{"spectre functions": {"skip": False}})
    with caplog.at_level(logging.WARNING, logger="fava_tpu_torch.pipeline.pipeline"):
        tpl.validate_settings(settings)
    assert any("spectre functions" in r.message for r in caplog.records)


def test_pipeline_survives_skipped_stage_one(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["reynolds stress"] = {"skip": True}
    settings_path.write_text(json.dumps(settings))
    assert main(workdir, device="cpu") == 0
    assert not list(out.glob("*hdf5_uniform_*"))


def test_pipeline_stage4_skip_flag(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings_path = workdir / "pipeline_settings.json"
    settings = json.loads(settings_path.read_text())
    settings["analyze uniform data"] = {"skip": True}
    settings_path.write_text(json.dumps(settings))
    assert main(workdir, device="cpu") == 0
    ckpt = json.loads((workdir / PIPELINE_CHECKPOINT_NAME).read_text())
    assert "index" not in ckpt.get("analyze uniform data", {})


def test_validated_settings_raise_pipeline_error(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings = dict(SETTINGS, dimension="3")
    (workdir / "pipeline_settings.json").write_text(json.dumps(settings))
    with pytest.raises(PipelineSettingsError, match="dimension"):
        Pipeline(workdir, device="cpu").load_settings()
    del settings["basename"]
    settings["dimension"] = 3
    (workdir / "pipeline_settings.json").write_text(json.dumps(settings))
    with pytest.raises(PipelineSettingsError, match="basename"):
        Pipeline(workdir, device="cpu").load_settings()


def test_stage3_not_checkpointed_without_trajectory(pipeline_dir):
    workdir, data, out = pipeline_dir
    settings = dict(SETTINGS, **{"reynolds stress": {"skip": True}})
    (workdir / "pipeline_settings.json").write_text(json.dumps(settings))
    assert main(workdir, device="cpu") == 0
    ckpt = json.loads((workdir / PIPELINE_CHECKPOINT_NAME).read_text())
    assert "extract windows" not in ckpt
    assert not list(out.glob("*hdf5_uniform_*"))

    settings["reynolds stress"] = {"skip": False}
    (workdir / "pipeline_settings.json").write_text(json.dumps(settings))
    assert main(workdir, device="cpu") == 0
    ckpt = json.loads((workdir / PIPELINE_CHECKPOINT_NAME).read_text())
    assert ckpt["extract windows"]["index"] == 2
    assert len(list(out.glob("*hdf5_uniform_*"))) == 2


def _run_module(workdir: Path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "fava_tpu_torch", *args],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=600,
    )


def test_module_cli_runs_on_the_cpu_without_jax(pipeline_dir):
    """``python -m fava_tpu_torch --device cpu`` runs the four stages;
    ``-X importtime`` lists every module the run imported: none of jax,
    fava_tpu or h5py."""
    workdir, data, out = pipeline_dir
    proc = _run_module(workdir, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "pipeline complete" in proc.stdout
    assert len(list(out.glob("*hdf5_analysis_*"))) == 2
    imported = {ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln}
    assert "fava_tpu_torch.pipeline.pipeline" in imported
    bad = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "fava_tpu", "h5py"))
    assert not bad, bad


def test_module_cli_defaults_to_cuda_and_refuses_other_arguments(pipeline_dir):
    workdir, data, out = pipeline_dir
    import torch

    if not torch.cuda.is_available():
        proc = _run_module(workdir)
        assert proc.returncode == 1
        assert "CUDA is not available" in proc.stderr
        assert not list(out.iterdir())
    for args in (("--device", "tpu"), ("--bogus",), ("extra",)):
        proc = _run_module(workdir, *args)
        assert proc.returncode == 2, args
