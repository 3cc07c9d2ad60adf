"""fava_tpu_torch's package and model surface held to fava_tpu's, on the CPU.

Mirrors tests/test_model.py (the generic sniffing ``Model.load`` and its
InvalidMeshError), tests/test_from_arrays.py (``InMemoryModel.load``
raises NotImplementedError) and tests/test_misc.py (the version); both
packages read the same synthetic files, so the loaded meshes and their
fields must agree exactly (values are read, not computed). Also: the
kernel headers ship with the package (every ``#include "..."`` of
``csrc/`` matches a package-data glob of pyproject.toml); every
subpackage exports fava_tpu's names, less those ROADMAP lists as not
ported (A12) or as later slices (A11b, A11c), plus the port's own.
"""

import fnmatch
import importlib
import re
import tomllib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.io import synthetic
from fava_tpu_torch.utils import InvalidMeshError

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "fava_tpu_torch" / "csrc"


@pytest.fixture()
def model_dir(tmp_path):
    synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0001", ncells=(4, 4, 4), nblks=(1, 1, 1))
    synthetic.make_amr_file(tmp_path / "rt_hdf5_plt_cnt_0003", ncells=(4, 4, 4), nblks=(1, 1, 1))
    synthetic.make_amr_file(tmp_path / "rt_hdf5_chk_0002", ncells=(4, 4, 4), nblks=(1, 1, 1))
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(8, 8, 8))
    return tmp_path


def test_version():
    assert fava_tpu_torch.__version__ == fava_tpu.__version__
    assert isinstance(fava_tpu_torch.__version_tuple__, tuple)
    assert fava_tpu_torch.__version_tuple__ == fava_tpu.__version_tuple__


def test_package_exports_the_reference_names():
    from fava_tpu_torch.mesh import FLASH as AMR
    from fava_tpu_torch.models.flash import FileSubStem

    assert fava_tpu_torch.FlashAMR is AMR
    assert fava_tpu_torch.FileSubStem is FileSubStem
    assert {m.name: m.value for m in fava_tpu_torch.FileSubStem} == {
        m.name: m.value for m in fava_tpu.FileSubStem}
    for name in ("FileSubStem", "FlashAMR", "__version__", "__version_tuple__"):
        assert name in fava_tpu_torch.__all__


# fava_tpu's exports the port leaves out: none.
NOT_PORTED = {}
# The port's exports beyond fava_tpu's (Placement stands in for jax's
# NamedSharding).
PORT_ONLY = {
    "utils": {"field_dtype", "resolve_device"},
    "parallel": {"Placement", "SpaceRanks", "all_reduce_packed", "gather_slabs", "halo_x",
                 "pencil_irfft", "shards_volume", "space_axis_size"},
}


@pytest.mark.parametrize("sub", ["", "io", "mesh", "utils", "parallel", "ops", "geometry"])
def test_subpackage_exports_match_fava_tpu(sub):
    ref = importlib.import_module(f"fava_tpu.{sub}" if sub else "fava_tpu")
    port = importlib.import_module(f"fava_tpu_torch.{sub}" if sub else "fava_tpu_torch")
    want = set(ref.__all__) - NOT_PORTED.get(sub, set()) | PORT_ONLY.get(sub, set())
    assert set(port.__all__) == want
    assert all(hasattr(port, name) for name in port.__all__)


def test_analysis_exports_fava_tpus_functions():
    assert set(fava_tpu_torch.analysis.__all__) == set(fava_tpu.analysis.__all__)
    for name in fava_tpu_torch.analysis.__all__:
        f = getattr(fava_tpu_torch.analysis, name)
        assert callable(f) and not isinstance(f, types.ModuleType), name
    from fava_tpu_torch.analysis import turbulence_summary

    assert turbulence_summary.__name__ == "turbulence_summary"


def test_nfiles_takes_and_ignores_keywords(model_dir):
    m = fava_tpu_torch.FLASH(model_dir, device="cpu")
    ref = fava_tpu.FLASH(model_dir)
    for ftype in ("plt", "chk", "uni"):
        assert m.nfiles(ftype, x=1) == ref.nfiles(ftype, x=1) == m.nfiles(ftype)
    assert m.nfiles("plt", x=1) == 2


def test_set_compute_dtype_overrides_the_field_dtype():
    from fava_tpu_torch import utils

    assert utils.field_dtype("cuda") == torch.float32
    try:
        utils.set_compute_dtype(torch.float64)
        assert utils.field_dtype("cuda") == utils.compute_dtype("cuda") == torch.float64
        assert utils.complex_dtype("cuda") == torch.complex128
        utils.set_compute_dtype("float32")
        assert utils.field_dtype("cpu") == torch.float32
        assert utils.to_device(np.ones(3), device="cpu").dtype == torch.float32
        with pytest.raises(TypeError, match="floating dtype"):
            utils.set_compute_dtype(torch.int32)
        assert utils.field_dtype("cpu") == torch.float32
    finally:
        utils.set_compute_dtype(None)
    assert utils.field_dtype("cuda") == torch.float32
    assert utils.field_dtype("cpu") == torch.float64
    assert utils.complex_dtype("cpu") == torch.complex128
    assert utils.to_device(np.arange(3), device="cpu").dtype == torch.int64
    assert utils.to_device(np.arange(3), dtype="float32", device="cpu").dtype == torch.float32
    assert utils.asdevice([1, 2], device="cpu").dtype == torch.float64
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        utils.to_device(np.ones(3))


@pytest.mark.parametrize("index", [0, 1, 3])
def test_generic_model_load_sniffing(model_dir, index):
    """The index-th file of the sorted listing (chk first, then the plt
    files, the uniform file last) loads with the mesh that sniffs it, on
    the model's device, as fava_tpu loads it."""
    m = fava_tpu_torch.Model(model_dir, device="cpu")
    ref = fava_tpu.Model(model_dir)
    m.load(index)
    ref.load(index)
    assert m.mesh.mesh_type == ref.mesh.mesh_type
    assert m.mesh.filename == ref.mesh.filename
    assert m.mesh.device.type == "cpu"
    m.mesh.load_data(names=["dens"])
    ref.mesh.load_data(names=["dens"])
    np.testing.assert_array_equal(m.mesh.data("dens").numpy(), np.asarray(ref.mesh.data("dens")))


def test_generic_model_load_past_the_listing_raises(model_dir):
    m = fava_tpu_torch.Model(model_dir, device="cpu")
    with pytest.raises(IndexError, match="out of bounds"):
        m.load(len(m.files))


def test_load_unknown_file_raises(tmp_path):
    (tmp_path / "random.txt").write_text("not flash data")
    m = fava_tpu_torch.Model(tmp_path, device="cpu")
    with pytest.raises(InvalidMeshError):
        m.load(0)


def test_in_memory_model_has_no_load():
    m = fava_tpu_torch.from_arrays({"dens": np.ones((4, 4, 4))}, device="cpu")
    with pytest.raises(NotImplementedError, match="from_arrays"):
        m.load()


def test_model_asks_for_cuda_by_default(model_dir):
    import torch

    if torch.cuda.is_available():
        assert fava_tpu_torch.Model(model_dir).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            fava_tpu_torch.Model(model_dir)


def test_kernel_sources_and_headers_ship_with_the_package():
    """An installed package builds its kernels only if every source and
    every header it includes is package data (the build hashes csrc/*.cu
    and csrc/*.cuh, ops/_build.py)."""
    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["fava_tpu_torch"]
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert any(p.suffix == ".cuh" for p in sources)
    needed = {f"csrc/{p.name}" for p in sources}
    for p in sources:
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', p.read_text(), flags=re.M):
            assert (CSRC / inc).is_file(), (p.name, inc)
            needed.add(f"csrc/{inc}")
    needed.add("pipeline/pipeline_settings.json")
    assert (CSRC.parent / "pipeline" / "pipeline_settings.json").is_file()
    for rel in sorted(needed):
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
