"""fava_tpu_torch: the PyTorch/CUDA port of fava_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``fava_tpu``, ported slice by
slice (ROADMAP.md). It runs the flagship analysis — kinetic-energy
spectra plus Reynolds-stress and Favre x-profiles of a uniform volume;
the AMR path: FLASH plt/chk files, block-stack Reynolds and Favre
profiles, and the regrid of a window onto a uniform file
(``mesh.from_amr``); and the spectrum and histogram analyses of pipeline
stage 4 on both meshes (KE and scalar spectra, pdf1d/pdf2d,
density_pdf, binned_statistic, mass and volume sums), the uniform
mesh's fractal, structure-function and flame-surface analyses, the
projections and the flame-window fit, with results written by
``Model.save_to_hdf5``; the four-stage pipeline CLI, ``python -m
fava_tpu_torch`` (``pipeline/``); fava_tpu's fused-spectrum path
(``experiments/``: the spectra straight from the transforms, the fused
z+y transform, the padded-fold binnings); and the tracer particles of
part and checkpoint files (``FlashParticles``, the ``prt``, ``chk_prt``
and ``plt_prt`` load types) with the particle analyses: the series
statistics, the Lagrangian and Eulerian autocorrelations, the
space-time cross correlation, dispersion and the pair structure
functions (plain torch in float64: fava_tpu has no kernel there); and,
over the ranks of a ``torch.distributed`` world (``parallel/``), the
slab-sharded uniform volume with the pencil FFT, the sharded spectra and
the sharded flagship step. The
kernels are hand-written CUDA (``ops/cuda_kernels.py``). Every public entry takes ``device=``
("cuda" by default); asking for CUDA where there is none raises. This
package imports neither jax nor fava_tpu.
"""

from fava_tpu_torch._version import __version__, __version_tuple__
from fava_tpu_torch.models import FLASH, FileSubStem, FileType, InMemoryModel, Model, from_arrays
from fava_tpu_torch.mesh import FlashParticles, FlashUniform
from fava_tpu_torch.mesh import FLASH as FlashAMR
from fava_tpu_torch import analysis  # noqa: F401  (registers analyses onto Model)
from fava_tpu_torch import geometry, io, ops, parallel, utils  # noqa: F401

__all__ = [
    "__version__",
    "__version_tuple__",
    "FLASH",
    "FileSubStem",
    "FileType",
    "FlashAMR",
    "FlashParticles",
    "FlashUniform",
    "InMemoryModel",
    "Model",
    "analysis",
    "from_arrays",
    "geometry",
    "io",
    "ops",
    "parallel",
    "utils",
]
