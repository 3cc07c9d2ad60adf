"""Role: the powers, fold and shell binning of the three velocity
transforms in one pass (the fused-spectrum path).

B9 (``csrc/fused_spectra_kernels.cu`` ``powers_fold_bin_kernel``): the
real and imaginary float32 parts of three (nx, ny, nz/2+1) half-spectra
read once over the cells inside the last shell, 3 float64 sums a shell
written once; 60 operations a cell.
"""

from harness.roofline import unfolded_inside

ROLE = "fused powers and binning"
NAMES = (r"(?<![A-Za-z0-9_])powers_fold_bin_kernel\b",)
COUNTERS = ("shell_bin_powers_fused",)


def work(kernel, ctx):
    nx, ny, nz = ctx.shape
    inside = unfolded_inside(nx, ny, nz, ctx.nbins)
    return 24 * inside + 24 * ctx.nbins, 60 * inside
