"""Role: the joint histogram of two fields, optionally weighted.

B8 (``csrc/pdf2d_kernels.cu`` ``pdf2d_kernel<weighted, ...>``): two
float32 samples (and a weight) read once each, the (100, 100) float64 or
int64 histogram (the analyses' default bins) written once; 8 operations
a sample. The samples are the cell's volume.
"""

from harness.roofline import template_args

ROLE = "pdf2d"
NAMES = (r"(?<![A-Za-z0-9_])pdf2d_kernel\b",)
COUNTERS = ("pdf2d_counts", "pdf2d_weighted")
BINS = 100 * 100


def work(kernel, ctx):
    args = template_args(kernel, "pdf2d_kernel")
    weighted = bool(args) and args[0] == "true"
    nx, ny, nz = ctx.shape
    n = nx * ny * nz
    return 4 * (3 if weighted else 2) * n + 8 * BINS, 8 * n
