"""Role: the centered second moments of a uniform volume about its row means.

K2 (``csrc/flagship_kernels.cu`` ``centered_row_moments_kernel``): four
float32 fields and 3 float64 means a row read once, 9 float64 sums a row
written once; 21 operations a cell.
"""

ROLE = "centered moments"
NAMES = (r"(?<![A-Za-z0-9_])centered_row_moments_kernel\b",)
COUNTERS = ("centered_row_moments",)
NCEN = 9


def work(kernel, ctx):
    nx, ny, nz = ctx.shape
    n = nx * ny * nz
    return 16 * n + 8 * (3 + NCEN) * nx, 21 * n
